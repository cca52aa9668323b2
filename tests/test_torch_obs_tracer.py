"""pathway_tpu_torch.obs.tracer and serve.metrics against the JAX package.

- the same spans give the same Chrome-trace structure (names, categories,
  parent links, attributes) and the same OTLP payload;
- ``sanitize_trace_id`` and ``context_from_trace_header`` agree with the
  reference on ``hypothesis``-drawn headers;
- span-tree parenting within and across threads, the ring bound, the
  disabled switch, the flusher's lifecycle;
- the recorder's overhead guard: events of a chained run x the measured
  per-event cost stays within 2% of the run's wall;
- ``KVCacheStats`` / ``StateCacheStats`` / ``ServeStats`` /
  ``FleetStats`` snapshots, and their ``render_prometheus_lines`` and
  ``otlp_points``, equal the reference's for the same counter updates.
"""

import json
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu import obs as jobs
from pathway_tpu.obs import tracer as jtracer
from pathway_tpu.serve import metrics as jmetrics
from pathway_tpu_torch import obs
from pathway_tpu_torch.obs import tracer
from pathway_tpu_torch.serve import metrics


@pytest.fixture(autouse=True)
def _clean_recorders():
    for o in (obs, jobs):
        rec = o.recorder()
        rec.clear()
        rec.enabled = True
    yield
    obs.shutdown()
    obs.recorder().clear()


def _structure(o):
    """Build one span tree through package ``o`` and return its Chrome
    trace with ids and times replaced by the names they point to."""
    with o.span("root", kind="t") as root:
        with o.span("child", n=1):
            o.event("instant", x="y")
        o.record_span("retro", 1.0, 2.0, outcome="done")
    o.event("other_trace")
    trace = o.recorder().chrome_trace(root.trace_id)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    name_of = {e["args"]["span"]: e["name"] for e in xs}
    out = []
    for e in xs:
        args = {k: v for k, v in e["args"].items()
                if k not in ("trace", "span", "parent")}
        out.append((e["name"], e["cat"], e["ph"],
                    name_of.get(e["args"].get("parent")), args,
                    e["dur"] >= 0))
    meta = trace["traceEvents"][0]
    return sorted(out, key=repr), meta["name"], sorted(meta["args"])


def test_same_spans_same_chrome_trace_structure():
    assert _structure(obs) == _structure(jobs)


def _spans(mod):
    s1 = mod.Span.__new__(mod.Span)
    s2 = mod.Span.__new__(mod.Span)
    for s, sid, parent, name in ((s1, 7, 0, "root"), (s2, 9, 7, "kid")):
        s.name = name
        s.trace_id = "00ab12cd34ef5678"
        s.span_id = sid
        s.parent_id = parent
        s.t0 = mod._EPOCH_PERF + 1.0
        s.t1 = mod._EPOCH_PERF + 1.5
        s.tid = 1
        s.attrs = {"k": 3}
    return [s1, s2]


def test_otlp_payload_equals_the_reference(monkeypatch):
    import pathway_tpu.engine.telemetry as jtel

    got = {}
    monkeypatch.setattr(tracer, "_post_json",
                        lambda url, payload: got.setdefault("t", (url,
                                                                  payload)))
    monkeypatch.setattr(jtel, "_post_json",
                        lambda url, payload: got.setdefault("j", (url,
                                                                  payload)))
    monkeypatch.setattr(tracer, "_EPOCH_WALL", jtracer._EPOCH_WALL)
    tracer.export_otlp("http://collector:4318/", _spans(tracer))
    jtracer.export_otlp("http://collector:4318/", _spans(jtracer))
    (ut, pt), (uj, pj) = got["t"], got["j"]
    assert ut == uj == "http://collector:4318/v1/traces"
    scope_t = pt["resourceSpans"][0]["scopeSpans"][0].pop("scope")
    scope_j = pj["resourceSpans"][0]["scopeSpans"][0].pop("scope")
    assert scope_t == {"name": "pathway_tpu_torch.obs"}
    assert scope_j == {"name": "pathway_tpu.obs"}
    assert pt == pj


@settings(max_examples=300, deadline=None, database=None)
@given(st.one_of(st.text(max_size=80),
                 st.text(alphabet="abcXYZ019_-", max_size=70),
                 st.none(), st.integers(), st.binary(max_size=8)))
def test_trace_header_parsing_equals_the_reference(raw):
    assert tracer.sanitize_trace_id(raw) == jtracer.sanitize_trace_id(raw)
    assert (tracer.context_from_trace_header(raw)
            == jtracer.context_from_trace_header(raw))


def test_span_tree_parenting_within_and_across_threads():
    with obs.span("root") as root:
        with obs.span("child") as child:
            pass
        ctx = root.ctx
    assert child.parent_id == root.span_id
    results = {}

    def worker(n):
        with obs.use_context(ctx):
            with obs.span(f"w{n}") as s:
                time.sleep(0.005)
            results[n] = s

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in results.values():
        assert s.trace_id == root.trace_id and s.parent_id == root.span_id
        assert s.tid != root.tid
    assert obs.current_context() is None


def test_ring_bound_disabled_switch_and_dump(tmp_path, monkeypatch):
    rec = obs.recorder()
    ctx = (obs.new_trace_id(), 0)
    for _ in range(rec.capacity + 100):
        obs.record_span("e", 0.0, 0.0, ctx=ctx)
    assert len(rec) == rec.capacity
    rec.clear()
    with obs.disabled():
        obs.event("invisible")
    obs.event("visible")
    assert [s.name for s in rec.snapshot()] == ["visible"]
    monkeypatch.setenv("PATHWAY_TRACE_DUMP_DIR", str(tmp_path))
    path = rec.dump(reason="test")
    assert path.startswith(str(tmp_path))
    dump = json.loads(open(path).read())
    assert dump["traceEvents"][0]["name"] == "clock_sync"
    assert json.loads(obs.chrome_trace_dump({"trace": "no such"}))


def test_flusher_starts_flushes_and_shuts_down(monkeypatch):
    sent = []
    monkeypatch.setattr(tracer, "_post_json",
                        lambda url, payload: sent.append(payload))
    fl = obs.start_flusher(interval_s=0.02, endpoint="http://c:1")
    assert fl.is_alive() and obs.start_flusher() is fl
    obs.event("flushed")
    deadline = time.time() + 5.0
    while not sent and time.time() < deadline:
        time.sleep(0.01)
    obs.shutdown()
    assert not fl.is_alive()
    assert sent and sent[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]


def test_recorder_overhead_within_two_percent_of_a_chained_run():
    """The reference's recorder guard in its per-event form: the spans a
    chained engine run records x the measured per-record cost (best of
    3) <= 2% of the run's wall."""
    import jax
    import numpy as np

    from pathway_tpu.models import decoder as jdec
    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
    from pathway_tpu_torch.models import decoder as tdec
    from pathway_tpu_torch.models.convert import decoder_params_from_numpy

    widths = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8,
                  d_ff=128, max_len=128)
    pj = jdec.init_decoder_params(jdec.DecoderConfig(**widths),
                                  jax.random.PRNGKey(0))
    cfg = tdec.DecoderConfig(**widths)
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   cfg, device="cpu")
    eng = PagedDecodeEngine(cfg, pt, device="cpu", num_blocks=96,
                            block_size=4, max_batch_size=4,
                            seq_buckets=(16, 32, 64), prefill_chunk=8,
                            chain_steps=8, name="t_obs_rec_overhead")
    reqs = [([1 + i, 2, 3, 4], 12) for i in range(4)]
    eng.generate_batch(list(reqs))
    rec = obs.recorder()
    n0 = rec.n_recorded
    t0 = time.perf_counter()
    eng.generate_batch(list(reqs))
    wall = time.perf_counter() - t0
    n_events = rec.n_recorded - n0
    assert n_events > 0
    ctx = (obs.new_trace_id(), 0)
    per_event = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10_000):
            obs.record_span("overhead_probe", 0.0, 1.0, ctx=ctx)
        per_event = min(per_event, (time.perf_counter() - t0) / 10_000)
    frac = per_event * n_events / wall
    assert frac <= 0.02, (f"recorder overhead {frac:.4f} > 2% ({n_events} "
                          f"events x {per_event * 1e6:.2f}us / {wall:.3f}s)")


# -- serve.metrics ------------------------------------------------------------


def _drive_kv(stats):
    stats.record_prefix_hit(3)
    stats.record_prefix_miss(2)
    stats.record_preemption()
    stats.record_cow(2)
    stats.record_prefix_eviction()
    stats.record_prefill_chunks(4)
    stats.record_mixed_step(5)
    stats.record_mixed_step(3)
    for s in (0.0004, 0.003, 0.07, 2.0, 30.0):
        stats.record_ttft(s)
    stats.record_chain(steps=8, slots=32, emitted=29)
    stats.record_chain(steps=1, slots=4, emitted=4)
    stats.record_chain(steps=40, slots=40, emitted=1)
    stats.record_spec(proposed=12, accepted=7, emitted=11)
    stats.record_host_gap(0.0125)
    stats.record_engine_restart(0.25)
    stats.record_engine_recovery(0.5)
    stats.record_engine_degrade()


def _lines(mod, label):
    """The lines of ``label``'s block, with the ``# TYPE`` lines of their
    metric families (other tests' blocks in the process-wide registries
    add families of their own)."""
    lines = mod.render_prometheus_lines()
    data = [ln for ln in lines if label in ln]
    names = {ln.split("{")[0] for ln in data}
    return [ln for ln in lines if ln.startswith("# TYPE ")
            and any(n.startswith(ln.split()[2]) for n in names)] + data


def _points(mod, value):
    return [p for p in mod.otlp_points("123")
            if any(a["value"]["stringValue"] == value
                   for a in p["attributes"])]


@pytest.fixture
def registries():
    """Blocks this test adds to both packages' process-wide registries
    are removed after it (other tests render every block)."""
    regs = [(mod, getattr(mod, attr)) for mod in (metrics, jmetrics)
            for attr in ("_registry", "_kv_registry", "_state_registry",
                         "_fleet_registry")]
    before = [set(reg) for _mod, reg in regs]
    yield
    for (_mod, reg), keys in zip(regs, before):
        for k in set(reg) - keys:
            del reg[k]


def test_kv_and_state_stats_render_as_the_reference(registries):
    name = "t_obs_metrics_kv"
    kt = metrics.kv_stats(name, blocks_in_use_fn=lambda: 5, blocks_total=95,
                          shards=1, shard_hbm_bytes=393216)
    kj = jmetrics.kv_stats(name, blocks_in_use_fn=lambda: 5,
                           blocks_total=95, shards=1,
                           shard_hbm_bytes=393216)
    _drive_kv(kt)
    _drive_kv(kj)
    assert kt.snapshot() == kj.snapshot()
    st_t = metrics.state_stats(name + "_s", slots_in_use_fn=lambda: 2,
                               slots_total=23, state_bytes_per_seq=4096)
    st_j = jmetrics.state_stats(name + "_s", slots_in_use_fn=lambda: 2,
                                slots_total=23, state_bytes_per_seq=4096)
    for s in (st_t, st_j):
        s.record_suspend(3)
        s.record_resume(2)
    assert st_t.snapshot() == st_j.snapshot()
    for lbl in (f'pool="{name}"', f'cache="{name}_s"'):
        t_lines = [ln for ln in _lines(metrics, lbl)
                   if not ln.startswith("# TYPE pathway_xla")]
        j_lines = [ln for ln in _lines(jmetrics, lbl)
                   if not ln.startswith("# TYPE pathway_xla")]
        assert t_lines == j_lines
        assert any(not ln.startswith("#") for ln in t_lines)
    for v in (name, name + "_s"):
        assert _points(metrics, v) == _points(jmetrics, v)


def test_serve_and_fleet_stats_render_as_the_reference(registries):
    name = "t_obs_metrics_serve"
    for mod in (metrics, jmetrics):
        s = mod.serve_stats(name, depth_fn=lambda: 3)
        s.record_admitted(5)
        s.record_completed(4)
        s.record_shed("deadline")
        s.record_shed("queue_full", 2)
        s.record_degraded()
        s.record_batch(4, 0.002)
        f = mod.fleet_stats(name + "_f", replicas=2, live_fn=lambda: 1,
                            snapshot_fn=lambda: {"per_replica": [
                                {"replica": 0, "dead": True, "inflight": 0,
                                 "queue_depth": 0, "handoffs_out": 2,
                                 "recovered_in": 0}]})
        f.record_replica_death()
        f.record_recovery(0.25)
        f.record_route(True)
        f.record_route(False)
    assert (metrics.serve_stats(name).snapshot()
            == jmetrics.serve_stats(name).snapshot())
    assert (metrics.fleet_stats(name + "_f").snapshot()
            == jmetrics.fleet_stats(name + "_f").snapshot())
    for lbl in (f'scheduler="{name}"', f'fleet="{name}_f"'):
        assert [ln for ln in _lines(metrics, lbl) if "pathway_xla" not in ln
                ] == [ln for ln in _lines(jmetrics, lbl)
                      if "pathway_xla" not in ln]
    for v in (name, name + "_f"):
        assert _points(metrics, v) == _points(jmetrics, v)
