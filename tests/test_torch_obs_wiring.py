"""The observatory wired through the port's engines and serving front,
against the JAX package where it has a counterpart.

- ``speculative="auto"`` follows a seeded cost store (the recorded pick's
  drafter and K, as the reference's ``_auto_drafter``), no longer an
  alias of ``"ngram"``; a speculative batch flushes its ``pw.spec_tier``
  row; a draft model that does not fit the engine's HBM budget falls back
  to the n-gram drafter;
- ``TorchDecoderLM.generate(fused="auto")`` follows a seeded tier prior
  on the CPU (paged engine, int8 host tier, or the fused tier);
- ``SessionStore.residency_ledger`` equals the reference's;
- the engines record the reference's span tree, scheduler spans join the
  engine's, a failure dumps the flight recorder, a restart is an event
  and a counter, and the pools' ``KVCacheStats`` / ``StateCacheStats``
  count the run;
- a fired fault is a ``fault.injected`` event, and ``kill`` dumps the
  flight recorder before the process ends.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from pathway_tpu.kvcache import speculative as jspec
from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu.kvcache.tiering import SessionStore as JaxStore
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu.obs import costdb as jcostdb
from pathway_tpu.obs import memory as jmem
from pathway_tpu_torch import faults, obs
from pathway_tpu_torch.kvcache import speculative as tspec
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
from pathway_tpu_torch.kvcache.statecache import StateDecodeEngine
from pathway_tpu_torch.kvcache.tiering import SessionStore
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.obs import costdb
from pathway_tpu_torch.obs import memory as tmem
from pathway_tpu_torch.serve.admission import EngineFailedError
from pathway_tpu_torch.serve.scheduler import RequestScheduler

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
SIZES = dict(num_blocks=96, block_size=4, max_batch_size=4, chain_steps=8,
             prefill_chunk=8, seq_buckets=(16, 32, 64))



@pytest.fixture(autouse=True)
def _jax_registry_as_found():
    """The JAX package's own profiler tests read its process-wide program
    registry: the records this test's JAX engines add are removed after
    it."""
    reg = jprof.registry()
    keys = set(reg._records)
    yield
    with reg._lock:
        for k in set(reg._records) - keys:
            del reg._records[k]


@pytest.fixture(scope="module")
def weights():
    pj = jdec.init_decoder_params(CFG_J, jax.random.PRNGKey(0))
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   CFG_T, device="cpu")
    return pj, pt


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh process cost store at a temporary path (both packages read
    PW_COSTDB_PATH); the default stores are rebuilt around the test."""
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    jcostdb.shutdown()
    yield costdb.default_db()
    costdb.shutdown()
    jcostdb.shutdown()


@pytest.fixture(autouse=True)
def _clean_recorder():
    rec = obs.recorder()
    rec.clear()
    rec.failure_dumps = 0
    yield
    faults.clear()
    rec.clear()


def _engine(pt, name, **kw):
    return PagedDecodeEngine(CFG_T, pt, device="cpu", name=name,
                             **dict(SIZES, **kw))


# -- speculation --------------------------------------------------------------


@pytest.mark.parametrize("pick", [None, ("ngram", 3), ("ngram", 6),
                                  ("draft_model", 2)])
def test_speculative_auto_follows_the_seeded_store(weights, store, pick):
    _pj, pt = weights
    if pick is not None:
        extra = {"drafter": pick[0], "k": pick[1]}
        store.observe("pw.spec_tier", "pick", ms=1.0, extra=extra)
        jdb = jcostdb.default_db()
        jdb.observe("pw.spec_tier", "pick", ms=1.0, extra=extra)
    want = jspec._auto_drafter()
    eng = _engine(pt, "t_obs_auto_spec", speculative="auto")
    got = eng._spec.drafter
    assert (got.name, got.k) == (want.name, want.k)
    if pick == ("ngram", 3):
        assert eng._spec.k == 3  # not the "ngram" alias's default 4


def test_speculative_batch_flushes_its_spec_tier_row(weights, store):
    pj, pt = weights
    reqs = [([5, 6, 7, 5, 6, 7, 5, 6], 12), ([9, 9, 9, 9], 12)]
    eng = _engine(pt, "t_obs_flush", speculative="ngram")
    want = JaxEngine(CFG_J, pj, attn="reference", name="t_obs_flush_j",
                     speculative="ngram",
                     **SIZES).generate_batch(list(reqs))
    assert eng.generate_batch(list(reqs)) == want
    row = store.get("pw.spec_tier", "ngram|k4")
    assert row is not None and row["n"] == 1
    assert row["extra"]["drafter"] == "ngram" and row["extra"]["k"] == 4
    assert 0.0 <= row["extra"]["accept_rate"] <= 1.0
    # the lifetime counters survive the flush
    assert eng._spec.dispatches == eng.rounds["verify"] > 0
    eng.generate_batch(list(reqs))
    assert store.get("pw.spec_tier", "ngram|k4")["n"] == 2


def test_draft_model_over_budget_falls_back_to_ngram(weights):
    _pj, pt = weights
    draft = tspec.DraftModelDrafter(CFG_T, pt, k=3)
    base = _engine(pt, "t_obs_gate_probe")
    # the engine fits, the draft model's bytes beside it do not
    budget = base.hbm_plan.total_bytes + 1024
    eng = _engine(pt, "t_obs_gate", speculative=draft,
                  hbm_budget_bytes=budget)
    assert eng._spec.drafter.name == "ngram" and eng._spec.k == 3
    with pytest.raises(tspec.SpecResourceError):
        tspec.DraftModelDrafter(CFG_T, pt, k=3).bind(eng)
    roomy = _engine(pt, "t_obs_gate_ok", speculative=draft,
                    hbm_budget_bytes=64 << 20)
    assert roomy._spec.drafter is draft


# -- the tier prior -----------------------------------------------------------


@pytest.mark.parametrize("tier", [None, "f32_device", "int8_device",
                                  "int8_host", "unknown"])
def test_generate_auto_follows_the_tier_prior(weights, store, tier):
    _pj, pt = weights
    if tier is not None:
        store.observe("pw.decode_tier", "single_stream_pick", ms=1.0,
                      extra={"tier": tier})
    assert tdec.measured_tier_prior() == tier
    lm = tdec.TorchDecoderLM(CFG_T, params=pt, device="cpu",
                             seq_buckets=(64, 128))
    prompt = "the quick brown fox jumps"
    got = lm.generate(prompt, 6, fused="auto")
    if tier in ("f32_device", "int8_device"):
        eng = lm.paged_engine()
        assert eng.quantize == ("int8" if tier == "int8_device" else None)
        ids = lm.encode_prompts([prompt], 6)[0]
        assert got == lm._decode_out(eng.generate(ids, 6))
        assert lm._int8 is None
    elif tier == "int8_host":
        assert lm._int8 is not None and lm._engine is None
        assert got == lm.generate(prompt, 6, fused="int8")
    else:
        assert lm._engine is None and lm._int8 is None
        assert got == lm.generate(prompt, 6, fused=True)


# -- session residency ------------------------------------------------------


@pytest.mark.parametrize("host_budget", [None, 1 << 20, 10 << 20])
def test_residency_ledger_equals_the_reference(weights, host_budget):
    pj, pt = weights
    kw = dict(num_blocks=96, block_size=4, max_batch_size=4, chain_steps=8,
              budget_bytes=8 << 20)
    pj_plan = jdec.plan_decode_params(CFG_J, pj)
    pt_plan = tdec.plan_decode_params(CFG_T, pt)
    jp = jmem.hbm_plan(CFG_J, params=pj_plan, **kw)
    tp = tmem.hbm_plan(CFG_T, params=pt_plan, device="cpu", **kw)
    for tokens in (10, 33, 128):
        got = SessionStore(host_budget_bytes=host_budget,
                           name="t_obs_res").residency_ledger(
            tp, session_tokens=tokens)
        want = JaxStore(host_budget_bytes=host_budget,
                        name="t_obs_res_j").residency_ledger(
            jp, session_tokens=tokens)
        assert got == want


# -- spans, dumps and counters ----------------------------------------------


def test_chained_request_span_tree(weights):
    _pj, pt = weights
    eng = _engine(pt, "t_obs_tree")
    out = eng.generate_batch([([1, 2, 3, 4, 5], 12), ([7, 8, 9], 12)])
    assert all(len(o) == 12 for o in out)
    spans = obs.recorder().snapshot()
    reqs = [s for s in spans if s.name == "engine.request"]
    assert len(reqs) == 2 and len({r.trace_id for r in reqs}) == 2
    for root in reqs:
        assert root.attrs["outcome"] == "done" and root.attrs["emitted"] == 12
        kids = {s.name for s in spans
                if s.trace_id == root.trace_id
                and s.parent_id == root.span_id}
        assert {"engine.admission", "engine.prefill_chunk",
                "engine.chain"} <= kids
    run = next(s for s in spans if s.name == "engine.run")
    run_names = {s.name for s in spans if s.trace_id == run.trace_id}
    assert {"engine.device.chain", "engine.sync",
            "engine.host_gap"} <= run_names
    dump = json.loads(obs.recorder().chrome_trace_json(reqs[0].trace_id))
    names = {e["name"] for e in dump["traceEvents"] if e["ph"] == "X"}
    assert {"engine.request", "engine.admission", "engine.chain"} <= names
    # the pool counted the run
    snap = eng.pool.kv_stats.snapshot()
    assert snap["ttft_count"] == 2 and snap["chain_count"] > 0
    assert snap["mixed_steps"] > 0 and snap["prefill_chunks"] > 0
    assert snap["host_gap_s"] > 0 and snap["blocks_total"] == 95


ROUND_CASES = {
    # chunked admission: mixed rounds, then chains and plain steps
    "chunked": (dict(), [([1, 2, 3, 4, 5], 12), ([7, 8, 9], 12),
                         (list(range(4, 30)), 6)], {"mixed", "chain"}),
    "whole_prefill": (dict(chunked_prefill=False),
                      [([1, 2, 3, 4, 5], 12), ([7, 8, 9], 12)],
                      {"prefill", "chain"}),
    "speculative": (dict(speculative="ngram"),
                    [([5, 6, 7, 5, 6, 7, 5, 6], 12), ([9, 9, 9, 9], 12)],
                    {"mixed", "verify"}),
    "state": (None, [([1, 2, 3, 4, 5], 12), ([7, 8, 9], 12)],
              {"mixed", "chain"}),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_every_dispatch_records_one_issue_span(weights, store, case):
    """Each round's engine.issue.<kind> starts with its engine.device.<kind>
    (both at the dispatch), ends inside it, and carries rows <= capacity."""
    _pj, pt = weights
    kw, reqs, kinds = ROUND_CASES[case]
    if kw is None:
        eng = StateDecodeEngine(CFG_T, pt, device="cpu", max_slots=24,
                                max_batch_size=4, prefill_chunk=8,
                                chain_steps=4, name="t_obs_issue_state")
    else:
        eng = _engine(pt, f"t_obs_issue_{case}", **kw)
    eng.generate_batch(list(reqs))
    run = [s for s in obs.recorder().snapshot()
           if s.trace_id == eng._run_ctx[0]]
    device = {s.t0: s for s in run if s.name.startswith("engine.device.")}
    issue = [s for s in run if s.name.startswith("engine.issue.")]
    assert len(issue) == len(device) == sum(eng.rounds.values())
    assert {s.name.rsplit(".", 1)[1] for s in issue} >= kinds
    for s in issue:
        d = device[s.t0]
        assert d.name.rsplit(".", 1)[1] == s.name.rsplit(".", 1)[1]
        assert d.t0 <= s.t1 <= d.t1
        assert s.attrs["capacity"] == eng.max_batch_size
        assert 1 <= s.attrs["rows"] <= s.attrs["capacity"]


@pytest.mark.parametrize("sizes", [dict(), dict(num_blocks=16)],
                         ids=["rows", "blocks"])
def test_every_request_has_one_pending_span(weights, sizes):
    """Six requests on four rows (and, with 16 blocks, a pool that makes
    them wait and preempts): each has one engine.pending under its
    engine.request, from the request's start to the end of its first
    admission."""
    _pj, pt = weights
    eng = _engine(pt, "t_obs_pending", **sizes)
    reqs = [(list(range(1 + i, 9 + i)), 10) for i in range(6)]
    out = eng.generate_batch(list(reqs))
    assert all(len(o) == 10 for o in out)
    spans = obs.recorder().snapshot()
    roots = [s for s in spans if s.name == "engine.request"]
    assert len(roots) == 6
    waits = []
    for root in roots:
        kids = [s for s in spans if s.trace_id == root.trace_id
                and s.parent_id == root.span_id]
        pend = [s for s in kids if s.name == "engine.pending"]
        adm = sorted((s for s in kids if s.name == "engine.admission"),
                     key=lambda s: s.t0)
        assert len(pend) == 1 and adm
        assert pend[0].t0 == root.t0 and pend[0].t1 == adm[0].t1
        waits.append(pend[0].t1 - pend[0].t0)
    # two requests waited for rows: their pending spans hold rounds
    waits.sort()
    assert waits[-1] > 10 * waits[0]


def test_time_in_queue_counts_every_request_once(weights):
    """A batch's first request and one its engine polls mid-batch each add
    their queue wait to ServeStats.time_in_queue_s, once: the counter
    equals the sum of the requests' serve.queue spans."""
    import threading
    import time

    _pj, pt = weights
    eng = _engine(pt, "t_obs_queue")
    sched = RequestScheduler(
        lambda reqs: eng.serve_batch(reqs, scheduler=sched),
        name="t_obs_queue_s", max_batch_size=1, batch_linger_ms=0.0,
        start=False)
    before = sched.stats.snapshot()["time_in_queue_s"]
    outs = []
    threads = [threading.Thread(
        target=lambda p: outs.append(sched.submit((p, 6))), args=(p,))
        for p in ([1, 2, 3], [4, 5, 6, 7])]
    try:
        for i, t in enumerate(threads):
            t.start()
            limit = time.perf_counter() + 10
            while sched.queue_depth <= i and time.perf_counter() < limit:
                time.sleep(0.001)
        time.sleep(0.1)  # both queued: a double count would add >= 0.1 s
        sched.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sched.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert sorted(len(o) for o in outs) == [6, 6]
    spans = obs.recorder().snapshot()
    # one batch: the second request was polled into it by the engine
    assert sum(1 for s in spans if s.name == "serve.batch") == 1
    queued = [s for s in spans if s.name == "serve.queue"]
    assert len(queued) == 2
    assert all(s.attrs["outcome"] == "dispatched" for s in queued)
    got = sched.stats.snapshot()["time_in_queue_s"] - before
    want = sum(s.t1 - s.t0 for s in queued)
    assert want >= 0.2
    assert abs(got - want) < 0.02, (got, want)


def test_scheduler_spans_and_the_engine_joining_them(weights):
    _pj, pt = weights
    eng = _engine(pt, "t_obs_sched")
    sched = RequestScheduler(
        lambda reqs: eng.serve_batch(reqs, scheduler=sched),
        name="t_obs_sched_s", max_batch_size=2, batch_linger_ms=1.0)
    try:
        assert len(sched.submit(([1, 2, 3], 4))) == 4
    finally:
        sched.shutdown()
    spans = obs.recorder().snapshot()
    root = next(s for s in spans if s.name == "serve.request")
    assert root.attrs["outcome"] == "done"
    same = {s.name: s for s in spans if s.trace_id == root.trace_id}
    assert same["serve.queue"].parent_id == root.span_id
    assert same["serve.queue"].attrs["outcome"] == "dispatched"
    assert same["serve.execute"].parent_id == root.span_id
    assert "engine.request" in same
    batch = next(s for s in spans if s.name == "serve.batch")
    assert batch.attrs["scheduler"] == "t_obs_sched_s"


def test_engine_failure_dumps_the_flight_recorder(weights, tmp_path,
                                                  monkeypatch):
    _pj, pt = weights
    monkeypatch.setenv("PATHWAY_TRACE_DUMP_DIR", str(tmp_path))
    eng = _engine(pt, "t_obs_fail", max_restarts=0)
    faults.install("engine.dispatch.chain", "raise", nth=1)
    with pytest.raises(EngineFailedError) as exc:
        eng.generate_batch([([1, 2, 3], 12)])
    path = exc.value.dump_path
    assert path is not None and path.startswith(str(tmp_path))
    assert exc.value.trace_id == eng._run_ctx[0]
    dump = json.loads(open(path).read())
    xs = [e for e in dump["traceEvents"] if e["ph"] == "X"]
    assert any(e["name"] == "engine.run" and e["args"].get("error")
               for e in xs)
    assert any(e["name"] == "engine.sync" for e in xs)
    assert any(e["name"] == "fault.injected"
               and e["args"]["point"] == "engine.dispatch.chain" for e in xs)


def test_restart_is_an_event_and_a_counter(weights):
    pj, pt = weights
    reqs = [([1, 2, 3, 4, 5], 12), ([7, 8, 9], 12)]
    want = JaxEngine(CFG_J, pj, attn="reference", name="t_obs_rs_j",
                     **SIZES).generate_batch(list(reqs))
    eng = _engine(pt, "t_obs_restart", max_restarts=1)
    faults.install("engine.dispatch.chain", "raise", nth=1)
    assert eng.generate_batch(list(reqs)) == want
    events = [s for s in obs.recorder().snapshot()
              if s.name == "engine.restart"]
    assert len(events) == 1 and events[0].attrs["attempt"] == 1
    snap = eng.pool.kv_stats.snapshot()
    assert snap["engine_restarts"] == 1
    assert snap["engine_recovery_count"] == 1
    assert eng.pool.name == "t_obs_restart"  # the rebuilt pool re-attached


def test_state_engine_spans_and_counters(weights, tmp_path):
    _pj, pt = weights
    store = SessionStore(name="t_obs_state_store")
    eng = StateDecodeEngine(CFG_T, pt, device="cpu", max_slots=24,
                            max_batch_size=4, prefill_chunk=8, chain_steps=4,
                            session_store=store, name="t_obs_state")
    turn1 = [1, 2, 3, 4, 5, 6]
    out1 = eng.generate_batch([(turn1, 6, {"session": "s"})])[0]
    # turn 2 continues the conversation: its stored state is resumed
    eng.generate_batch([(turn1 + out1 + [9, 9, 9], 6, {"session": "s"})])
    names = {s.name for s in obs.recorder().snapshot()}
    assert {"engine.run", "engine.request", "engine.sync",
            "engine.chain", "engine.prefill_chunk"} <= names
    st = eng.pool.state_stats.snapshot()
    assert st["suspends"] == 2 and st["resumes"] == 1
    assert eng.pool.kv_stats.snapshot()["ttft_count"] == 2
    assert eng.pool.stats()["suspends"] == 2  # the cache's own counts
    from pathway_tpu_torch.serve import metrics

    lines = metrics.render_prometheus_lines()
    assert any(ln.startswith('pathway_state_suspends_total{cache="'
                             't_obs_state"} 2') for ln in lines)


def test_fault_event_and_the_kill_dump(tmp_path):
    faults.install("engine.draft", "drop", nth=1)
    assert faults.fire("engine.draft") == "drop"
    ev = [s for s in obs.recorder().snapshot() if s.name == "fault.injected"]
    assert ev and ev[0].attrs == {"point": "engine.draft", "action": "drop",
                                  "nth": 1}
    code = ("from pathway_tpu_torch import faults\n"
            "faults.install('engine.sync', 'kill')\n"
            "faults.fire('engine.sync')\n"
            "print('survived')\n")
    env = dict(os.environ, PATHWAY_TRACE_DUMP_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == faults.KILL_EXIT_CODE, out.stderr
    assert "survived" not in out.stdout
    dumps = list(tmp_path.glob("pathway_trace_*_fault_kill_*.json"))
    assert len(dumps) == 1
    names = {e["name"] for e in json.loads(dumps[0].read_text())
             ["traceEvents"]}
    assert "fault.injected" in names
