"""The port's overlapped data plane: counted marks, the async sender,
pipelined coordinator rounds and aggregates-only exchange —
``tests/test_overlap_fabric.py``'s cases against the port.

  - real 2-process spawns pinning output byte-identity against the port's
    serial walk (1 process x 2 threads in this interpreter, itself held
    to the JAX package's single-process run): wordcount and a
    join+groupby pipeline, repeated, and under a delayed straggler
    (``PW_FABRIC_SEND_DELAY_MS``);
  - in-process 2-runner harnesses (two ``ClusterRunner``s over one
    loopback fabric in one interpreter) for FIFO/coalescing semantics,
    the span-based agree-min overlap, and a row carrying a tensor
    crossing between the two processes equal;
  - unit tests for the counted-mark wait, the exchange combiner, the
    segment reduction's tiers, the scan partitioner, the hybrid index's
    zero weight and the fabric counters' rendering.
"""

import json
import os
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from .torch_cluster import (
    bare_fabric,
    fabric_port_block,
    hard_alarm,
    run_in_process,
    spawn_cluster,
    squash_jsonl,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


@pytest.fixture(autouse=True)
def _hard_timeout():
    with hard_alarm(180):
        yield


def _wordcount_script(tmp: Path, out: Path) -> Path:
    inp = tmp / "input.csv"
    if not inp.exists():
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
        lines = [" ".join(words[(i + j) % len(words)] for j in range(3))
                 for i in range(300)]
        inp.write_text("line\n" + "\n".join(f'"{l}"' for l in lines) + "\n")
    script = tmp / f"app_{out.stem}.py"
    script.write_text(textwrap.dedent(f"""
        import pathway_tpu_torch as pw

        class S(pw.Schema):
            line: str

        t = pw.io.csv.read({str(inp)!r}, schema=S, mode="static")
        words = t.select(word=pw.apply(lambda s: s.split(), t.line)).flatten(
            pw.this.word
        )
        counts = words.groupby(words.word).reduce(
            words.word, count=pw.reducers.count()
        )
        pw.io.jsonlines.write(counts, {str(out)!r})
        pw.run(device="cpu")
    """))
    return script


def _serial(tmp: Path, make, key_cols) -> bytes:
    """The port's 1-process x 2-thread output bytes, after holding its
    squashed sink to the JAX package's single-process run."""
    out = tmp / "serial.jsonl"
    run_in_process(make(out), "torch", threads=2)
    ref = tmp / "ref.jsonl"
    run_in_process(make(ref), "jax")
    assert squash_jsonl(out, key_cols) == squash_jsonl(ref, key_cols)
    data = out.read_bytes()
    assert data
    return data


def test_counted_marks_wordcount_byte_identical_to_serial(tmp_path):
    """2 procs x 1 thread produce byte-identical output to 1 proc x 2
    threads (same shard structure), and repeated 2-proc runs are
    byte-identical to each other."""
    serial = _serial(tmp_path, lambda o: _wordcount_script(tmp_path, o),
                     ("word", "count"))
    for run in range(2):
        outn = tmp_path / f"out2_{run}.jsonl"
        spawn_cluster(_wordcount_script(tmp_path, outn), processes=2)
        assert outn.read_bytes() == serial, (
            f"2-proc run {run} diverged from the serial walk")


def test_join_groupby_pipeline_byte_identical(tmp_path):
    """A join + groupby graph — the join exchange routes by join-key hash
    (no combiner), the groupby exchange consolidates; both keep the
    serial bytes."""
    left = tmp_path / "left.csv"
    right = tmp_path / "right.csv"
    left.write_text("k,v\n" + "\n".join(
        f"g{i % 7},{i}" for i in range(200)) + "\n")
    right.write_text("k,w\n" + "\n".join(
        f"g{i % 7},{i * 10}" for i in range(40)) + "\n")

    def script(out: Path) -> Path:
        s = tmp_path / f"japp_{out.stem}.py"
        s.write_text(textwrap.dedent(f"""
            import pathway_tpu_torch as pw

            class L(pw.Schema):
                k: str
                v: int

            class R(pw.Schema):
                k: str
                w: int

            lt = pw.io.csv.read({str(left)!r}, schema=L, mode="static")
            rt = pw.io.csv.read({str(right)!r}, schema=R, mode="static")
            j = lt.join(rt, lt.k == rt.k).select(lt.k, lt.v, rt.w)
            agg = j.groupby(j.k).reduce(
                j.k, total=pw.reducers.sum(j.v + j.w),
                n=pw.reducers.count(),
            )
            pw.io.jsonlines.write(agg, {str(out)!r})
            pw.run(device="cpu")
        """))
        return s

    serial = _serial(tmp_path, script, ("k", "total", "n"))
    out2 = tmp_path / "jout2.jsonl"
    spawn_cluster(script(out2), processes=2)
    assert out2.read_bytes() == serial


def test_delayed_straggler_and_forced_coalescing_identical(tmp_path):
    """pid 1's sender thread delays every drain cycle (a straggler, and
    frames pile up): the counted marks wait for exactly the announced
    frames, so the output bytes do not change."""
    serial = _serial(tmp_path, lambda o: _wordcount_script(tmp_path, o),
                     ("word", "count"))
    out2 = tmp_path / "fout2.jsonl"
    stats_dir = tmp_path / "fstats"
    spawn_cluster(
        _wordcount_script(tmp_path, out2), processes=2,
        extra_env={
            "PW_FABRIC_SEND_DELAY_MS": "40",
            "PW_FABRIC_DELAY_PID": "1",
            "PW_FABRIC_STATS_DIR": str(stats_dir),
        },
    )
    assert out2.read_bytes() == serial
    stats = [json.load(open(p)) for p in sorted(stats_dir.glob("*.json"))]
    assert len(stats) == 2, "fabric stats were not dumped"
    assert sum(s["data_msgs_out"] for s in stats) > 0
    assert sum(s["recv_count"] for s in stats) > 0


# -- in-process 2-runner harness ----------------------------------------------


def _dual_runners(build_graph, attempts: int = 4, tweak=None):
    """One graph under two cooperating ClusterRunners (pid 0/1) in this
    interpreter over a loopback fabric; returns (runner0, runner1).
    ``tweak(runners)`` runs after both are built, before run_batch."""
    import pathway_tpu_torch  # noqa: F401
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.parallel import cluster as cl
    from pathway_tpu_torch.parallel.comm import FabricError

    for attempt in range(attempts):
        pg.G.clear()
        sinks = build_graph()
        port = fabric_port_block(2)
        os.environ.setdefault("PATHWAY_FABRIC_SECRET", "test-run-secret")
        lower_lock = threading.Lock()
        orig_lower = cl.runner_mod.lower

        def locked_lower(s, device="cuda", _orig=orig_lower,
                         _lock=lower_lock):
            with _lock:
                return _orig(s, device)

        cl.runner_mod.lower = locked_lower
        runners: dict = {}
        errors: dict = {}

        def side(pid):
            try:
                r = cl.ClusterRunner(sinks, n_local_shards=1, pid=pid,
                                     nprocs=2, first_port=port,
                                     device="cpu")
                runners[pid] = r
                if barrier.wait(timeout=30) == 0 and tweak is not None:
                    tweak(runners)  # both built; patch exactly once
                barrier.wait(timeout=30)  # the patch visible to both
                r.run_batch()
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors[pid] = exc
                barrier.abort()

        barrier = threading.Barrier(2)
        threads = [threading.Thread(target=side, args=(p,), daemon=True)
                   for p in (0, 1)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            cl.runner_mod.lower = orig_lower
        if not errors and len(runners) == 2:
            return runners[0], runners[1]
        mesh_flake = all(
            isinstance(e, (FabricError, threading.BrokenBarrierError))
            for e in errors.values())
        if not mesh_flake or attempt == attempts - 1:
            raise AssertionError(f"dual-runner run failed: {errors}")
    raise AssertionError("unreachable")


def _wordcount_table(pw):
    rows = [(f"w{i % 37}",) for i in range(800)]
    t = pw.debug.table_from_rows(pw.schema_from_types(w=str), rows)
    return t.groupby(t.w).reduce(t.w, n=pw.reducers.count())


def _wordcount_sinks():
    import pathway_tpu_torch as pw

    return [_wordcount_table(pw)._materialize_capture()]


def test_inprocess_dual_runner_matches_serial():
    """The in-process 2-runner walk gives the 1-process 2-shard walk's
    squashed capture, which is the JAX package's."""
    import pathway_tpu as jpw
    from pathway_tpu.engine.runner import run_tables as jrun_tables
    from pathway_tpu.internals import parse_graph as jpg
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.parallel.cluster import ClusterRunner

    r0, _r1 = _dual_runners(_wordcount_sinks)
    got = r0.captures[next(iter(r0.captures))].squash()
    # the groupby's exchange edge consolidates before it routes
    # (mapreduce.combine_for_exchange)
    assert list(r0._combine_specs.values()) == [((),)]

    pg.G.clear()
    sinks = _wordcount_sinks()
    serial = ClusterRunner(sinks, n_local_shards=2, device="cpu")
    want = serial.run_batch()[sinks[0].id].squash()
    pg.G.clear()
    jpg.G.clear()
    [jcap] = jrun_tables(_wordcount_table(jpw))
    jpg.G.clear()
    assert got == want == jcap.squash() and len(want) == 37


def test_tensor_valued_rows_cross_the_fabric_equal():
    """Rows carrying torch tensors and device-vector handles cross an
    exchange between the two processes; what arrives equals what was
    sent, as host values, and every handle is counted as a host copy."""
    import torch

    from pathway_tpu_torch.ops.device_store import DeviceVecStore

    store = DeviceVecStore(device="cpu")
    vecs = store.append_batch(torch.arange(40, dtype=torch.float32)
                              .reshape(10, 4))
    rows = [(f"k{i}", torch.arange(3, dtype=torch.float64) * i, vecs[i])
            for i in range(10)]

    def sinks():
        import pathway_tpu_torch as pw

        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, t=object, d=object), rows)
        g = t.groupby(t.k).reduce(t.k, t=pw.reducers.any(t.t),
                                  d=pw.reducers.any(t.d))
        return [g._materialize_capture()]

    r0, r1 = _dual_runners(sinks)
    got = {row[0]: row for row in
           r0.captures[next(iter(r0.captures))].squash().values()}
    assert sorted(got) == sorted(k for k, _t, _d in rows)
    crossed = 0
    for k, ten, vec in rows:
        _k, t_got, d_got = got[k]
        assert isinstance(t_got, torch.Tensor) and t_got.device.type == "cpu"
        assert torch.equal(t_got, ten)
        assert np.array_equal(np.asarray(d_got), vec.to_numpy())
        crossed += not isinstance(d_got, type(vec))
    # rows owned by the other process arrived as host copies
    assert crossed > 0
    sent = r0.fabric.stats["host_copies"] + r1.fabric.stats["host_copies"]
    assert sent == crossed


def test_agree_min_overlaps_straggler_compute():
    """The pipelined coordinator round rides under the straggler's
    compute: the fast process posts its min report while the straggler
    is still inside cluster.run_time for the same logical time (one
    perf_counter clock in one interpreter, so span times compare)."""
    from pathway_tpu_torch import obs

    delay = 0.4

    def tweak(runners):
        # pid 0 (the coordinator) is the straggler: its last position's
        # flush sleeps
        r0 = runners[0]
        op = r0.topo[0][r0.n_pos - 1]
        orig_flush = op.flush

        def slow_flush(t):
            time.sleep(delay)
            return orig_flush(t)

        op.flush = slow_flush

    r0, r1 = _dual_runners(_wordcount_sinks, tweak=tweak)
    spans = obs.recorder().snapshot()
    t0_runs = [s for s in spans if s.name == "cluster.run_time"
               and s.trace_id == r0._obs_ctx[0]]
    p1_agrees = [s for s in spans if s.name == "cluster.agree_min"
                 and s.trace_id == r1._obs_ctx[0]]
    assert t0_runs and p1_agrees
    straggler_end = max(s.t1 for s in t0_runs)
    overlapped = [s for s in p1_agrees
                  if s.t0 < straggler_end - delay / 2
                  and s.t1 > s.t0 + delay / 2]
    assert overlapped, (
        f"no agree_min round overlapped the straggler walk "
        f"(straggler_end={straggler_end}, "
        f"agrees={[(s.t0, s.t1) for s in p1_agrees]})")
    assert r1.fabric.stats["agree_min_s"] >= delay / 2


def test_async_sender_fifo_and_forced_coalescing(monkeypatch):
    """With the sender delayed, small same-(t, pos) frames pile up and
    coalesce into grouped frames; the receiver still sees every logical
    frame, in seq order, with counts matching."""
    from pathway_tpu_torch.parallel.comm import Fabric

    monkeypatch.setenv("PATHWAY_FABRIC_SECRET", "test-run-secret")
    monkeypatch.setenv("PW_FABRIC_SEND_DELAY_MS", "25")
    monkeypatch.setenv("PW_FABRIC_DELAY_PID", "0")
    for attempt in range(4):
        port = fabric_port_block(2)
        fabrics: dict = {}
        errs: dict = {}

        def mk(pid):
            try:
                fabrics[pid] = Fabric(pid, 2, port, connect_timeout_s=8.0)
            except Exception as exc:  # noqa: BLE001
                errs[pid] = exc

        ts = [threading.Thread(target=mk, args=(p,)) for p in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        if not errs:
            break
        if attempt == 3:
            raise AssertionError(f"mesh formation failed: {errs}")
    f0, f1 = fabrics[0], fabrics[1]
    n = 60
    for seq in range(1, n + 1):
        f0.send_data(1, 7, 3, 0, 1, seq, [("k", (seq,), 1)], vouch=False)
    f0.post_mark(7, 4)
    f1.wait_marks(7, 4, timeout_s=30.0)
    batches = f1.take_data(7, 3)
    assert len(batches) == n
    assert [b[1] for b in batches] == list(range(1, n + 1))  # seq order
    assert f1._recv_pos_counts[(0, 7, 3)] == n
    assert f0.stats["sender_coalesced"] > 0
    assert f0.stats["send_count"] < n
    f0.close()
    f1.close()


def test_counted_mark_wait_only_blocks_on_inflight_frames():
    """A peer whose cursor passed the position with no announced frames
    completes the wait at once; announced-but-unlanded frames block until
    the data arrives (count-proof, not FIFO)."""
    f = bare_fabric(pid=0, peers=(1,))
    f._marks[1][4] = 9
    t0 = time.perf_counter()
    f.wait_marks(4, 9, timeout_s=5.0)
    assert time.perf_counter() - t0 < 0.05

    # the mark overtook its data: 2 announced, 1 landed — blocks until 2
    f._marks[1][5] = 3
    f._announced[(1, 5)] = {3: 2}
    f._recv_pos_counts[(1, 5, 3)] = 1

    def land_second():
        time.sleep(0.08)
        with f._cond:
            f._recv_pos_counts[(1, 5, 3)] = 2
            f._cond.notify_all()

    th = threading.Thread(target=land_second)
    th.start()
    t0 = time.perf_counter()
    f.wait_marks(5, 3, timeout_s=5.0)
    el = time.perf_counter() - t0
    th.join()
    assert el >= 0.06, "wait returned before the announced frame landed"


def test_gather_broadcast_rendezvous_billed_to_wait_sync():
    """_gather's ctl waits bill their own stat (wait_sync_s)."""
    from pathway_tpu_torch.parallel.cluster import ClusterRunner

    class _FakeFabric:
        def __init__(self):
            self.stats = {"wait_ctl_s": 0.0, "wait_sync_s": 0.0}
            self.sent = []

        def recv_ctl(self, timeout_s=120.0):
            time.sleep(0.03)
            return ("rep", ("payload",))

        def send_ctl(self, peer, payload):
            self.sent.append((peer, payload))

    r = ClusterRunner.__new__(ClusterRunner)
    r.pid = 0
    r.nprocs = 2
    r.fabric = _FakeFabric()
    assert r._gather(("mine",)) == [("mine",), ("payload",)]
    assert r.fabric.stats["wait_sync_s"] >= 0.025
    assert r.fabric.stats["wait_ctl_s"] == 0.0


# -- building blocks -----------------------------------------------------------


def test_exchange_combiner_preserves_multiset_and_guards():
    from pathway_tpu.parallel import mapreduce as jmr
    from pathway_tpu_torch.parallel import mapreduce as mr

    spec = ((),)  # no int-checked positions (count-only reducers)
    ups = [(i, (f"w{i % 5}",), 1) for i in range(100)]
    ups += [(1000 + i, (f"w{i % 5}",), -1) for i in range(5)]
    out = mr.combine_for_exchange(ups, spec)
    assert out == jmr.combine_for_exchange(ups, spec)
    assert out is not None and len(out) == 5
    want: dict = {}
    for _k, row, d in ups:
        want[row] = want.get(row, 0) + d
    assert {row: d for _k, row, d in out} == want
    cancel = [(1, ("x",), 1)] * 40 + [(2, ("x",), -1)] * 40
    assert mr.combine_for_exchange(cancel, spec) == []
    assert mr.combine_for_exchange(ups[:8], spec) is None
    fl = [(i, (f"w{i % 5}", 1.5), 1) for i in range(100)]
    assert mr.combine_for_exchange(fl, ((1,),)) is None
    iv = [(i, (f"w{i % 5}", 7), 1) for i in range(100)]
    assert mr.combine_for_exchange(iv, ((1,),)) is not None
    uh = [(i, (["list"],), 1) for i in range(100)]
    assert mr.combine_for_exchange(uh, spec) is None


def test_segment_sum_numpy_and_device_tier_parity(monkeypatch):
    from pathway_tpu_torch.parallel import mapreduce as mr

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 33, size=5000).astype(np.int32)
    vals = rng.integers(-50, 50, size=5000).astype(np.int32)
    w = rng.integers(-2, 3, size=5000).astype(np.int32)
    monkeypatch.setattr(mr, "_JIT_MIN_ELEMENTS", 1 << 30)
    exact = mr.segment_sum(vals, codes, 33, device="cpu")
    exact_w = mr.segment_sum(vals, codes, 33, weights=w, device="cpu")
    monkeypatch.setattr(mr, "_JIT_MIN_ELEMENTS", 1)
    assert np.array_equal(exact, mr.segment_sum(vals, codes, 33,
                                                device="cpu"))
    assert np.array_equal(exact_w, mr.segment_sum(vals, codes, 33, weights=w,
                                                  device="cpu"))


def test_partition_owner_spreads_similar_names():
    """A linear hash put part0..part3 all on one process; the blake2
    owner spreads them, stably, as the JAX package's does."""
    from pathway_tpu.io._utils import partition_owner as jowner
    from pathway_tpu_torch.io._utils import partition_owner

    owners = [partition_owner(f"part{f:02d}.txt", 2) for f in range(16)]
    assert 4 <= sum(owners) <= 12
    assert owners == [jowner(f"part{f:02d}.txt", 2) for f in range(16)]
    assert all(partition_owner(f"part{f:02d}.txt", 2) == owners[f]
               for f in range(16))


def test_hybrid_zero_weight_skips_dense_embed_and_probe():
    """With the dense weight at 0.0 the hybrid index never touches the
    dense tier; results equal the BM25-only ranking."""
    from pathway_tpu_torch.stdlib.indexing.inner_index import (
        HybridIndex,
        TantivyBM25,
    )

    calls = {"n": 0}

    class _CountingDense:
        def add(self, key, item, metadata=None):
            calls["n"] += 1

        def remove(self, key):
            calls["n"] += 1

        def search(self, q, k, metadata_filter=None):
            calls["n"] += 1
            return []

    bm25 = TantivyBM25()
    hybrid = HybridIndex([_CountingDense(), bm25], weights=[0.0, 1.0])
    for i, d in enumerate(["alpha beta", "beta gamma", "gamma delta"]):
        hybrid.add(i, (None, d))
    res = hybrid.search((None, "beta"), k=2)
    assert calls["n"] == 0, "0-weight dense tier was still exercised"
    assert [k for k, _s in res] == [
        k for k, _s in bm25.search("beta", 4)][: len(res)]
    hybrid.remove(0)
    assert calls["n"] == 0


def test_hybrid_factory_weights_skip_query_embedder():
    """HybridIndexFactory(weights=[0.0, 1.0]) never calls the dense
    embedder: the query path pays BM25 only."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import run_tables
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.stdlib.indexing.retrievers import (
        BruteForceKnnFactory,
        HybridIndexFactory,
        TantivyBM25Factory,
    )

    embed_calls = {"n": 0}

    def dense_embedder(col):
        def _e(x):
            embed_calls["n"] += 1
            return [0.0, 0.0]

        return pw.apply(_e, col)

    pg.G.clear()
    factory = HybridIndexFactory(
        retriever_factories=[
            BruteForceKnnFactory(dimensions=2, embedder=dense_embedder,
                                 device="cpu"),
            TantivyBM25Factory(),
        ],
        weights=[0.0, 1.0],
    )
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(text=str),
        [("alpha beta",), ("beta gamma",), ("delta",)])
    index = factory.build_index(docs.text, docs)
    queries = pw.debug.table_from_rows(pw.schema_from_types(q=str),
                                       [("beta",)])
    reply = index.query_as_of_now(queries.q, number_of_matches=2)
    [cap] = run_tables(reply, device="cpu")
    rows = list(cap.squash().values())
    pg.G.clear()
    assert len(rows) == 1 and rows[0][0], "query produced no matches"
    assert embed_calls["n"] == 0, "dense embedder ran despite weight 0.0"


def test_fabric_sender_stats_render_everywhere():
    """The sender-queue counters flow through /metrics, the dashboard's
    fabric table and the OTLP metrics payload."""
    import pathway_tpu_torch.engine.telemetry as tel
    from pathway_tpu_torch.engine.telemetry import (
        MetricsServer,
        otlp_export_metrics,
    )

    class _Sched:
        frontier = 1
        operators = ()

    class _Fab:
        stats = {
            "sender_queue_depth": 3, "sender_queue_peak": 11,
            "sender_flushes": 40, "sender_coalesced": 7,
            "sender_s": 0.25, "wait_sync_s": 0.5, "compute_s": 1.0,
            "wait_marks_s": 0.1, "agree_min_s": 0.2, "wait_ctl_s": 0.0,
            "send_s": 0.01, "data_msgs_out": 9, "send_bytes": 1234,
            "host_copies": 2,
        }

    srv = MetricsServer(_Sched(), port=0)
    srv.fabric = _Fab()
    text = srv.render()
    assert 'pathway_fabric{stat="sender_queue_depth"} 3' in text
    assert 'pathway_fabric{stat="sender_coalesced"} 7' in text
    assert 'pathway_fabric{stat="host_copies"} 2' in text
    assert 'pathway_fabric{stat="wait_sync_s"} 0.500000' in text
    html = srv.render_dashboard()
    assert "exchange fabric" in html and ">11<" in html and ">7<" in html

    posts = []
    orig = tel._post_json
    tel._post_json = lambda url, payload: posts.append((url, payload))
    try:
        otlp_export_metrics("http://x", _Sched(), fabric=_Fab())
    finally:
        tel._post_json = orig
    assert posts
    body = json.dumps(posts[0][1])
    assert "pathway.fabric" in body and "sender_queue_peak" in body
