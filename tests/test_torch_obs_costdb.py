"""pathway_tpu_torch.obs.costdb and obs.planner against the JAX package.

- the cost store round-trips through its JSON file keyed by the backend
  fingerprint (``cpu:cpu:torch<version>`` here), its writer thread starts
  and stops, concurrent writers' flushes merge, a missing file is an
  empty store and a file that is not a store raises;
- the planner: both packages read ONE seeded store under ONE fingerprint
  string and give the same value and source for every knob (the
  counterparts of tests/test_planner.py's decisions), an env pin wins,
  a fresh host reports documented defaults, ``cached_crossover``
  consults once, and ``legal_tp_values`` equals the reference's.
"""

import json
import time

import pytest
import torch

from pathway_tpu.obs import costdb as jcostdb
from pathway_tpu.obs import planner as jplanner
from pathway_tpu.parallel.mesh import legal_tp_values as jlegal
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.obs import costdb, planner

FP = "shared:test-fingerprint:v1"


def test_fingerprint_names_backend_device_and_torch():
    fp = costdb.backend_fingerprint()
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).replace(" ", "-")
        assert fp == f"cuda:{name}:torch{torch.__version__}"
    else:
        assert fp == f"cpu:cpu:torch{torch.__version__}"


def test_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv("PW_COSTDB_PATH", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert costdb.default_path() == str(
        tmp_path / "pathway_tpu_torch" / "costdb.json")
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "x.json"))
    assert costdb.default_path() == str(tmp_path / "x.json")


def test_roundtrip_and_fingerprint_scoping(tmp_path):
    path = str(tmp_path / "costdb.json")
    db = costdb.CostDB(path=path, flush_interval_s=60.0)
    db.observe("pw.chained_decode", "f32[4,8]", ms=3.25, flops=1e9,
               mfu=0.02)
    db.observe("pw.chained_decode", "f32[4,8]", ms=2.75)
    ent = db.get("pw.chained_decode", "f32[4,8]")
    assert ent["n"] == 2 and ent["ms_best"] == 2.75
    assert ent["flops"] == 1e9
    assert ent["fingerprint"] == costdb.backend_fingerprint()
    db.shutdown()
    db2 = costdb.CostDB(path=path, flush_interval_s=60.0)
    assert db2.get("pw.chained_decode", "f32[4,8]")["ms_best"] == 2.75
    raw = json.load(open(path))
    assert raw["version"] == 1
    assert f"pw.chained_decode|f32[4,8]|{db.fingerprint}" in raw["entries"]
    # another backend's rows are invisible by construction
    db2.fingerprint = "cuda:other-card:torch0"
    assert db2.get("pw.chained_decode", "f32[4,8]") is None
    db2.shutdown()


def test_writer_thread_lifecycle(tmp_path):
    path = str(tmp_path / "costdb2.json")
    db = costdb.CostDB(path=path, flush_interval_s=0.05)
    db.observe("p", "b", ms=1.0)
    assert db.writer_alive
    deadline = time.time() + 5.0
    while time.time() < deadline:
        try:
            if json.load(open(path))["entries"]:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.02)
    else:
        pytest.fail("writer thread never flushed")
    writer = db._writer
    db.shutdown()
    assert not db.writer_alive
    assert writer is not None and not writer.is_alive()


def test_flush_merges_concurrent_writers(tmp_path):
    path = str(tmp_path / "shared.json")
    a = costdb.CostDB(path=path, flush_interval_s=60.0)
    b = costdb.CostDB(path=path, flush_interval_s=60.0)  # loaded empty
    a.observe("prog_a", "bkt", ms=1.0)
    a.flush()
    b.observe("prog_b", "bkt", ms=2.0)
    b.flush()
    progs = {e["program"] for e in json.load(open(path))["entries"].values()}
    assert progs == {"prog_a", "prog_b"}
    a.shutdown()
    b.shutdown()


def test_flushes_at_once_lose_no_key(tmp_path):
    """A cluster's processes flush one store at once: each flush merges
    under the file's lock, so every writer's keys survive (an unlocked
    read-merge-replace let a later replace drop an earlier one's)."""
    import threading

    path = str(tmp_path / "shared.json")
    dbs = [costdb.CostDB(path=path, flush_interval_s=60.0) for _ in range(8)]
    start = threading.Barrier(len(dbs))

    def writer(i, db):
        start.wait(10)
        for j in range(25):
            db.observe(f"prog_{i}", f"b{j}", ms=1.0)
            db.flush()

    threads = [threading.Thread(target=writer, args=(i, db))
               for i, db in enumerate(dbs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    keys = {(e["program"], e["bucket"])
            for e in json.load(open(path))["entries"].values()}
    assert keys == {(f"prog_{i}", f"b{j}") for i in range(8)
                    for j in range(25)}
    for db in dbs:
        db.shutdown()


def test_missing_file_is_empty_and_a_bad_file_raises(tmp_path):
    db = costdb.CostDB(path=str(tmp_path / "absent.json"))
    assert len(db) == 0
    db.shutdown()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError):
        costdb.CostDB(path=str(bad))
    bad.write_text(json.dumps({"version": 1}))
    with pytest.raises(ValueError, match="entries"):
        costdb.CostDB(path=str(bad))


def test_default_db_follows_the_env_and_shuts_down(monkeypatch, tmp_path):
    costdb.shutdown()
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "d.json"))
    try:
        db = costdb.default_db()
        assert db.path == str(tmp_path / "d.json")
        assert costdb.default_db() is db
        db.observe("p", "b", ms=1.0)
    finally:
        costdb.shutdown()
    assert json.load(open(tmp_path / "d.json"))["entries"]


# -- the planner, both packages over one store --------------------------------


@pytest.fixture
def stores(tmp_path):
    """A JAX store and a port store over ONE file under ONE fingerprint:
    rows written through either are read by both."""
    path = str(tmp_path / "planner.json")
    j = jcostdb.CostDB(path, flush_interval_s=3600.0)
    j.fingerprint = FP
    t = costdb.CostDB(path, flush_interval_s=3600.0)
    t.fingerprint = FP

    def seed(*observations):
        for prog, bucket, ms in observations:
            j.observe(prog, bucket, ms=ms)
        j.flush()
        t._entries = costdb._read_entries(path)

    yield j, t, seed
    j.shutdown()
    t.shutdown()


def _seed_pair(program, pairs):
    out = []
    for n, (jit_ms, np_ms) in pairs.items():
        out += [(f"{program}.jit", f"n{n}", jit_ms),
                (f"{program}.numpy", f"n{n}", np_ms)]
    return out


def _same(dj, dt):
    assert (dt.knob, dt.value, dt.source) == (dj.knob, dj.value, dj.source)


CROSSOVERS = {
    "sustained": {4096: (0.5, 1.0), 16384: (4.0, 2.0), 65536: (3.0, 5.0),
                  262144: (2.0, 9.0)},
    "never": {4096: (2.0, 1.0), 65536: (9.0, 3.0)},
    "always": {4096: (0.1, 1.0), 65536: (0.2, 3.0)},
    "fresh": {},
}


@pytest.mark.parametrize("case", sorted(CROSSOVERS))
def test_jit_crossover_equals_the_reference(stores, case):
    j, t, seed = stores
    seed(*_seed_pair("pw.reduce.segment_sum", CROSSOVERS[case]))
    dj = jplanner.jit_crossover("pw.reduce.segment_sum", db=j)
    dt = planner.jit_crossover("pw.reduce.segment_sum", db=t)
    _same(dj, dt)
    assert dt.candidates == dj.candidates
    if case == "fresh":
        assert dt.source == "default" and dt.value == 65536


def test_foreign_fingerprint_rows_are_ignored(stores):
    j, t, seed = stores
    seed(*_seed_pair("pw.reduce.segment_sum", {65536: (1.0, 9.0)}))
    for db in (j, t):
        db.fingerprint = "other-backend:card:v9"
    _same(jplanner.jit_crossover("pw.reduce.segment_sum", db=j),
          planner.jit_crossover("pw.reduce.segment_sum", db=t))
    assert planner.jit_crossover("pw.reduce.segment_sum",
                                 db=t).source == "default"


@pytest.mark.parametrize("epochs,current,cap", [
    ({"p1": 5000.0, "p2": 2000.0, "p4": 2000.0}, 1, 8),
    ({"p8": 100.0, "p2": 900.0}, 2, 4),
    ({}, 3, None),
])
def test_process_count_equals_the_reference(stores, epochs, current, cap):
    j, t, seed = stores
    seed(*[("pw.cluster.epoch", b, ms) for b, ms in epochs.items()])
    dj = jplanner.choose_process_count(current, db=j, max_procs=cap)
    dt = planner.choose_process_count(current, db=t, max_procs=cap)
    _same(dj, dt)


@pytest.mark.parametrize("rows", [{}, {"tp1": 9.0, "tp2": 4.0, "tp4": 4.0}])
def test_choose_tp_equals_the_reference(stores, rows):
    j, t, seed = stores
    seed(*[("pw.engine.tp", b, ms) for b, ms in rows.items()])
    cfg = tdec.DecoderConfig(vocab_size=64, d_model=64, n_layers=2,
                             n_heads=8, d_ff=128, max_len=128)
    for kw in (dict(n_devices=4), dict(n_devices=4, cfg=cfg)):
        _same(jplanner.choose_tp(db=j, **kw),
              planner.choose_tp(db=t, device="cpu", **kw))


def test_legal_tp_values_equal_the_reference():
    for args in ((8, 64, 4, 128), (12, 50257, 8, 3072), (4, 30, None, 12),
                 (6, 36, 6, None)):
        assert planner.legal_tp_values(*args) == jlegal(*args)


@pytest.mark.parametrize("with_cfg", [False, True])
def test_plan_equals_the_reference(stores, monkeypatch, with_cfg):
    j, t, seed = stores
    monkeypatch.delenv("PW_MAPREDUCE_JIT_MIN", raising=False)
    monkeypatch.delenv("PW_VECTORIZE_JIT_MIN", raising=False)
    monkeypatch.delenv("PATHWAY_PROCESSES", raising=False)
    seed(*_seed_pair("pw.reduce.segment_sum", {4096: (9.0, 1.0),
                                               65536: (1.0, 9.0)}),
         ("pw.cluster.epoch", "p2", 700.0), ("pw.cluster.epoch", "p1",
                                             2000.0))
    kw = dict(current_processes=1, max_procs=4, n_devices=1)
    cfg = None
    if with_cfg:
        from pathway_tpu.models import decoder as jdec

        widths = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8,
                      d_ff=128, max_len=128)
        cfg = (jdec.DecoderConfig(**widths), tdec.DecoderConfig(**widths))
    pj = jplanner.plan(db=j, cfg=cfg[0] if cfg else None, **kw)
    pt = planner.plan(db=t, cfg=cfg[1] if cfg else None, device="cpu", **kw)
    assert [d.knob for d in pt.decisions] == [d.knob for d in pj.decisions]
    for dj, dt in zip(pj.decisions, pt.decisions):
        _same(dj, dt)
    assert pt.value("pw.reduce.segment_sum.jit_min") == 65536
    assert pt.get("processes").source == "costdb"
    rendered = pt.render()
    assert "pw.reduce.segment_sum.jit_min" in rendered and FP in rendered


def test_fresh_host_plan_reports_documented_defaults(tmp_path, monkeypatch):
    for var in ("PW_MAPREDUCE_JIT_MIN", "PW_VECTORIZE_JIT_MIN",
                "PATHWAY_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    db = costdb.CostDB(str(tmp_path / "fresh.json"), flush_interval_s=3600.0)
    try:
        p = planner.plan(db=db, current_processes=1, n_devices=1,
                         device="cpu")
    finally:
        db.shutdown()
    knobs = {d.knob for d in p.decisions}
    for expected in ("pw.reduce.segment_sum.jit_min",
                     "pw.map.vecplan.jit_min", "processes", "tp", "dp",
                     "num_blocks", "block_size", "max_batch_size",
                     "chain_steps", "prefill_chunk"):
        assert expected in knobs
    assert all(d.source == "default" for d in p.decisions)


def test_env_pin_wins_and_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_MAPREDUCE_JIT_MIN", "123")
    db = costdb.CostDB(str(tmp_path / "pin.json"), flush_interval_s=3600.0)
    try:
        d = planner.plan(db=db, current_processes=1, n_devices=1,
                         device="cpu").get("pw.reduce.segment_sum.jit_min")
    finally:
        db.shutdown()
    assert (d.value, d.source) == (123, "env")
    assert "PW_MAPREDUCE_JIT_MIN" in d.why


def test_cached_crossover_consults_once(stores, monkeypatch):
    _j, t, _seed = stores
    calls = []
    real = planner.jit_crossover

    def counting(program, **kw):
        calls.append(program)
        return real(program, db=t)

    monkeypatch.setattr(planner, "jit_crossover", counting)
    planner.invalidate_cache()
    try:
        v1 = planner.cached_crossover("pw.reduce.segment_sum")
        v2 = planner.cached_crossover("pw.reduce.segment_sum")
    finally:
        planner.invalidate_cache()
    assert v1 == v2 == 65536 and len(calls) == 1
