"""The port's segment reductions, join membership, map and exchange
consolidation (``parallel/mapreduce.py``) against the JAX package's, and
the planner's measured crossover for them (``calibrate_mapreduce``).

Every ``segment_reduce`` kind x int32/float32/int64/float64 x sizes on
both sides of a pinned crossover (300 and 3,000 elements around 1,024)
runs through the port on the CPU and is held against the JAX package's
numpy path — and against its jitted path where that runs on this jax
build (int32/float32 sum/min/max).  Integer, min/max and membership
results are bit-identical; float32 sums are held at rtol=1e-5 (the
device's reduction order).  Sizes stay below 4,096 unless a test is
about the cost records, so no test writes a cost row it did not ask
for.
"""

import types

import numpy as np
import pytest
import torch

from pathway_tpu.parallel import mapreduce as jmr
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.obs.costdb import CostDB
from pathway_tpu_torch.parallel import mapreduce as tmr

CROSSOVER = 1024
KINDS = ["sum", "count", "min", "max", "avg"]
DTYPES = [np.int32, np.float32, np.int64, np.float64]


@pytest.fixture(autouse=True)
def _own_store(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    yield
    costdb.shutdown()
    planner.invalidate_cache()


def _batch(n, dtype, seed=3, groups=41):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, groups, n).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        values = rng.integers(-50, 50, n).astype(dtype)
    else:
        values = rng.standard_normal(n).astype(dtype)
    weights = rng.choice(np.array([1, 1, 1, -1], np.int64), n)
    return values, codes, weights, groups


def _jax(fn, *args, jit=False, **kw):
    old = jmr._JIT_MIN_ELEMENTS
    jmr._JIT_MIN_ELEMENTS = 1 if jit else 1 << 30
    try:
        return fn(*args, **kw)
    finally:
        jmr._JIT_MIN_ELEMENTS = old


def _assert_same(a, b, float32_sum: bool):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if float32_sum and x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
        else:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("n", [300, 3000])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", KINDS)
def test_segment_reduce_equals_the_jax_package(kind, dtype, n, monkeypatch):
    values, codes, weights, g = _batch(n, dtype)
    # diff weights widen to int64/float64 (numpy side), as in the engine
    w = weights if kind in ("count", "avg") else None
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", CROSSOVER)
    before = dict(tmr.STATS)
    got = tmr.segment_reduce(values, codes, g, kind, weights=w,
                             device="cpu")
    ran_device = tmr.STATS["segment_device"] > before["segment_device"]
    # the JAX dtype rule decides which batches reach the device
    device_dtype = np.dtype(dtype) in (np.int32, np.float32) and w is None
    assert ran_device == (n >= CROSSOVER and device_dtype
                          and kind in ("sum", "min", "max"))
    float32_sum = kind in ("sum", "avg")
    _assert_same(got, _jax(jmr.segment_reduce, values, codes, g, kind,
                           weights=w), float32_sum)
    if device_dtype and kind in ("sum", "min", "max"):
        # this jax build runs the jitted segment programs (not membership)
        _assert_same(got, _jax(jmr.segment_reduce, values, codes, g, kind,
                               jit=True), float32_sum)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("kind", ["min", "max"])
def test_segment_extrema_empty_groups_hold_the_identity(kind, dtype,
                                                        monkeypatch):
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", 1)
    values = np.array([5, 7], dtype)
    codes = np.array([0, 0], np.int32)
    got = tmr.segment_reduce(values, codes, 3, kind, device="cpu")
    assert np.array_equal(got, _jax(jmr.segment_reduce, values, codes, 3,
                                    kind))
    assert got[1] == got[2] == tmr._identity(np.dtype(dtype), kind)


def test_segment_reduce_avg_returns_sums_and_counts(monkeypatch):
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", 1 << 30)
    values = np.array([10, 20, 30, 40], np.int64)
    codes = np.array([0, 1, 0, 1], np.int32)
    diffs = np.array([1, 1, 2, -1], np.int64)
    sums, counts = tmr.segment_reduce(values, codes, 2, "avg",
                                      weights=diffs, device="cpu")
    assert sums.tolist() == [70, -20]
    assert counts.tolist() == [3, 0]


def test_segment_reduce_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown segment_reduce kind"):
        tmr.segment_reduce(np.zeros(2, np.int32), np.zeros(2, np.int32), 1,
                           "median", device="cpu")


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [300, 3000])
def test_membership_equals_isin(n, dtype, monkeypatch):
    rng = np.random.default_rng(11)
    probe = rng.integers(0, 500, n).astype(dtype)
    build = rng.integers(0, 500, 120).astype(dtype)
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", CROSSOVER)
    before = tmr.STATS["member_device"]
    got = tmr.hash_join_membership(probe, build, device="cpu")
    assert (tmr.STATS["member_device"] > before) == (n >= CROSSOVER)
    assert got.dtype == bool and np.array_equal(got, np.isin(probe, build))
    assert got.sum() > 0  # the fixture actually exercises membership
    # the JAX package's numpy path (its device path needs enable_x64)
    assert np.array_equal(got, _jax(jmr.hash_join_membership, probe, build))
    assert not tmr.hash_join_membership(
        probe, np.array([], dtype), device="cpu").any()


def test_membership_dtype_rule_keeps_mixed_probes_on_numpy(monkeypatch):
    """Only int32/int64 probes of the build's own dtype reach the device."""
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", 1)
    probe = np.arange(2000, dtype=np.int64)
    before = dict(tmr.STATS)
    for build in (np.arange(0, 50, 3, dtype=np.int32),
                  np.arange(0, 50, 3).astype(np.float64)):
        got = tmr.hash_join_membership(probe, build, device="cpu")
        assert np.array_equal(got, np.isin(probe, build))
    assert tmr.STATS["member_device"] == before["member_device"]
    assert tmr.STATS["member_numpy"] == before["member_numpy"] + 2


def test_jit_map_equals_the_jax_package():
    def affine(x):
        return x * 3 + 1

    xs = np.arange(-8, 8, dtype=np.int32)
    got = tmr.jit_map(affine)(torch.from_numpy(xs))
    assert got.tolist() == np.asarray(jmr.jit_map(affine)(xs)).tolist()
    from pathway_tpu_torch.obs.profiler import registry

    assert any(r.program == "pw.map.affine" for r in registry().records())


def test_large_calls_record_both_sides(monkeypatch):
    """Each call of at least 4,096 elements records its wall time under
    the side that ran, in the JAX package's ``n<pow2>`` buckets."""
    values, codes, _w, g = _batch(5000, np.float32)
    for pin, side in ((1 << 30, "numpy"), (1, "jit")):
        monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", pin)
        tmr.segment_reduce(values, codes, g, "sum", device="cpu")
        tmr.hash_join_membership(codes, np.arange(10, dtype=np.int32),
                                 device="cpu")
        db = costdb.default_db()
        assert db.get(f"pw.reduce.segment_sum.{side}", "n8192") is not None
        assert db.get(f"pw.join.member.{side}", "n8192") is not None


# -- exchange consolidation -------------------------------------------------

def _exchange_batches():
    mixed = [(i, (f"w{i % 4}", 1), 1) for i in range(40)]
    mixed.insert(7, (999, ("fl", 1.5), 1))     # float sum value: raw
    mixed.insert(20, (998, ("un", [1]), 1))    # unhashable: raw
    return {
        "mixed": (mixed, ((1,),)),
        "distinct": ([(i, (f"w{i}", i), 1) for i in range(40)], ((1,),)),
        "cancelled": ([(i, ("w", 1), 1) for i in range(20)]
                      + [(100 + i, ("w", 1), -1) for i in range(20)], ((),)),
        "small": ([(i, ("w", 1), 1) for i in range(5)], ((1,),)),
    }


@pytest.mark.parametrize("name", sorted(_exchange_batches()))
def test_combine_for_exchange_equals_the_jax_package(name):
    ups, spec = _exchange_batches()[name]
    got = tmr.combine_for_exchange(list(ups), spec)
    assert got == jmr.combine_for_exchange(list(ups), spec)
    if name == "mixed":
        assert len(got) == 6  # 4 merged int rows + 2 raw passthroughs
        assert [u[0] for u in got if u[0] in (998, 999)] == [999, 998]
    if name == "cancelled":
        assert got == []
    if name in ("distinct", "small"):
        assert got is None


@pytest.mark.parametrize("spec", [
    None, ([0], [("count",), ("sum", 1), ("avg", 2), ("min", 3)]),
    ([0, 1], [("max", 2)]),
])
@pytest.mark.parametrize("key_fn", [None, len])
def test_exchange_combine_spec_equals_the_jax_package(spec, key_fn):
    op = types.SimpleNamespace(simple_spec=spec, key_fn=key_fn)
    assert tmr.exchange_combine_spec(op) == jmr.exchange_combine_spec(op)


# -- the planner's crossover ------------------------------------------------

@pytest.fixture
def db(tmp_path):
    d = CostDB(str(tmp_path / "planner.json"), flush_interval_s=3600.0)
    yield d
    d.shutdown()


def test_calibrate_on_the_cpu_records_both_sides(db):
    out = planner.calibrate_mapreduce(db, sizes=(4096, 16384), repeats=1,
                                      device="cpu")
    assert set(out) == {"numpy.n4096", "jit.n4096", "numpy.n16384",
                        "jit.n16384"}
    for side in ("numpy", "jit"):
        for n in (4096, 16384):
            assert db.get(f"pw.reduce.segment_sum.{side}", f"n{n}")
    # measured now — whatever the verdict, it is evidence, not a default
    assert planner.jit_crossover("pw.reduce.segment_sum", db=db).source \
        == "costdb"


def test_calibrate_at_the_default_device_raises_without_a_card(db,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.calibrate_mapreduce(db, sizes=(4096,), repeats=1)


def test_the_pin_wins_over_the_planner(monkeypatch):
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", 777)
    assert tmr.jit_min_elements() == 777
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", None)
    monkeypatch.setitem(planner._CROSSOVER_CACHE, "pw.reduce.segment_sum",
                        888)
    assert tmr.jit_min_elements() == 888
    from pathway_tpu_torch.engine import vectorize

    monkeypatch.setattr(vectorize, "DEVICE_THRESHOLD", 256)
    assert vectorize._device_threshold() == 256
    monkeypatch.setattr(vectorize, "DEVICE_THRESHOLD",
                        vectorize._DEVICE_THRESHOLD_DEFAULT)
    monkeypatch.setitem(planner._CROSSOVER_CACHE, "pw.map.vecplan", 4321)
    assert vectorize._device_threshold() == 4321


def test_the_env_pin_wins_and_is_reported(db, monkeypatch):
    monkeypatch.setenv("PW_MAPREDUCE_JIT_MIN", "12345")
    p = planner.plan(db=db, current_processes=1, n_devices=1)
    d = p.get("pw.reduce.segment_sum.jit_min")
    assert d.value == 12345 and d.source == "env"


def test_cached_crossover_refreshes_after_calibration(monkeypatch):
    """``cached_crossover`` memoizes the default of a fresh store; a
    calibration invalidates it, so the next read is the measured one."""
    monkeypatch.setattr(tmr, "_JIT_MIN_ELEMENTS", None)
    store = costdb.default_db()
    assert tmr.jit_min_elements() == tmr._JIT_MIN_DEFAULT
    for n, (jit_ms, np_ms) in {4096: (5.0, 1.0), 16384: (1.0, 4.0),
                               65536: (1.0, 9.0)}.items():
        store.observe("pw.reduce.segment_sum.jit", f"n{n}", ms=jit_ms)
        store.observe("pw.reduce.segment_sum.numpy", f"n{n}", ms=np_ms)
    # memoized: the new rows are not read until the cache is dropped
    assert tmr.jit_min_elements() == tmr._JIT_MIN_DEFAULT
    planner.calibrate_mapreduce(store, sizes=(1024,), repeats=1,
                                device="cpu")
    assert tmr.jit_min_elements() == 16384
