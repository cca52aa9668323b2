"""The port's columnar data plane against the JAX package's (the mirror
of tests/test_dataplane.py).

The same seeded rows run through both packages' engines; every
comparison captures ``run_tables(...)[i].squash()`` and asserts the
captures are EQUAL, keys included.  The port runs three tiers — numpy,
the device tier (on the CPU here, the crossover pinned to 256) and the
row path — against the JAX package's numpy tier and row path (its own
device tier does not run on this CPU-only build).  ``STATS`` shows which
tier ran.
"""

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.engine import vectorize as jvec
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine import operators as tops
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.engine import vectorize as tvec
from pathway_tpu_torch.engine.columnar import ColumnarBatch
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.trace import EngineErrorWithTrace
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.parallel import mapreduce as tmr

PACKAGES = {"jax": (jpw, jrunner, jvec, jpg), "torch": (tpw, trunner, tvec, tpg)}


@pytest.fixture(autouse=True)
def _fresh_port(tmp_path, monkeypatch):
    """A cost store of the test's own and empty parse graphs."""
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    tpg.G.clear()
    yield
    tpg.G.clear()
    costdb.shutdown()
    planner.invalidate_cache()


def _schema(pw):
    class S(pw.Schema):
        g: str
        a: int
        b: float

    return S


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 20, n)
    a = rng.integers(0, 1000, n)
    b = rng.random(n)
    return [(f"g{int(x)}", int(y), float(z)) for x, y, z in zip(g, a, b)]


def _pipeline(pw, rows):
    t = pw.debug.table_from_rows(_schema(pw), rows)
    # b * 0.5 and a * 0.1: a float constant beside an int column must stay
    # float64 on the device (torch would promote to float32)
    t2 = t.select(g=t.g, x=t.a * 2 + 1, y=t.b * 0.5, z=t.a * 0.1)
    t3 = t2.filter(t2.x > 400)
    return t3.groupby(t3.g).reduce(
        t3.g, s=pw.reducers.sum(t3.x), mn=pw.reducers.min(t3.y),
        mx=pw.reducers.max(t3.x), c=pw.reducers.count(),
        zs=pw.reducers.sum(t3.z), av=pw.reducers.avg(t3.y),
    )


def _reset_stats():
    tvec.STATS.update(np_batches=0, device_batches=0, row_batches=0,
                      h2d_bytes=0, d2h_bytes=0, device_ms=0.0)


def _capture(pkg, build, tier, monkeypatch, **kw):
    """``build(pw)``'s captures on one package and tier: ``numpy``, ``row``
    or (the port only) ``device``."""
    pw, runner, vec, pg = PACKAGES[pkg]
    with monkeypatch.context() as m:
        if tier == "row":
            m.setattr(vec, "compile_plan", lambda *a, **k: None)
            m.setattr(runner, "_groupby_simple_spec", lambda *a, **k: None)
        if pkg == "torch":
            m.setattr(tvec, "DEVICE_THRESHOLD",
                      256 if tier == "device" else 1 << 40)
            m.setattr(tmr, "_JIT_MIN_ELEMENTS",
                      256 if tier == "device" else 1 << 40)
            kw.setdefault("device", "cpu")
        pg.G.clear()
        out = build(pw)
        outs = out if isinstance(out, tuple) else (out,)
        caps = runner.run_tables(*outs, **kw)
        pg.G.clear()
    return [_errors_named(c.squash()) for c in caps]


def _errors_named(state):
    """Each package's ``Error`` singleton as one name, so that poisoned
    cells compare across the packages."""
    return {
        k: tuple("<Error>" if type(v).__name__ == "Error" else v for v in row)
        for k, row in state.items()
    }


@pytest.mark.parametrize("ref", ["numpy", "row"])
@pytest.mark.parametrize("tier", ["numpy", "device", "row"])
def test_pipeline_tiers_equal_the_jax_package(tier, ref, monkeypatch):
    rows = _rows(4000, seed=5)
    expected = _capture("jax", lambda pw: _pipeline(pw, rows), ref,
                        monkeypatch)
    _reset_stats()
    got = _capture("torch", lambda pw: _pipeline(pw, rows), tier,
                   monkeypatch)
    assert got == expected
    if tier == "numpy":
        assert tvec.STATS["np_batches"] >= 2  # select + filter vectorized
        assert tvec.STATS["device_batches"] == 0
    elif tier == "device":
        assert tvec.STATS["device_batches"] >= 2, tvec.STATS
        assert tvec.STATS["np_batches"] == 0
    else:
        assert tvec.STATS["np_batches"] == tvec.STATS["device_batches"] == 0
    if tier != "row":
        assert tvec.STATS["row_batches"] == 0


def test_float_constant_times_int_column_stays_float64(monkeypatch):
    """The promotion trap: ``a * 0.1`` is float64 on every tier and equal
    to the row interpreter's bit for bit."""
    rows = [(f"g{i % 3}", 7 + 13 * i, 0.5) for i in range(600)]

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows)
        return t.select(z=t.a * 0.1, w=0.3 * t.a + t.b)

    row = _capture("torch", build, "row", monkeypatch)
    for tier in ("numpy", "device"):
        assert _capture("torch", build, tier, monkeypatch) == row
    assert row == _capture("jax", build, "row", monkeypatch)
    vals = {r[0] for r in row[0].values()}
    assert vals == {a * 0.1 for _g, a, _b in rows}
    # what the trap would give: the float32 product differs
    assert {float(np.float32(a) * np.float32(0.1)) for _g, a, _b in rows} \
        != vals


# expressions whose operands part torch from numpy: each tier of the port
# must equal the same tier of the JAX package
_OPERAND_CASES = {
    "bool_plus_bool": lambda pw, t: (t.a > 500) + (t.a > 700),
    "bool_times_int": lambda pw, t: (t.a > 500) * 3,
    "neg_of_bool": lambda pw, t: -(t.a > 500),
    "invert_bool": lambda pw, t: ~(t.a > 500),
    "invert_int": lambda pw, t: ~t.a,
    "neg_int": lambda pw, t: -t.a + 1,
    "if_else_int_cond": lambda pw, t: pw.if_else(t.a % 2 == 0, t.a, 2.5),
    "if_else_consts": lambda pw, t: pw.if_else(t.a > 400, 1, 2.5),
    "if_else_bool_int": lambda pw, t: pw.if_else(t.a > 400, t.a > 600, 1),
    "cast_float": lambda pw, t: pw.cast(float, t.a) * 0.7,
    "cast_int_of_float": lambda pw, t: pw.cast(int, t.b * 100.0),
    "float_and": lambda pw, t: t.b & 1,
    "int_xor": lambda pw, t: (t.a ^ 5) | 1,
    "compare_mixed": lambda pw, t: t.a * 0.001 < t.b,
    "coalesce_col": lambda pw, t: pw.coalesce(t.a, 3) - 2,
}


@pytest.mark.parametrize("case", sorted(_OPERAND_CASES))
def test_operand_rules_equal_the_jax_package(case, monkeypatch):
    rows = _rows(700, seed=11)

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows)
        return t.select(v=_OPERAND_CASES[case](pw, t))

    jnp_ = _capture("jax", build, "numpy", monkeypatch)
    jrow = _capture("jax", build, "row", monkeypatch)
    assert _capture("torch", build, "numpy", monkeypatch) == jnp_
    assert _capture("torch", build, "device", monkeypatch) == jnp_
    assert _capture("torch", build, "row", monkeypatch) == jrow


def test_columnar_batch_flows_between_operators(monkeypatch):
    """The filter must receive a ColumnarBatch from select (no re-extract),
    on the device tier too."""
    seen = []
    orig = tops.StatelessFilter.process

    def spy(self, port, updates, time):
        seen.append(type(updates).__name__)
        return orig(self, port, updates, time)

    monkeypatch.setattr(tops.StatelessFilter, "process", spy)
    rows = _rows(2000)
    _capture("torch", lambda pw: _pipeline(pw, rows), "numpy", monkeypatch)
    _capture("torch", lambda pw: _pipeline(pw, rows), "device", monkeypatch)
    assert seen == ["ColumnarBatch", "ColumnarBatch"]


def test_groupby_minmax_with_retractions(monkeypatch):
    """Factorized min/max must honor multiset retraction semantics."""
    rows = []
    for i in range(3000):
        rows.append((f"g{i % 4}", i % 50, float(i % 30), 0, 1))
    for i in range(3000):
        if i % 50 == 0:
            rows.append((f"g{i % 4}", i % 50, float(i % 30), 2, -1))

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows, is_stream=True)
        return t.groupby(t.g).reduce(
            t.g, mn=pw.reducers.min(t.a), mx=pw.reducers.max(t.a),
            s=pw.reducers.sum(t.a),
        )

    expected = _capture("jax", build, "numpy", monkeypatch)
    for tier in ("numpy", "device", "row"):
        assert _capture("torch", build, tier, monkeypatch) == expected


def test_method_call_vectorizes_on_the_host(monkeypatch):
    """.str method calls lower to a fused column map on the numpy tier
    (never the device) and equal the JAX package's."""
    rows = [(f"word{i}", i, float(i)) for i in range(300)]

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows)
        return t.select(u=t.g.str.upper(), n=t.g.str.len(), x=t.a + 1)

    expected = _capture("jax", build, "numpy", monkeypatch)
    _reset_stats()
    assert _capture("torch", build, "device", monkeypatch) == expected
    # the string outputs ran on numpy beside the device's numeric one
    assert tvec.STATS["device_batches"] == 1
    assert tvec.STATS["row_batches"] == 0


def test_columnar_batch_compat_protocol():
    cb = ColumnarBatch([1, 2, 3], [[10, 20, 30], ["a", "b", "c"]], [1, 1, -1])
    assert len(cb) == 3
    assert list(cb) == [(1, (10, "a"), 1), (2, (20, "b"), 1), (3, (30, "c"), -1)]
    assert cb[1] == (2, (20, "b"), 1)
    arr = cb.np_col(0)
    assert arr.dtype == np.int64
    sel = cb.select_mask(np.array([True, False, True]))
    assert list(sel) == [(1, (10, "a"), 1), (3, (30, "c"), -1)]
    assert 0 in sel._np_cache


def test_np_col_type_rules():
    assert ColumnarBatch([1], [[True]], [1]).np_col(0) is None  # bool bails
    assert ColumnarBatch([1], [[None]], [1]).np_col(0) is None
    assert ColumnarBatch([1], [[1, 2.5]], [1, 1]).np_col(0) is None  # mixed
    assert ColumnarBatch([1], [[2**50]], [1]).np_col(0) is None  # leaf bound
    s = ColumnarBatch([1], [["x", "y"]], [1, 1]).np_col(0)
    assert s.dtype == object


@pytest.mark.parametrize("tier", ["numpy", "device"])
def test_int_overflow_falls_back_exact(tier, monkeypatch):
    """Ints beyond the leaf bound take the row path and stay exact."""
    rows = [("g", 2**60, 0.0)] * 300

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows)
        return t.select(x=t.a + t.a)

    [got] = _capture("torch", build, tier, monkeypatch)
    assert all(r[0] == 2**61 for r in got.values())
    assert [got] == _capture("jax", build, "numpy", monkeypatch)


def test_is_none_over_method_call_equals_the_jax_package(monkeypatch):
    rows = [(str(i) if i % 3 else f"x{i}", i, 0.0) for i in range(300)]

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), rows)
        p = t.g.str.parse_int(optional=True)
        return t.select(flag=p.is_none(), filled=pw.coalesce(p, -1))

    expected = _capture("jax", build, "numpy", monkeypatch)
    for tier in ("numpy", "device", "row"):
        assert _capture("torch", build, tier, monkeypatch) == expected
    flags = [v[0] for v in expected[0].values()]
    assert flags.count(True) == 100


@pytest.mark.parametrize("tier", ["numpy", "device"])
def test_division_by_zero_poisons_even_vectorized(tier, monkeypatch):
    rows = [(i, i % 50) for i in range(500)]  # ten zero divisors

    def build(pw):
        t = pw.debug.table_from_rows(_int_schema(pw), rows)
        return t.select(q=pw.fill_error(t.a / t.b, -1.0),
                        r=pw.fill_error(t.a // t.b, -1))

    [got] = _capture("torch", build, tier, monkeypatch)
    res = list(got.values())
    assert sum(1 for (q, _r) in res if q == -1.0) == 10
    assert not any(q != q or q == float("inf") for (q, _r) in res)
    assert [got] == _capture("jax", build, "numpy", monkeypatch)


def _int_schema(pw):
    class SD(pw.Schema):
        a: int
        b: int

    return SD


def test_a_device_failure_raises(monkeypatch):
    """No handler stands between a device program and the run: a device
    tier that fails takes the run down (wrapped with the operator's
    trace), it does not fall back to numpy."""
    def broken(a, b):
        raise RuntimeError("device fault")

    rows = _rows(600)
    monkeypatch.setattr(torch.Tensor, "__mul__", broken)
    with pytest.raises(EngineErrorWithTrace, match="device fault"):
        _capture("torch", lambda pw: _pipeline(pw, rows), "device",
                 monkeypatch)


def test_device_tier_below_the_crossover_is_numpy(monkeypatch):
    """The crossover is a size rule: a batch under it runs numpy even on
    the device tier's runner."""
    rows = _rows(200)
    _reset_stats()
    with monkeypatch.context() as m:
        m.setattr(tvec, "DEVICE_THRESHOLD", 4096)
        tpg.G.clear()
        [cap] = trunner.run_tables(_pipeline(tpw, rows), device="cpu")
    assert tvec.STATS["device_batches"] == 0
    assert tvec.STATS["np_batches"] >= 2
    assert [cap.squash()] == _capture("jax", lambda pw: _pipeline(pw, rows),
                                      "numpy", monkeypatch)


def _product(pw, rows, form):
    t = pw.debug.table_from_rows(_schema(pw), rows)
    z = t.a * t.b if form == "bare" else pw.cast(float, t.a) * t.b
    return t.select(x=t.a * 2 + 1, z=z)


@pytest.mark.parametrize("form", ["bare", "cast"])
def test_int_column_times_column_bound_equals_the_jax_package(form,
                                                              monkeypatch):
    """The static int64 bound takes every column for an int of up to
    2^44, so ``a * b`` of two columns (2^88) sends the whole select to
    the row interpreter in both packages; ``cast(float, a) * b`` gives
    the same values and vectorizes (the form ``chip_smoke.py`` phase 4i
    uses)."""
    rows = _rows(600, seed=2)
    jvec.STATS.update(np_batches=0, row_batches=0)
    expected = _capture("jax", lambda pw: _product(pw, rows, form), "numpy",
                        monkeypatch)
    _reset_stats()
    assert _capture("torch", lambda pw: _product(pw, rows, form), "device",
                    monkeypatch) == expected
    if form == "bare":
        assert jvec.STATS["row_batches"] == tvec.STATS["row_batches"] == 1
        assert tvec.STATS["device_batches"] == 0
    else:
        assert jvec.STATS["np_batches"] == tvec.STATS["device_batches"] == 1
    other = "cast" if form == "bare" else "bare"
    assert _capture("torch", lambda pw: _product(pw, rows, other), "row",
                    monkeypatch) == expected
