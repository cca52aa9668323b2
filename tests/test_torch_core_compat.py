"""The core API's pure-Python remainder in the port against the JAX
package: the cases of ``tests/test_universes.py`` and
``tests/test_transformers.py`` built in both packages from the same rows
(captures equal key for key, ``tests/torch_parity.py``; a mix the
universe solver rejects raises in both), the compat names of
``pathway_tpu/__init__.py``, ``pw.load_yaml``, ``LiveTable``, the parquet
helpers and ``pw.demo``'s streams."""

import math
import threading

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import PACKAGES, capture, equal_to_jax, fresh_port  # noqa: F401

BASE = """
id | a
1 | 10
2 | 20
3 | 30
"""


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


# -- tests/test_universes.py ---------------------------------------------------
# (case, build(pw) -> the table the JAX test reads, or None;
#  reject(pw) -> the column mix the solver must refuse, or None)

def _filter_reads_parent(pw):
    t = _md(pw, BASE)
    return t.filter(t.a > 15).select(doubled=t.a * 2)


def _parent_reads_subset(pw):
    t = _md(pw, BASE)
    f = t.filter(t.a > 15).select(b=pw.this.a)
    return t.select(x=f.b)


def _intersect(pw):
    t = _md(pw, BASE)
    other = _md(pw, "id | z\n2 | 5\n3 | 6\n4 | 7")
    return t.intersect(other).select(s=t.a + other.z)


def _difference(pw, reject=False):
    t = _md(pw, BASE)
    other = _md(pw, "id | z\n3 | 6")
    d = t.difference(other)
    return d.select(v=other.z) if reject else d.select(v=t.a)


def _concat(pw, reject=False):
    a = _md(pw, "id | a\n1 | 10")
    b = _md(pw, "id | a\n2 | 20")
    pw.universes.promise_are_pairwise_disjoint(a, b)
    u = a.concat(b)
    return u.select(v=a.a) if reject else a.select(v=u.a)


def _update_rows(pw, reject=False):
    t = _md(pw, BASE)
    patch = _md(pw, "id | a\n3 | 99\n4 | 44")
    u = t.update_rows(patch)
    return u.select(v=t.a) if reject else t.select(v=u.a)


def _promise(pw, reject=False):
    t = _md(pw, BASE)
    f = t.filter(t.a > 0).select(b=pw.this.a)
    if reject:
        return t.select(x=f.b)
    t.promise_universes_are_equal(f)
    return t.select(x=f.b)


def _transitivity(pw):
    t = _md(pw, BASE)
    f1 = t.filter(t.a > 5)
    f2 = f1.filter(f1.a > 15)
    return f2.select(v=t.a)


def _join_parent(pw):
    t = _md(pw, "id | a | b\n1 | 10 | 7\n2 | 20 | 8")
    other = _md(pw, "id | c | v\n1 | 7 | 70\n2 | 8 | 80")
    f = t.filter(t.a > 15)
    return f.join(other, t.b == other.c).select(v=other.v)


def _subset_promise(pw, reject=False):
    big = _md(pw, BASE)
    small = _md(pw, "id | b\n1 | 100")
    small.promise_universe_is_subset_of(big)
    return big.select(v=small.b) if reject else small.select(v=big.a)


def _module_promises(pw):
    t = _md(pw, BASE)
    f = t.filter(t.a > 0).select(b=pw.this.a)
    pw.universes.promise_are_equal(t, f)
    small = _md(pw, "id | c\n2 | 1")
    pw.universes.promise_is_subset_of(small, t)
    return small.select(v=t.a + f.b)


UNIVERSES = {
    "filter_result_reads_parent_columns": (_filter_reads_parent, None,
                                           [(40,), (60,)]),
    "parent_cannot_read_subset_columns": (None, _parent_reads_subset, None),
    "intersect_is_subset_of_every_argument": (_intersect, None,
                                              [(25,), (36,)]),
    "difference_is_subset_of_left_only": (
        _difference, lambda pw: _difference(pw, True), [(10,), (20,)]),
    "concat_inputs_read_concat_columns": (
        _concat, lambda pw: _concat(pw, True), [(10,)]),
    "update_rows_union_superset": (
        _update_rows, lambda pw: _update_rows(pw, True),
        [(10,), (20,), (99,)]),
    "promise_overrides_structure": (
        _promise, lambda pw: _promise(pw, True), [(10,), (20,), (30,)]),
    "subset_transitivity": (_transitivity, None, [(20,), (30,)]),
    "join_condition_references_parent_of_side": (_join_parent, None,
                                                 [(80,)]),
    "subset_promise_is_one_way": (
        _subset_promise, lambda pw: _subset_promise(pw, True), [(10,)]),
    "module_promises": (_module_promises, None, [(40,)]),
}


@pytest.mark.parametrize("case", sorted(UNIVERSES))
def test_universe_case_equals_the_jax_packages(case, fresh_port,
                                               monkeypatch):
    build, reject, want = UNIVERSES[case]
    if build is not None:
        [state] = equal_to_jax(build, monkeypatch)
        assert sorted(state.values()) == want
    if reject is not None:
        for pkg in ("jax", "torch"):
            pw, _runner, pg = PACKAGES[pkg]
            pg.G.clear()
            with pytest.raises(ValueError, match="incompatible universe"):
                reject(pw)
            pg.G.clear()


# -- tests/test_transformers.py ------------------------------------------------

def _tree_sum(pw):
    t = pw.debug.table_from_markdown("""
      n | val | left | right
      1 | 1   | 2    | 3
      2 | 2   |      |
      3 | 3   | 4    |
      4 | 4   |      |
    """, id_from=["n"])
    t2 = t.select(
        val=t.val,
        left=pw.if_else(t.left.is_none(), None, t.pointer_from(t.left)),
        right=pw.if_else(t.right.is_none(), None, t.pointer_from(t.right)))

    @pw.transformer
    class tree_sum:
        class tree(pw.ClassArg):
            val: pw.input_attribute
            left: pw.input_attribute
            right: pw.input_attribute

            @pw.output_attribute
            def total(self) -> int:
                s = self.val
                if self.left is not None:
                    s += self.transformer.tree[self.left].total
                if self.right is not None:
                    s += self.transformer.tree[self.right].total
                return s

    return tree_sum(tree=t2).tree


def _intra_row(pw):
    t = pw.debug.table_from_markdown("""
        | a
      1 | 2
      2 | 5
    """)

    @pw.transformer
    class derive:
        class rows(pw.ClassArg):
            a: pw.input_attribute

            @pw.output_attribute
            def doubled(self) -> int:
                return self.a * 2

            @pw.output_attribute
            def plus_one(self) -> int:
                return self.doubled + 1

    return derive(rows=t).rows


def _method(pw):
    t = pw.debug.table_from_markdown("""
        | a
      1 | 3
    """)

    @pw.transformer
    class with_method:
        class rows(pw.ClassArg):
            a: pw.input_attribute

            @pw.method
            def times(self, k) -> int:
                return self.a * k

            @pw.output_attribute
            def six(self) -> int:
                return self.times(2)

    return with_method(rows=t).rows


TRANSFORMERS = {
    "transformer_tree_sum_pointer_chasing": (_tree_sum,
                                             [(2,), (4,), (7,), (10,)]),
    "transformer_intra_row_dependency": (_intra_row, [(4, 5), (10, 11)]),
    "transformer_method": (_method, None),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMERS))
def test_transformer_case_equals_the_jax_packages(case, fresh_port,
                                                  monkeypatch):
    build, want = TRANSFORMERS[case]
    [state] = equal_to_jax(build, monkeypatch)
    if want is not None:
        assert sorted(state.values()) == want


# -- the compat names ----------------------------------------------------------

def test_every_compat_name_resolves_and_not_ported_names_say_where():
    import re
    from pathlib import Path

    src = Path(jpw.__file__).read_text()
    block = src[src.index("from .internals import universes"):
                src.index("__version__")]
    names = {n for n in re.findall(r"\b([A-Za-z_]\w*)\b", block)
             if hasattr(jpw, n) and not n.startswith("_")}
    missing = sorted(n for n in names if not hasattr(tpw, n))
    assert missing == []
    public = [n for n in dir(jpw.viz) if not n.startswith("_")]
    assert all(hasattr(tpw.viz, n) for n in public), public
    assert tpw._NOT_PORTED == {}


def test_persistence_mode_is_the_ports_one_with_the_jax_values():
    from pathway_tpu.internals import compat as jcompat
    from pathway_tpu_torch import persistence
    from pathway_tpu_torch.internals import compat

    assert compat.PersistenceMode is persistence.PersistenceMode
    assert tpw.PersistenceMode is persistence.PersistenceMode
    assert ({m.name: m.value for m in tpw.PersistenceMode}
            == {m.name: m.value for m in jcompat.PersistenceMode})


def test_type_aliases_and_engine_types():
    assert ({m.name: m.value for m in tpw.Type}
            == {m.name: m.value for m in jpw.Type})
    for m in tpw.Type:
        assert repr(m.to_dtype()) == repr(jpw.Type[m.name].to_dtype())
    assert tpw.DateTimeNaive is jpw.DateTimeNaive
    assert tpw.Duration is jpw.Duration
    assert tpw.TableLike is tpw.Table and tpw.Joinable is tpw.Table
    assert tpw.OuterJoinResult is tpw.JoinResult
    assert tpw.GroupedJoinResult is tpw.GroupedTable


def test_py_object_wrapper_keys_as_the_jax_packages():
    from pathway_tpu.internals.value import ref_scalar as jref
    from pathway_tpu_torch.internals.value import ref_scalar as tref

    w, jw = tpw.wrap_py_object({"x": [1, 2]}), jpw.wrap_py_object(
        {"x": [1, 2]})
    assert repr(w) == repr(jw)
    assert tref(w) == jref(jw)


def _free_functions(pw):
    a = _md(pw, "id | k | v\n1 | 1 | 10\n2 | 2 | 20")
    b = _md(pw, "id | k | w\n1 | 1 | 5\n2 | 3 | 6")
    inner = pw.join_inner(a, b, a.k == b.k).select(a.v, b.w)
    left = pw.join_left(a, b, a.k == b.k).select(a.v, w=b.w)
    right = pw.join_right(a, b, a.k == b.k).select(v=a.v, w=b.w)
    outer = pw.join_outer(a, b, a.k == b.k).select(v=a.v, w=b.w)
    plain = pw.join(a, b, a.k == b.k).select(a.v)
    grouped = pw.groupby(a, a.k).reduce(a.k, n=pw.reducers.count())
    return inner, left, right, outer, plain, grouped


def _custom_accumulator(pw):
    class Sum2(pw.BaseCustomAccumulator):
        def __init__(self, s):
            self.s = s

        @classmethod
        def from_row(cls, row):
            return cls(row[0] * 2)

        def update(self, other):
            self.s += other.s

        def compute_result(self):
            return self.s

    t = _md(pw, "id | g | v\n1 | a | 1\n2 | a | 2\n3 | b | 5")
    return t.groupby(t.g).reduce(t.g, s=Sum2.reducer(t.v))


def _slices(pw):
    t = pw.debug.table_from_markdown("a | b | c\n1 | 2 | 3")
    return (t.select(*t.slice.without("c").with_suffix("_v")),
            t.select(*t.slice.rename({"a": "z"}).with_prefix("p_")),
            t.select(t.slice.b, t.slice["c"]))


def _schema_builder(pw):
    s = pw.schema_builder({"k": pw.column_definition(dtype=int,
                                                     primary_key=True),
                           "v": str},
                          properties=pw.SchemaProperties(append_only=True))
    return pw.debug.table_from_rows(s, [(1, "a"), (2, "b")])


def _iterate_universe(pw):
    t = _md(pw, "id | v\n1 | 1\n2 | 5")

    def step(t):
        return t.select(v=pw.if_else(t.v < 4, t.v + 1, t.v))

    return pw.iterate_universe(step, t=t)


def _table_transformer(pw):
    @pw.table_transformer
    def double(t):
        return t.select(v=t.v * 2)

    return double(_md(pw, "id | v\n1 | 21"))


COMPAT = {
    "free_join_and_groupby_functions": _free_functions,
    "custom_accumulator": _custom_accumulator,
    "table_slice": _slices,
    "schema_builder": _schema_builder,
    "iterate_universe": _iterate_universe,
    "table_transformer": _table_transformer,
}


@pytest.mark.parametrize("case", sorted(COMPAT))
def test_compat_case_equals_the_jax_packages(case, fresh_port, monkeypatch):
    states = equal_to_jax(COMPAT[case], monkeypatch,
                          tiers=("numpy", "device"))
    assert all(states)


def test_pandas_transformer_equals_the_jax_packages(fresh_port):
    def build(pw):
        class Out(pw.Schema):
            total: int

        @pw.pandas_transformer(output_schema=Out)
        def totals(df):
            import pandas as pd

            return pd.DataFrame({"total": [int(df["v"].sum())]},
                                index=["all"])

        return totals(_md(pw, "id | v\n1 | 3\n2 | 4"))

    [state] = capture("torch", build)
    assert list(state.values()) == [(7,)]
    assert [state] == capture("jax", build)


def test_schema_from_csv_equals_the_jax_packages(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("a,b,c\n1,2.5,x\n3,,y\n")
    got = tpw.schema_from_csv(str(p))
    want = jpw.schema_from_csv(str(p))
    assert got.column_names() == want.column_names() == ["a", "b", "c"]
    assert ({k: repr(v) for k, v in got.dtypes().items()}
            == {k: repr(v) for k, v in want.dtypes().items()})


def test_global_error_log_lists_the_runs_errors(fresh_port):
    from pathway_tpu_torch.engine import telemetry
    from pathway_tpu_torch.engine.runner import run_tables

    telemetry.global_error_log.clear()
    t = _md(tpw, "id | a | b\n1 | 1 | 0")
    run_tables(t.select(d=t.a // t.b), device="cpu")
    tpg.G.clear()
    [cap] = run_tables(tpw.global_error_log(), device="cpu")
    rows = list(cap.squash().values())
    assert len(rows) >= 1 and "ZeroDivision" in rows[0][0]
    assert tpw.local_error_log is tpw.global_error_log
    telemetry.global_error_log.clear()


# -- load_yaml ------------------------------------------------------------------

YAML = """
$n: 3
$dir: persist
backend: !pw.persistence.Backend.filesystem
  path: $dir
values: [$n, $FROM_ENV, 7]
nested:
  schema: !pw.schema_from_types
    a: !builtins.int
"""


def test_load_yaml_resolves_the_ports_names(monkeypatch):
    monkeypatch.setenv("FROM_ENV", "e")
    got = tpw.load_yaml(YAML)
    want = jpw.load_yaml(YAML)
    assert type(got["backend"]).__module__.startswith("pathway_tpu_torch.")
    assert type(got["backend"]).__name__ == type(want["backend"]).__name__
    assert got["values"] == want["values"] == [3, "e", 7]
    assert got["nested"]["schema"].column_names() == ["a"]
    with pytest.raises(KeyError, match="unresolved variable"):
        tpw.load_yaml("x: $NOT_SET_ANYWHERE_42")


# -- LiveTable ------------------------------------------------------------------

def test_live_table_snapshots_as_the_jax_packages(fresh_port):
    tpw.enable_interactive_mode()
    jpw.enable_interactive_mode()
    t = _md(tpw, BASE).select(b=tpw.this.a + 1)
    jt = _md(jpw, BASE).select(b=jpw.this.a + 1)
    live = t.live(device="cpu")
    assert isinstance(live, tpw.LiveTable)
    assert live.snapshot().squash() == jt.live().snapshot().squash()
    lines = repr(live).splitlines()
    assert lines[0] == "b" and sorted(lines[1:]) == ["11", "21", "31"]
    assert sorted(live.to_pandas()["b"]) == [11, 21, 31]
    assert "<table" in live._repr_html_()


# -- parquet --------------------------------------------------------------------

PARQUET_ROUNDTRIP = """
import json, sys
import pyarrow.parquet  # noqa: F401 - before torch or jaxlib is loaded
pkg, path = sys.argv[1], sys.argv[2]
if pkg == "torch":
    import pathway_tpu_torch as pw
    kw = {"device": "cpu"}
else:
    import pathway_tpu as pw
    kw = {}
t = pw.debug.table_from_markdown("a | b\\n1 | x\\n2 | y")
pw.debug.table_to_parquet(t, path, **kw)
df = pw.debug.table_to_pandas(pw.debug.table_from_parquet(path),
                              include_id=False, **kw)
print(json.dumps(sorted(zip(df["a"].tolist(), df["b"].tolist()))))
"""


def test_parquet_roundtrip_equals_the_jax_packages(tmp_path):
    """Each package's write and read in an interpreter of its own, with
    pyarrow loaded before the package: pyarrow's parquet reader has
    crashed pytest workers (and once this test's single interpreter,
    which loaded torch, jaxlib and then pyarrow) under the suite's load,
    never alone.  A crash names its signal and, through faulthandler,
    where it happened."""
    import json
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(tpw.__file__).resolve().parent.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    got = {}
    for pkg in ("torch", "jax"):
        proc = subprocess.run(
            [sys.executable, "-X", "faulthandler", "-c", PARQUET_ROUNDTRIP,
             pkg, str(tmp_path / f"{pkg}.parquet")],
            capture_output=True, text=True, env=env, timeout=300)
        how = (f"killed by {signal.Signals(-proc.returncode).name}"
               if proc.returncode < 0 else f"exit {proc.returncode}")
        assert proc.returncode == 0, f"{pkg}: {how}\n{proc.stderr[-4000:]}"
        got[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["torch"] == got["jax"] == [[1, "x"], [2, "y"]]


# -- demo -----------------------------------------------------------------------

def _stream_rows(pw, make, **run_kw):
    """Rows of a demo stream, as its subscriber sees them, in one run."""
    pg = PACKAGES["torch" if pw is tpw else "jax"][2]
    pg.G.clear()
    t = make(pw)
    rows = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            rows.append((key, tuple(sorted(row.items())), is_addition))

    pw.io.subscribe(t, on_change=on_change)
    if pw is tpw:
        run_kw["device"] = "cpu"
    pw.run(idle_stop_s=0.8, timeout_s=20, **run_kw)
    pg.G.clear()
    return sorted(rows)


DEMOS = {
    "range_stream": lambda pw: pw.demo.range_stream(nb_rows=6,
                                                    input_rate=500),
    "noisy_linear_stream": lambda pw: pw.demo.noisy_linear_stream(
        nb_rows=5, input_rate=500),
    "generate_custom_stream": lambda pw: pw.demo.generate_custom_stream(
        {"x": lambda i: i * i, "y": lambda i: f"r{i}"},
        schema=pw.schema_from_types(x=int, y=str), nb_rows=4,
        input_rate=500),
}


@pytest.mark.parametrize("case", sorted(DEMOS))
def test_demo_stream_equals_the_jax_packages(case, fresh_port):
    got = _stream_rows(tpw, DEMOS[case])
    want = _stream_rows(jpw, DEMOS[case])
    if case == "noisy_linear_stream":  # seeded per process: shapes only
        assert [(r[0], [c for c, _v in r[1]]) for r in got] == [
            (r[0], [c for c, _v in r[1]]) for r in want]
        assert all(math.isfinite(v) for r in got for _c, v in r[1])
    else:
        assert got == want and len(got) > 0


def test_demo_replay_csv_and_with_time(tmp_path, fresh_port):
    p = tmp_path / "t.csv"
    p.write_text("ts,v\n0,a\n0,b\n2,c\n")

    def replay(pw):
        class S(pw.Schema):
            ts: int
            v: str

        return pw.demo.replay_csv(str(p), schema=S, input_rate=500)

    def with_time(pw):
        class S(pw.Schema):
            ts: int
            v: str

        return pw.demo.replay_csv_with_time(str(p), schema=S,
                                            time_column="ts", unit="s",
                                            speedup=20)

    for make in (replay, with_time):
        got = _stream_rows(tpw, make)
        assert got == _stream_rows(jpw, make)
        assert sorted(dict(r[1])["v"] for r in got) == ["a", "b", "c"]


def test_demo_generate_custom_stream_validates_nb_rows():
    with pytest.raises(ValueError):
        tpw.demo.generate_custom_stream(
            {"v": lambda i: i}, schema=tpw.schema_from_types(v=int),
            nb_rows=-3)
