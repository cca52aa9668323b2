"""The port's native hash tier (``pathway_tpu_torch/native``) against the
JAX package's: every case of ``tests/test_native.py`` and the self-test
case of ``tests/test_advice_r2_fixes.py`` on the port, the compiled and
Python hashes of both packages bit-equal on seeded columns, the library
built from the copied source into ``pathway_tpu_torch/_build/``, and a
failed build or self-test raising (the JAX package falls back to Python
there)."""

from pathlib import Path

import numpy as np
import pytest

import pathway_tpu_torch as tpw
from pathway_tpu import native as jnative
from pathway_tpu_torch import native
from pathway_tpu_torch.engine.runner import run_tables
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.value import (
    _py_auto_keys_range,
    auto_row_keys,
    ref_scalar,
    ref_scalar_batch,
)

from .torch_parity import capture, fresh_port  # noqa: F401


def seeded_columns(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
            rng.standard_normal(n),
            ["".join(rng.choice(list("abcé✓ xyz"), int(rng.integers(0, 40))))
             for _ in range(n)],
            [bytes(rng.integers(0, 256, int(rng.integers(0, 20)),
                                dtype=np.uint8)) for _ in range(n)]]


# -- tests/test_native.py on the port -----------------------------------------

def test_hash128_deterministic():
    h1 = native.hash128(b"hello")
    assert h1 == native.hash128(b"hello")
    assert h1 != native.hash128(b"hellp")
    assert 0 < h1 < 2**128


def test_hash_rows_typed_columns():
    cols = [np.arange(100, dtype=np.int64), np.linspace(0, 1, 100),
            [f"s{i}" for i in range(100)]]
    keys = native.hash_rows(cols)
    assert len(set(keys)) == 100
    assert list(keys) == list(native.hash_rows(cols))


def test_consolidate_hashed():
    hi = np.array([1, 1, 2, 3], np.uint64)
    lo = np.array([7, 7, 8, 9], np.uint64)
    tag = np.array([0, 0, 0, 5], np.uint64)
    d = np.array([1, -1, 2, 1], np.int64)
    idx, nd = native.consolidate_hashed(hi, lo, tag, d)
    assert list(idx) == [2, 3]
    assert list(nd) == [2, 1]
    pidx, pnd = native._py_consolidate(hi, lo, tag, d)
    assert list(pidx) == list(idx) and list(pnd) == list(nd)


def test_io_auto_keys_use_native(tmp_path, fresh_port):
    """CSV ingest keys without a primary key go through ``hash_rows``:
    unique, stable across reads, and the JAX package's."""
    src = tmp_path / "in.csv"
    src.write_text("a\n" + "\n".join(str(i) for i in range(200)))

    def build(pw):
        class S(pw.Schema):
            a: int

        return pw.io.csv.read(str(src), schema=S, mode="static")

    s1, s2 = capture("torch", build)[0], capture("torch", build)[0]
    assert len(s1) == 200
    assert s1.keys() == s2.keys()
    assert s1 == capture("jax", build)[0]


def test_native_blake2b_tier_bit_identical():
    """pw_auto_row_keys / pw_ref_scalar_rows against the Python canonical
    hash (``internals/value.py``)."""
    his, los = native.auto_row_keys_hashes(0, 300)
    for i in (0, 1, 127, 128, 255, 299):
        assert ((int(his[i]) << 64) | int(los[i])) == int(
            ref_scalar("#row", i))
    ints = [0, 1, -1, 255, 256, -256, 2**31, -(2**31), 2**62, -(2**63)]
    assert ref_scalar_batch([np.asarray(ints, np.int64)]) == [
        ref_scalar(v) for v in ints]
    floats = [0.0, -0.0, 1.5, float("nan"), float("inf"), -3.14159]
    assert ref_scalar_batch([np.asarray(floats, np.float64)]) == [
        ref_scalar(v) for v in floats]
    strs = ["", "a", "hello world", "émoji ✓", "x" * 500]
    assert ref_scalar_batch([strs]) == [ref_scalar(v) for v in strs]
    assert ref_scalar_batch([strs, np.asarray(range(5), np.int64)]) == [
        ref_scalar(s, i) for i, s in enumerate(strs)]
    # a column type outside the tier's keys per row
    assert ref_scalar_batch([[1.5, "a"]]) is None


def test_pk_table_keys_match_pointer_from(fresh_port):
    """``table_from_rows`` primary-key keys (the batched tier) equal
    per-row ``ref_scalar``, and the JAX package's."""
    def build(pw):
        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        return pw.debug.table_from_rows(S, [("alpha", 1), ("beta", 2)])

    state = capture("torch", build)[0]
    assert set(state) == {ref_scalar("alpha"), ref_scalar("beta")}
    assert state == capture("jax", build)[0]


# -- tests/test_advice_r2_fixes.py:99-106 on the port ------------------------

def test_native_selftest_guards_adoption():
    assert native.get_lib() is not None
    data = b"the quick brown fox"
    assert native.hash128(data, 7) == native._py_hash128(data, 7)


# -- the two packages' hashes, bit for bit -----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_rows_equal_the_jax_packages(seed):
    cols = seeded_columns(seed, 257)
    got = list(native.hash_rows(cols, seed=seed))
    assert got == list(native._py_hash_rows(cols, seed=seed))
    assert got == list(jnative._py_hash_rows(cols, seed=seed))
    assert got == list(jnative.hash_rows(cols, seed=seed))


def test_hash128_and_blake2b_tier_equal_the_jax_packages():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert native.hash128(data, n) == jnative._py_hash128(data, n)
    ints, floats, strs, _ = seeded_columns(4, 129)
    mine = native.ref_scalar_rows_hashes([ints, floats, strs])
    theirs = jnative.ref_scalar_rows_hashes([ints, floats, strs])
    assert all((a == b).all() for a, b in zip(mine, theirs))
    assert auto_row_keys(5000) == _py_auto_keys_range(0, 5000)


# -- the build: where, and what a failure does -------------------------------

def test_the_library_builds_from_the_copied_source_into_build():
    assert native.SRC.read_bytes() == Path(
        jnative._SRC).read_bytes()  # the JAX package's source, byte for byte
    assert native.lib_path().parent == (
        Path(tpw.__file__).resolve().parent / "_build")
    lib = native.get_lib()
    assert Path(lib._name) == native.lib_path()
    assert not list(native.SRC.parent.glob("*.so"))


def test_a_library_built_for_another_cpu_is_not_reused(monkeypatch):
    here = native.lib_path()
    monkeypatch.setattr(native, "_host_cpu",
                        lambda: b"x86_64 flags\t: fpu sse2")
    assert native.lib_path() != here
    assert native.lib_path().parent == here.parent


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "pw_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        native.hash_rows([np.arange(3, dtype=np.int64)])
    assert not list((tmp_path / "build").glob("*.so"))


def test_a_failed_self_test_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_py_hash128", lambda data, seed=0: 1)
    with pytest.raises(RuntimeError, match="self-test"):
        native.get_lib()
    monkeypatch.undo()
    assert native.get_lib() is not None


def test_the_jsonlines_no_key_read_keys_rows_as_the_mirror(tmp_path,
                                                            fresh_port):
    """A no-key jsonlines read in the port carries ``_py_hash_rows``'
    keys over (index, file, content), as ``chip_smoke.py`` checks on the
    card."""
    import json

    path = tmp_path / "e.jsonl"
    rows = [{"k": i % 3, "v": f"x{i}"} for i in range(50)]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))

    class J(tpw.Schema):
        k: int
        v: str

    tpg.G.clear()
    [cap] = run_tables(tpw.io.jsonlines.read(str(path), schema=J,
                                             mode="static"), device="cpu")
    tpg.G.clear()
    want = native._py_hash_rows([
        np.arange(50, dtype=np.int64), [str(path)] * 50,
        [repr(sorted(r.items())) for r in rows]])
    assert cap.squash() == {tpw.Pointer(int(h)): (r["k"], r["v"])
                            for h, r in zip(want, rows)}
