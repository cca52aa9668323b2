"""``pw.io.fs.read`` of the port against the JAX package's, and the file
source's streaming mode in the port's ``pw.run``.

Static mode: the same ``tmp_path`` files read by both packages give the
same rows key for key (the metadata's times masked), for ``binary``, ``plaintext``
and ``plaintext_by_file``, with and without ``with_metadata``, and for
``csv`` and ``json`` with a schema.
Streaming mode: a file written while the run is live appears, and a
deleted file's rows are retracted; each is waited for on an event the
subscriber sets, with a bounded wait, and the run ends by its idle
window.
"""

import os
import threading

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.internals import parse_graph as tpg

FILES = {"a.txt": "first line\nsecond line\n",
         "sub/b.md": "# title\n\nbody text é\n",
         "c.bin": "only line"}
TIMES = ("modified_at", "created_at", "seen_at")


@pytest.fixture
def files(tmp_path):
    root = tmp_path / "docs"
    for name, text in FILES.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    jpg.G.clear()
    tpg.G.clear()
    yield root
    jpg.G.clear()
    tpg.G.clear()


def _rows(cap) -> list:
    """(key, row) pairs, the metadata's times masked: keys compared too."""
    out = []
    for key, row in cap.squash().items():
        row = list(row)
        if len(row) > 1:
            meta = dict(row[1].value)
            for t in TIMES:
                assert isinstance(meta.pop(t), int)
            row[1] = meta
        out.append((key, tuple(row)))
    return sorted(out, key=repr)


@pytest.mark.parametrize("with_metadata", [False, True])
@pytest.mark.parametrize("fmt", ["binary", "plaintext", "plaintext_by_file"])
def test_static_read_gives_the_jax_rows(files, fmt, with_metadata):
    out = {}
    for pkg, pw, runner in (("jax", jpw, jrunner), ("torch", tpw, trunner)):
        t = pw.io.fs.read(str(files), format=fmt, mode="static",
                          with_metadata=with_metadata)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        [cap] = runner.run_tables(t, **kw)
        out[pkg] = _rows(cap)
    assert out["torch"] == out["jax"]
    n_lines = {"binary": 3, "plaintext_by_file": 3, "plaintext": 6}[fmt]
    assert len(out["torch"]) == n_lines


def test_csv_and_json_formats_raise_naming_the_format(tmp_path):
    """Named for what it checked before ``io.csv`` and ``io.jsonlines``
    were ported (that both formats raised): ``format="csv"`` and
    ``"json"`` now read through them and give the JAX package's rows,
    keyed by the schema's primary key."""
    (tmp_path / "t.csv").write_text("k,w\n1,a\n2,b\n")
    (tmp_path / "t.jsonl").write_text('{"k": 1, "w": "a"}\n{"k": 2, "w": "b"}\n')
    for fmt, name in (("csv", "t.csv"), ("json", "t.jsonl")):
        out = {}
        for pkg, pw, runner in (("jax", jpw, jrunner), ("torch", tpw, trunner)):
            class S(pw.Schema):
                k: int = pw.column_definition(primary_key=True)
                w: str

            t = pw.io.fs.read(str(tmp_path / name), format=fmt, schema=S,
                              mode="static")
            kw = {"device": "cpu"} if pkg == "torch" else {}
            [cap] = runner.run_tables(t, **kw)
            out[pkg] = cap.squash()
        assert out["torch"] == out["jax"], fmt
        assert sorted(out["torch"].values()) == [(1, "a"), (2, "b")]


def test_streaming_read_sees_a_new_file_and_a_deletion(tmp_path):
    root = tmp_path / "live"
    root.mkdir()
    (root / "a.txt").write_text("alpha")
    tpg.G.clear()
    seen: dict = {}
    events = {name: threading.Event() for name in ("a", "b", "a_gone")}

    def on_change(key, row, time, is_addition):
        name = os.path.basename(row["_metadata"].value["path"])
        seen.setdefault(name, []).append((row["data"], is_addition))
        if name == "a.txt":
            events["a" if is_addition else "a_gone"].set()
        else:
            events["b"].set()

    t = tpw.io.fs.read(str(root), format="binary", mode="streaming",
                       with_metadata=True)
    tpw.io.subscribe(t, on_change=on_change)

    def writer():
        assert events["a"].wait(10)
        (root / "b.txt").write_text("beta")
        assert events["b"].wait(10)
        os.remove(root / "a.txt")

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    tpw.run(device="cpu", timeout_s=10.0, idle_stop_s=3.0)
    th.join(timeout=10)
    tpg.G.clear()
    assert not th.is_alive()
    assert events["a_gone"].is_set()
    assert seen == {"a.txt": [(b"alpha", True), (b"alpha", False)],
                    "b.txt": [(b"beta", True)]}
