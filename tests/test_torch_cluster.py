"""The port's multi-process cluster (``parallel/cluster.py`` over
``parallel/comm.py``, spawned by ``python -m pathway_tpu_torch spawn``)
against the JAX package: ``tests/test_cluster.py``'s cases.  Each program
runs once in this interpreter under the JAX package, single-process (the
reference), and under the port's supervisor in the shape under test; the
squashed sinks must be equal.  The spawned scripts run their data plane
with ``pw.run(device="cpu")``.  Plus the port's own: a child asked for
the card on a host without one raises, and the supervisor fails."""

import textwrap
from pathlib import Path

import pytest

from .torch_cluster import hard_alarm, run_in_process, spawn_cluster, squash_jsonl

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


@pytest.fixture(autouse=True)
def _hard_timeout():
    with hard_alarm(240):
        yield


def _script(tmp: Path, name: str, body: str) -> Path:
    s = tmp / f"{name}.py"
    s.write_text("import pathway_tpu_torch as pw\n" + textwrap.dedent(body))
    return s


def _wordcount(tmp: Path, inp: Path, out: Path, run='pw.run(device="cpu")'):
    return _script(tmp, f"app_{out.stem}", f"""
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
        {run}
    """)


def _against_jax(tmp: Path, make, processes: int, threads: int = 1,
                 key_cols=("word", "count"), **spawn_kw) -> dict:
    """``make(out)`` -> script; the JAX package's in-process output and
    the port's spawned output, squashed, must be equal.  Returns it."""
    ref = tmp / "ref.jsonl"
    run_in_process(make(ref), "jax")
    out = tmp / "out.jsonl"
    spawn_cluster(make(out), processes=processes, threads=threads,
                  **spawn_kw)
    want = squash_jsonl(ref, key_cols)
    assert squash_jsonl(out, key_cols) == want
    return want


@pytest.mark.parametrize("processes", [2, 4])
def test_cluster_wordcount_matches_single(tmp_path, processes):
    inp = tmp_path / "input.csv"
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    lines = [" ".join(words[(i + j) % len(words)] for j in range(3))
             for i in range(200)]
    inp.write_text("line\n" + "\n".join(f'"{l}"' for l in lines) + "\n")
    got = _against_jax(tmp_path, lambda out: _wordcount(tmp_path, inp, out),
                       processes=processes)
    assert len(got) == len(words)


def test_cluster_threads_and_processes(tmp_path):
    inp = tmp_path / "input.csv"
    inp.write_text("line\n" + "\n".join(
        f'"w{i % 17} w{i % 5} common"' for i in range(100)) + "\n")
    # `spawn -n 2 -t 2 app.py`: the script alone, run by this interpreter
    got = _against_jax(tmp_path, lambda out: _wordcount(tmp_path, inp, out),
                       processes=2, threads=2, bare=True)
    assert sum(c for (_w, c) in got) == 300


def test_cluster_streaming_partitioned_files(tmp_path):
    """Streaming fs source: files partitioned across processes, counts
    exchanged by key, output written once on process 0."""
    data = tmp_path / "data"
    data.mkdir()
    words = ["red", "green", "blue", "cyan"]
    for f in range(6):
        (data / f"part{f}.txt").write_text(
            "\n".join(words[(f + i) % len(words)] for i in range(20)) + "\n")

    def make(out):
        return _script(tmp_path, f"app_{out.stem}", f"""
            t = pw.io.plaintext.read({str(data)!r} + "/*.txt",
                                     mode="streaming")
            counts = t.groupby(t.data).reduce(
                word=t.data, count=pw.reducers.count()
            )
            pw.io.jsonlines.write(counts, {str(out)!r})
            pw.run(idle_stop_s=1.5, device="cpu")
        """)

    net = _against_jax(tmp_path, make, processes=2, timeout=180)
    total = {w: 0 for w in words}
    for (w, c), mult in net.items():
        assert mult == 1
        total[w] += c
    assert all(v == 30 for v in total.values()), total


def test_cluster_join_groupby(tmp_path):
    """Join + groupby across an exchange boundary, on three processes."""
    left = tmp_path / "left.csv"
    right = tmp_path / "right.csv"
    left.write_text("k,v\n" + "\n".join(
        f"k{i % 7},{i}" for i in range(50)) + "\n")
    right.write_text("k,w\n" + "\n".join(
        f"k{i},{i * 100}" for i in range(7)) + "\n")

    def make(out):
        return _script(tmp_path, f"app_{out.stem}", f"""
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
                j.k, total=pw.reducers.sum(j.v), w=pw.reducers.max(j.w)
            )
            pw.io.jsonlines.write(agg, {str(out)!r})
            pw.run(device="cpu")
        """)

    got = _against_jax(tmp_path, make, processes=3,
                       key_cols=("k", "total", "w"))
    assert len(got) == 7


def test_cluster_pinned_live_source_ships_rows(tmp_path):
    """A live source without set_partition is read only by process 0,
    which must SHIP non-owned rows to their owners — not drop them."""
    def make(out):
        return _script(tmp_path, f"app_{out.stem}", f"""
            class Subject(pw.io.python.ConnectorSubject):
                def run(self):
                    for i in range(40):
                        self.next(k=f"key{{i % 8}}", v=i)

            class S(pw.Schema):
                k: str
                v: int

            t = pw.io.python.read(Subject(), schema=S)
            agg = t.groupby(t.k).reduce(t.k, total=pw.reducers.sum(t.v))
            pw.io.jsonlines.write(agg, {str(out)!r})
            pw.run(idle_stop_s=1.5, device="cpu")
        """)

    net = _against_jax(tmp_path, make, processes=2, key_cols=("k", "total"),
                       timeout=180)
    expect = {}
    for i in range(40):
        expect[f"key{i % 8}"] = expect.get(f"key{i % 8}", 0) + i
    assert {k: t for (k, t) in net} == expect


def test_cluster_skewed_partition_no_deadlock(tmp_path):
    """Streaming tick where only one process's files have data: idle
    processes must still take part in the drain protocol."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "only.txt").write_text(
        "\n".join(f"w{i % 3}" for i in range(30)) + "\n")

    def make(out):
        return _script(tmp_path, f"app_{out.stem}", f"""
            t = pw.io.plaintext.read({str(data)!r} + "/*.txt",
                                     mode="streaming")
            counts = t.groupby(t.data).reduce(word=t.data,
                                              count=pw.reducers.count())
            pw.io.jsonlines.write(counts, {str(out)!r})
            pw.run(idle_stop_s=1.5, device="cpu")
        """)

    net = _against_jax(tmp_path, make, processes=2, timeout=180)
    assert sum(c for (_w, c), m in net.items() if m) == 30


def test_cluster_persistence_no_duplication(tmp_path):
    """Cluster + persistence: re-running over the same static input must
    not double-ingest (per-process journals ``{stream}__p{pid}``, union
    replay injected by process 0, ownership filter)."""
    inp = tmp_path / "in.csv"
    inp.write_text("k,v\n" + "\n".join(
        f"k{i % 3},{i}" for i in range(30)) + "\n")
    pdir = tmp_path / "pstore"

    def make(out, store=pdir):
        return _script(tmp_path, f"app_{out.stem}", f"""
            class S(pw.Schema):
                k: str
                v: int

            t = pw.io.csv.read({str(inp)!r}, schema=S, mode="static")
            agg = t.groupby(t.k).reduce(t.k, total=pw.reducers.sum(t.v))
            pw.io.jsonlines.write(agg, {str(out)!r})
            pw.run(device="cpu", persistence_config=pw.persistence.Config(
                pw.persistence.Backend.filesystem({str(store)!r})))
        """)

    ref = tmp_path / "ref.jsonl"
    run_in_process(make(ref, tmp_path / "jax_store"), "jax")
    out1 = tmp_path / "o1.jsonl"
    out2 = tmp_path / "o2.jsonl"
    spawn_cluster(make(out1), processes=2)
    journals = sorted(p.name for p in pdir.rglob("*__p*"))
    assert any("__p0" in n for n in journals), journals
    assert any("__p1" in n for n in journals), journals
    spawn_cluster(make(out2), processes=2)
    want = squash_jsonl(ref, ("k", "total"))
    assert squash_jsonl(out1, ("k", "total")) == want
    assert squash_jsonl(out2, ("k", "total")) == want
    expect = {}
    for i in range(30):
        expect[f"k{i % 3}"] = expect.get(f"k{i % 3}", 0) + i
    assert {k: t for (k, t) in want} == expect


def test_cluster_child_without_a_card_raises(tmp_path):
    """A spawned child asked for the card (``device="cuda"``) on a host
    without one raises before it joins the mesh, and the supervisor exits
    non-zero: no process falls back to the CPU."""
    import torch

    assert not torch.cuda.is_available()
    inp = tmp_path / "input.csv"
    inp.write_text('line\n"a b"\n')
    out = tmp_path / "out.jsonl"
    script = _wordcount(tmp_path, inp, out, run='pw.run(device="cuda")')
    res = spawn_cluster(script, processes=2, check=False, attempts=1,
                        timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr, \
        res.stderr[-2000:]
    assert not out.exists() or not out.read_text()
