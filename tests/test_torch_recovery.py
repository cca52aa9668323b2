"""Kill-and-recover, exactly once, of the port against the JAX package's
(reference model: integration_tests/wordcount/base.py:432 +
tests/test_recovery.py): a wordcount stopped mid-stream and restarted,
a restart after the source file vanished, a process killed by an
injected fault right after a journal commit, the file source's offsets
covering only rows it handed out, and the RAG pipeline of
``tests/test_e2e_rag.py`` restarted mid-serving."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from .torch_parity import fresh_port  # noqa: F401
from .torch_persist import PKGS, backend, both, journal_events, run

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _wordcount(pkg, src, out, be, idle_stop_s=1.0):
    pw, pg = PKGS[pkg]
    pg.G.clear()

    class S(pw.Schema):
        word: str

    t = pw.io.csv.read(str(src), schema=S, mode="streaming")
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out))
    run(pkg, persistence_config=pw.persistence.Config(be),
        idle_stop_s=idle_stop_s, autocommit_duration_ms=20)


def _squash(path) -> dict:
    """The last count of each word (insert replaces, retraction clears)."""
    state = {}
    for ln in path.read_text().splitlines():
        e = json.loads(ln)
        if e["diff"] > 0:
            state[e["word"]] = e["c"]
        elif state.get(e["word"]) == e["c"]:
            del state[e["word"]]
    return state


WORDS = ["alpha", "beta", "alpha", "gamma", "alpha", "beta"]


def test_wordcount_kill_and_recover(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src = root / "words.csv"
        be = backend(pkg, root / "pstore")
        src.write_text("word\n" + "\n".join(WORDS[:3]) + "\n")

        def appender():
            time.sleep(0.6)
            with open(src, "a") as f:
                f.write("\n".join(WORDS[3:5]) + "\n")

        th = threading.Thread(target=appender)
        th.start()
        _wordcount(pkg, src, root / "out1.jsonl", be, idle_stop_s=1.2)
        th.join(5)
        with open(src, "a") as f:
            f.write(WORDS[5] + "\n")
        _wordcount(pkg, src, root / "out2.jsonl", be)
        return _squash(root / "out2.jsonl"), journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"alpha": 3, "beta": 2, "gamma": 1}


def test_replay_survives_source_loss(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src = root / "words.csv"
        be = backend(pkg, root / "ps")
        src.write_text("word\nalpha\nbeta\nalpha\n")
        _wordcount(pkg, src, root / "o1.jsonl", be, idle_stop_s=0.8)
        src.unlink()  # the journal carries the rows
        _wordcount(pkg, src, root / "o2.jsonl", be, idle_stop_s=0.8)
        return _squash(root / "o2.jsonl")

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"] == {"alpha": 2, "beta": 1}


def test_offsets_prevent_duplicate_reads(tmp_path):
    """Appending to a streamed csv does not re-emit its earlier rows."""
    out = {}
    for pkg, (pw, pg) in PKGS.items():
        src = tmp_path / f"{pkg}.csv"
        src.write_text("word\na\nb\n")
        pg.G.clear()

        class S(pw.Schema):
            word: str

        t = pw.io.csv.read(str(src), schema=S, mode="streaming")
        got = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                        got.append(row["word"]))

        def appender(src=src):
            time.sleep(0.5)
            with open(src, "a") as f:
                f.write("c\n")

        th = threading.Thread(target=appender)
        th.start()
        run(pkg, idle_stop_s=1.0, autocommit_duration_ms=20)
        th.join(5)
        out[pkg] = sorted(got)
    assert out["torch"] == out["jax"] == ["a", "b", "c"]


# -- a process killed right after its second journal commit ------------------

_APP = """
import sys, threading, time
import pathway_tpu_torch as pw

src, out, store = sys.argv[1:4]

class S(pw.Schema):
    word: str

def appender():
    # the first batch's counts reach the sink before the append, so the
    # appended rows are a second scan's and a second commit's however
    # slowly the run started
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            with open(out) as f:
                if f.read().strip():
                    break
        except OSError:
            pass
        time.sleep(0.05)
    with open(src) as f:
        if "gamma" in f.read():
            return  # appended by an earlier incarnation
    with open(src, "a") as f:
        f.write("beta\\ngamma\\nbeta\\n")

threading.Thread(target=appender, daemon=True).start()
t = pw.io.csv.read(src, schema=S, mode="streaming")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, out)
pw.run(device="cpu", idle_stop_s=2.0, autocommit_duration_ms=20,
       persistence_config=pw.persistence.Config(
           pw.persistence.Backend.filesystem(store)))
"""


def _app(tmp_path, name, fault=None):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PW_COSTDB_PATH=str(tmp_path / "costdb.json"),
               PATHWAY_TRACE_DUMP_DIR=str(tmp_path))
    env.pop("PW_FAULT", None)
    if fault:
        env["PW_FAULT"] = fault
    return subprocess.run(
        [sys.executable, "-c", _APP, str(tmp_path / f"{name}.csv"),
         str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}_store")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)


def test_killed_after_a_journal_commit_recovers_exactly_once(tmp_path):
    """``PW_FAULT="persistence.commit:kill:2"`` kills the process right
    after its second journal record (the appended rows) landed, before
    their counts reach the sink; the restart replays the journal and the
    squashed sink equals the run that was never killed."""
    for name in ("killed", "whole"):
        (tmp_path / f"{name}.csv").write_text("word\nalpha\nbeta\n")
    runs = {}
    whole_th = threading.Thread(target=lambda: runs.update(
        whole=_app(tmp_path, "whole")))
    whole_th.start()
    killed = _app(tmp_path, "killed", "persistence.commit:kill:2")
    assert killed.returncode == 137, killed.stderr[-2000:]
    assert "fault.injected kill at persistence.commit" in killed.stderr
    mid = _squash(tmp_path / "killed.jsonl")
    assert mid == {"alpha": 1, "beta": 1}  # the appended rows never landed
    restarted = _app(tmp_path, "killed")
    assert restarted.returncode == 0, restarted.stderr[-2000:]
    whole_th.join(150)
    assert runs["whole"].returncode == 0, runs["whole"].stderr[-2000:]
    want = {"alpha": 1, "beta": 3, "gamma": 1}
    assert _squash(tmp_path / "whole.jsonl") == want
    assert _squash(tmp_path / "killed.jsonl") == want
    store = backend("torch", tmp_path / "killed_store")
    assert journal_events(store) == journal_events(
        backend("torch", tmp_path / "whole_store"))


def test_a_bad_fault_spec_raises(monkeypatch):
    from pathway_tpu_torch import faults

    monkeypatch.setenv("PW_FAULT", "persistence.commit")
    faults.clear()
    try:
        with pytest.raises(ValueError, match="bad PW_FAULT spec"):
            faults.fire("persistence.commit")
    finally:
        monkeypatch.delenv("PW_FAULT")
        faults.clear()


# -- offsets cover only the rows poll handed out -----------------------------

def _wait(cond, deadline_s=10.0):
    end = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.01)


def test_a_kill_between_a_scan_and_the_next_poll_loses_nothing(tmp_path):
    """The scan thread has read rows that ``poll`` has not handed out when
    the process dies: the journal's offsets do not cover them, so the
    restart reads them again from the file, once."""
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.persistence import Config, attach_persistence

    pw, pg = PKGS["torch"]
    src = tmp_path / "w.csv"
    src.write_text("word\na\nb\n")
    store = tmp_path / "ps"

    class S(pw.Schema):
        word: str

    def lowered():
        pg.G.clear()
        t = pw.io.csv.read(str(src), schema=S, mode="streaming")
        got = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                        got.append(row["word"]))
        runner = GraphRunner(list(pg.G.outputs), device="cpu")
        attach_persistence(runner, Config(backend("torch", store)))
        [(_op, source)] = runner.lg.input_ops
        return runner, source, got

    _runner, source, _got = lowered()
    source.poll_interval_s = 0.05
    source.start()
    polled = []
    _wait(lambda: polled.extend(source.poll()) or len(polled) == 2)
    assert source.get_offsets() == {str(src): 2}
    with open(src, "a") as f:
        f.write("c\nd\n")
    # the scan thread reads the new rows; nobody polls them: a crash here
    _wait(lambda: source._found.qsize() > 0)
    assert source._progress == {str(src): 4}
    assert source.get_offsets() == {str(src): 2}
    source.stop()
    runner, source2, got = lowered()
    runner.run_streaming(autocommit_ms=20, idle_stop_s=0.8)
    assert sorted(got) == ["a", "b", "c", "d"]


def test_seek_after_the_scan_thread_started_raises(tmp_path):
    pw, pg = PKGS["torch"]
    pg.G.clear()
    t = pw.io.fs.read(str(tmp_path), format="plaintext", mode="streaming")
    source = t._node.params["source"]
    source.start()
    try:
        with pytest.raises(RuntimeError, match="seek"):
            source.seek({})
    finally:
        source.stop()


# -- the RAG pipeline restarted mid-serving (tests/test_e2e_rag.py) ----------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _store(pkg, w, docs_dir):
    """The quickstart's store over ``docs_dir`` in package ``pkg``, on the
    encoder weights of ``tests/test_torch_rag_answer.py``."""
    import jax
    import jax.numpy as jnp

    from pathway_tpu.models import encoder as jenc
    from pathway_tpu.stdlib.indexing import BruteForceKnnFactory as JFactory
    from pathway_tpu.xpacks.llm import embedders as jemb
    from pathway_tpu.xpacks.llm.document_store import DocumentStore as JStore
    from pathway_tpu_torch.models import encoder as tenc
    from pathway_tpu_torch.models.convert import encoder_params_from_numpy
    from pathway_tpu_torch.stdlib.indexing import (
        BruteForceKnnFactory as TFactory)
    from pathway_tpu_torch.xpacks.llm import embedders as temb
    from pathway_tpu_torch.xpacks.llm.document_store import (
        DocumentStore as TStore)

    pw, _pg = PKGS[pkg]
    docs = pw.io.fs.read(str(docs_dir), format="binary", mode="streaming",
                         with_metadata=True)
    if pkg == "jax":
        emb = jemb.SentenceTransformerEmbedder(config=w["ecfg_j"])
        emb._enc = jenc.JaxEncoder(w["ecfg_j"], params=jax.tree_util.tree_map(
            jnp.asarray, w["etree"]))
        return JStore(docs, retriever_factory=JFactory(
            dimensions=emb.get_embedding_dimension(), embedder=emb))
    emb = temb.SentenceTransformerEmbedder(config=w["ecfg_t"], device="cpu",
                                           device_resident=True)
    emb._enc = tenc.TorchEncoder(w["ecfg_t"], params=encoder_params_from_numpy(
        w["etree"], w["ecfg_t"], device="cpu"), device="cpu")
    return TStore(docs, retriever_factory=TFactory(
        dimensions=emb.get_embedding_dimension(), embedder=emb,
        device="cpu"))


def _serve_once(pkg, w, docs_dir, be, n_expected, query):
    pw, pg = PKGS[pkg]
    qa = __import__(f"{'pathway_tpu' if pkg == 'jax' else 'pathway_tpu_torch'}"
                    ".xpacks.llm.question_answering", fromlist=["x"])
    servers = __import__(
        f"{'pathway_tpu' if pkg == 'jax' else 'pathway_tpu_torch'}"
        ".xpacks.llm.servers", fromlist=["x"])
    pg.G.clear()
    rag = qa.BaseRAGQuestionAnswerer(lambda msgs: "ok",
                                     _store(pkg, w, docs_dir), search_topk=1)
    port = _free_port()
    servers.QARestServer("127.0.0.1", port, rag)
    out = {}

    def client():
        end = time.monotonic() + 20
        while time.monotonic() < end:
            try:
                stats = _post(port, "/v1/statistics", {})
            except OSError:
                time.sleep(0.05)
                continue
            if stats["chunk_count"] == n_expected:
                out["stats"] = stats
                out["hit"] = _post(port, "/v1/retrieve",
                                   {"query": query, "k": 1})
                return
            time.sleep(0.05)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    run(pkg, timeout_s=30.0, idle_stop_s=1.0, autocommit_duration_ms=40,
        persistence_config=pw.persistence.Config(be))
    th.join(5)
    pg.G.clear()
    assert out.get("stats", {}).get("chunk_count") == n_expected, out
    return [(h["text"], round(h["score"], 4)) for h in out["hit"]]


def test_rag_restart_mid_serving_with_persistence(tmp_path):
    """Stop the serving pipeline, restart it over the same storage: the
    documents of the first run are back once, and a document added after
    the restart joins the same index; the answers equal the JAX
    package's."""
    from .test_torch_rag_answer import weights as weights_fixture

    w = weights_fixture.__wrapped__()

    def scenario(pkg, root):
        docs_dir = root / "docs"
        docs_dir.mkdir(parents=True)
        be = backend(pkg, root / "pstate")
        (docs_dir / "a.txt").write_text("gamma handbook for stream engines")
        hits = [_serve_once(pkg, w, docs_dir, be, 1, "gamma handbook")]
        hits.append(_serve_once(pkg, w, docs_dir, be, 1, "gamma handbook"))
        (docs_dir / "b.txt").write_text("delta appendix for batch engines")
        hits.append(_serve_once(pkg, w, docs_dir, be, 2, "delta appendix"))
        return hits

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert [h[0][0].split()[0] for h in out["torch"]] == [
        "gamma", "gamma", "delta"]


# -- chip_smoke.py's phase 4m, on the CPU at small sizes ----------------------

def test_chip_smoke_phase_4m_runs_on_the_cpu():
    """Phase 4m end to end on the CPU (counts divided by 64, small
    widths): every check of the phase passes."""
    import torch

    import chip_smoke as cs
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models import encoder as tenc

    small = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
    s = cs.persistence_inputs(
        torch, dec, "cpu", 0, dict(num_blocks=128, block_size=16,
                                   max_batch_size=4, chain_steps=4,
                                   max_restarts=0),
        device="cpu", scale=64,
        enc_cfg=tenc.EncoderConfig(vocab_size=2048, max_len=128, **small),
        chat_cfg=dec.DecoderConfig(vocab_size=512, max_len=1024,
                                   dtype=torch.float32, **small))
    line, launches = cs.phase4m(torch, np, dec, s)
    quick, snaps = line["quickstart"], line["snapshots"]
    z = s.sizes
    assert quick["docs"] == z["docs"] == 64
    assert quick["replayed_events"] == z["docs"]
    assert quick["recover_s"] <= quick["full_s"]
    assert quick["journal_bytes"] > 0 and quick["object_cache_bytes"] > 0
    assert 0 < snaps["tail_records"] < snaps["journal_records"]
    assert snaps["rows"] == z["wc_rows"]
    assert launches == {"knn_scores": 0, "paged_attention": 0,
                        "paged_append_attend": 0}  # no kernel on the CPU
    assert line["reduced"] == {"docs": [64, 16384],
                               "wc_rows": [512, 524288]}
