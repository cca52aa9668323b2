"""The app templates through the port's ``run_template`` and the web
dashboard over the port's recorded metrics (``tests/test_templates_dashboard
.py``'s cases).  The templates are the JAX package's
(``examples/templates``): the port loads them with its own names for the
model classes (``TorchChat`` for ``JaxChat``) and their device on the
CPU.  Each run's output is held to the JAX package's."""

import json
import os
import re
import socket
import urllib.request

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import fresh_port  # noqa: F401

TEMPLATES = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "templates")


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _text(name):
    with open(os.path.join(TEMPLATES, name, "app.yaml")) as f:
        return f.read()


def _on_the_port(text: str) -> str:
    """A template with the port's chat class and every model and index
    on the CPU."""
    text = text.replace("llms.JaxChat", "llms.TorchChat")
    text = text.replace("SentenceTransformerEmbedder {}",
                        "SentenceTransformerEmbedder {device: cpu}")
    for cls in ("xpacks.llm.llms.TorchChat",
                "stdlib.indexing.BruteForceKnnFactory"):
        text = re.sub(rf"(!pw\.{re.escape(cls)}\n)", r"\1  device: cpu\n",
                      text)
    return text


def test_adaptive_rag_template_builds(tmp_path):
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        AdaptiveRAGQuestionAnswerer,
    )

    (tmp_path / "doc.txt").write_text("z-sets are weighted multisets")
    jpg.G.clear()
    japp = jpw.load_yaml(_text("adaptive-rag"), DOCS_DIR=str(tmp_path))
    n_jax = len(jpg.G.nodes)
    jpg.G.clear()
    app = tpw.load_yaml(_on_the_port(_text("adaptive-rag")),
                        DOCS_DIR=str(tmp_path))
    qa = app["question_answerer"]
    assert isinstance(qa, AdaptiveRAGQuestionAnswerer)
    assert qa.indexer is not None
    assert (qa.n_starting_documents, qa.factor, qa.max_iterations) == (
        japp["question_answerer"].n_starting_documents,
        japp["question_answerer"].factor,
        japp["question_answerer"].max_iterations)
    assert len(tpg.G.nodes) > 0 and n_jax > 0


def test_document_store_template_builds(tmp_path):
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    (tmp_path / "a.txt").write_text("alpha beta gamma")
    app = tpw.load_yaml(_on_the_port(_text("document-store")),
                        DOCS_DIR=str(tmp_path))
    assert isinstance(app["document_store"], DocumentStore)


def test_el_pipeline_template_builds():
    """The Kafka half registers its source without touching the network;
    the PostgreSQL sink is a connector the port has not taken yet (the
    databases group of ROADMAP queue A item 3), and loading it raises,
    naming it."""
    env = dict(KAFKA_HOSTNAME="localhost:9092", KAFKA_GROUP_ID="g",
               KAFKA_TOPIC="t", DB_HOSTNAME="localhost", DB_PORT="5432",
               DB_NAME="db", DB_USER="u", DB_PASSWORD="p")
    jpg.G.clear()
    jpw.load_yaml(_text("el-pipeline"), **env)
    assert len(jpg.G.outputs) == 1
    jpg.G.clear()
    with pytest.raises(ModuleNotFoundError, match="postgres"):
        tpw.load_yaml(_text("el-pipeline"), **env)
    assert [n.kind for n in tpg.G.nodes] == ["input"]
    assert not tpg.G.outputs


def test_live_etl_template_runs_end_to_end(tmp_path, monkeypatch):
    from pathway_tpu.cli import run_template as jrun_template
    from pathway_tpu_torch.cli import run_template

    path = os.path.join(TEMPLATES, "live-etl", "app.yaml")
    outs = {}
    for name, runner, kw in (("jax", jrun_template, {}),
                             ("torch", run_template, {"device": "cpu"})):
        out = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("OUTPUT_PATH", str(out))
        jpg.G.clear()
        tpg.G.clear()
        assert runner(path, timeout_s=8.0, **kw) == 0
        outs[name] = sorted(json.loads(ln)["value"]
                            for ln in out.read_text().splitlines())
    assert outs["torch"] == outs["jax"] == list(range(50))


def test_dashboard_records_and_serves(tmp_path, monkeypatch):
    from pathway_tpu_torch.web_dashboard import DashboardServer

    def total(pw, **kw):
        t = pw.demo.range_stream(nb_rows=30, input_rate=500)
        agg = t.reduce(total=pw.reducers.sum(t.value))
        last = {}
        pw.io.subscribe(agg, on_change=lambda key, row, time, is_addition:
                        last.update(total=row["total"]) if is_addition
                        else None)
        pw.run(idle_stop_s=1.0, monitoring_level=pw.MonitoringLevel.NONE,
               **kw)
        return last

    jpg.G.clear()
    want = total(jpw)
    jpg.G.clear()
    monkeypatch.setenv("PATHWAY_DETAILED_METRICS_DIR", str(tmp_path))
    assert total(tpw, device="cpu") == want == {"total": sum(range(30))}
    monkeypatch.delenv("PATHWAY_DETAILED_METRICS_DIR")

    dbs = [f for f in os.listdir(tmp_path) if f.startswith("metrics_")]
    assert dbs, "no metrics db recorded"
    port = _free_port()
    srv = DashboardServer(str(tmp_path), "127.0.0.1", port, wait_for_db=False)
    srv.start()
    try:
        def get(path):
            return json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10).read())

        latest = get("/metrics/latest")
        assert latest and any(r["rows_positive"] > 0 for r in latest)
        rng = get("/metrics/available_range")
        assert rng["min"] is not None and rng["max"] >= rng["min"]
        graph = get("/graph")
        names = [n["name"] for n in graph["nodes"]]
        assert any("reduce" in n or "groupby" in n for n in names), names
        assert graph["edges"], "graph has no edges"
        assert get(f"/metrics/at/{rng['max'] + 10_000}")
        assert isinstance(get("/metrics/charts"), list)
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read().decode()
        assert "pathway-tpu" in html
    finally:
        srv.stop()
