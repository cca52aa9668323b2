"""The port's REST servers on 127.0.0.1 under its own ``pw.run``.

A ``DocumentStoreServer`` and a ``QARestServer`` serve a static document
table on a free port under ``pw.run(device="cpu", timeout_s=10,
idle_stop_s=3)``; a client thread waits for the socket to accept, then
posts.  ``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs`` and
``/v1/pw_ai_answer`` must give what the same queries give in a static
run (``run_tables``), and ``/_schema`` describes the routes.  With an
``admission`` dict of one pending request, a request made while the
first is held inside the llm is shed with 429 and ``Retry-After``.  No
answer depends on wall-clock pacing: every wait is on a socket, a
response or an event, each bounded.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.runner import run_tables
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.value import ref_scalar
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.xpacks.llm import question_answering as qa
from pathway_tpu_torch.xpacks.llm.llms import TorchChat
from pathway_tpu_torch.xpacks.llm.servers import (DocumentStoreServer,
                                                   QARestServer)

from .test_torch_rag_answer import NEW
from .test_torch_rag_answer import weights  # noqa: F401 - the fixture
from .test_torch_rag_answer import _port_store

QUERIES = [("what is the mxu", 2), ("which animal jumps", 1),
           ("keys and values", 3)]
PROMPTS = ["what is the mxu", "which animal jumps", "what processes data"]


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    pg.G.clear()
    yield
    pg.G.clear()
    costdb.shutdown()
    planner.invalidate_cache()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, deadline_s: float = 10.0) -> None:
    end = time.monotonic() + deadline_s
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if time.monotonic() > end:
                raise
            time.sleep(0.02)


def _request(port, route, payload=None, method="POST"):
    """(status, parsed body, headers) of one request."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _serve(client) -> dict:
    """Run the graph's servers while ``client(results)`` talks to them
    from a thread; the run ends after 3 s without a request."""
    results: dict = {}

    def run_client():
        try:
            client(results)
        except Exception as exc:  # noqa: BLE001 - reported by the test
            results["error"] = repr(exc)

    th = threading.Thread(target=run_client, daemon=True)
    th.start()
    pw.run(device="cpu", timeout_s=10.0, idle_stop_s=3.0)
    th.join(timeout=10)
    assert not th.is_alive()
    assert "error" not in results, results["error"]
    return results


def test_document_store_server_serves_the_static_answers(weights):  # noqa: F811
    pg.G.clear()

    class Q(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str
        k: int

    q = pw.debug.table_from_rows(Q, [(i, t, k) for i, (t, k)
                                     in enumerate(QUERIES)])
    [cap] = run_tables(_port_store(weights).retrieve_query(q), device="cpu")
    state = cap.squash()
    want = [state[ref_scalar(i)][0].value for i in range(len(QUERIES))]
    pg.G.clear()

    port = _free_port()
    DocumentStoreServer("127.0.0.1", port, _port_store(weights))

    def client(res):
        _wait_listening(port)
        res["retrieve"] = [_request(port, "/v1/retrieve",
                                    {"query": t, "k": k}) for t, k in QUERIES]
        res["statistics"] = _request(port, "/v1/statistics", {})
        res["inputs"] = _request(port, "/v1/inputs", {})
        res["schema"] = _request(port, "/_schema?format=json",
                                 method="GET")
        res["missing"] = _request(port, "/v1/retrieve", {"query": "x"})

    res = _serve(client)
    assert [r[0] for r in res["retrieve"]] == [200] * 3
    got = [r[1] for r in res["retrieve"]]
    assert [[d["text"] for d in r] for r in got] == \
        [[d["text"] for d in r] for r in want]
    assert [[d["score"] for d in r] for r in got] == \
        [[d["score"] for d in r] for r in want]
    assert res["statistics"][:2] == (200, {"file_count": 4, "chunk_count": 4})
    assert res["inputs"][0] == 200 and len(res["inputs"][1]) == 4
    status, schema, _h = res["schema"]
    assert status == 200 and schema["openapi"] == "3.0.3"
    props = schema["paths"]["/v1/retrieve"]["post"]["requestBody"][
        "content"]["application/json"]["schema"]
    assert props["required"] == ["query", "k"]
    assert res["missing"][:2] == (400, {"error": "`k` is required"})


def test_qa_server_answers_as_the_static_run(weights):  # noqa: F811
    chat = TorchChat(weights["cfg_t"], params=weights["pt"],
                     max_new_tokens=NEW, device="cpu")
    rag = qa.BaseRAGQuestionAnswerer(chat, _port_store(weights),
                                     search_topk=2, llm_scheduler=True)
    [cap] = run_tables(rag.answer_query(pw.debug.table_from_rows(
        pw.schema_from_types(prompt=str), [(p,) for p in PROMPTS])),
        device="cpu")
    want = sorted(row[0] for row in cap.squash().values())
    pg.G.clear()

    port = _free_port()
    rag = qa.BaseRAGQuestionAnswerer(chat, _port_store(weights),
                                     search_topk=2, llm_scheduler=True)
    QARestServer("127.0.0.1", port, rag)

    def client(res):
        _wait_listening(port)
        out = [None] * len(PROMPTS)

        def ask(i):
            out[i] = _request(port, "/v1/pw_ai_answer",
                              {"prompt": PROMPTS[i]})

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        res["answers"] = out
        res["retrieve"] = _request(port, "/v1/retrieve",
                                   {"query": PROMPTS[0], "k": 2})

    res = _serve(client)
    assert [r[0] for r in res["answers"]] == [200] * len(PROMPTS)
    assert sorted(r[1] for r in res["answers"]) == want
    assert res["retrieve"][0] == 200 and len(res["retrieve"][1]) == 2


def test_admission_sheds_with_429_and_retry_after(weights):  # noqa: F811
    inside, release = threading.Event(), threading.Event()

    def held_llm(messages):
        inside.set()
        assert release.wait(10)
        question = messages[0]["content"].split("Question: ")[-1]
        return "A[" + question.split("\n")[0] + "]"

    rag = qa.BaseRAGQuestionAnswerer(held_llm, _port_store(weights),
                                     search_topk=1)
    port = _free_port()
    QARestServer("127.0.0.1", port, rag,
                 admission={"max_pending": 1, "retry_after_s": 2.0})

    def client(res):
        _wait_listening(port)
        first = {}
        th = threading.Thread(target=lambda: first.update(r=_request(
            port, "/v1/pw_ai_answer", {"prompt": "first question"})))
        th.start()
        assert inside.wait(10)  # the first request holds the only slot
        res["shed"] = _request(port, "/v1/pw_ai_answer",
                               {"prompt": "second question"})
        release.set()
        th.join(timeout=20)
        res["first"] = first["r"]

    res = _serve(client)
    status, body, headers = res["shed"]
    assert status == 429 and "error" in body
    assert headers["Retry-After"] == "2"
    assert res["first"][:2] == (200, "A[first question]")
