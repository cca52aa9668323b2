"""The port's vector-store sinks held to the JAX package's: Pinecone,
Qdrant and Chroma (``io/vector_writers.py``), Milvus, Weaviate and
LEANN's index.  Each test runs one program through the JAX sink and
through the port's (``device="cpu"``), each against a fresh
``tests/torch_db_fakes.VectorStore``, and holds the port to the JAX
package: the same requests with the same payloads reach the store, and
the store ends with the same vectors.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

from . import torch_db_fakes as fakes
from .test_torch_io_databases import PKGS, TWO_ROWS, both, run

SINKS = {
    "pinecone": {"index_host": "https://idx.pinecone.io", "api_key": "k"},
    "qdrant": {"url": "http://localhost:6333", "collection": "c"},
    "chroma": {"url": "http://localhost:8000", "collection_id": "cid"},
}


def vec_schema(pw):
    class VS(pw.Schema):
        doc: str = pw.column_definition(primary_key=True)
        vector: object

    return VS


def vec_stream(dim: int = 4, seed: int = 0) -> list:
    """d1..d4 inserted, d2 updated at time 2 and d3 deleted at time 4; the
    vectors drawn from a seed."""
    rng = np.random.default_rng(seed)
    v = {f"d{i}": rng.standard_normal(dim).astype(np.float32)
         for i in range(1, 6)}
    return ([(d, v[d], 0, 1) for d in ("d1", "d2", "d3", "d4")]
            + [("d2", v["d2"], 2, -1), ("d2", v["d5"], 2, 1),
               ("d3", v["d3"], 4, -1)])


def write_to(kind: str, pw, store, t, **kw):
    if kind == "milvus":
        pw.io.milvus.write(t, "http://milvus:19530", "docs",
                           primary_key=t.doc, _http=store, **kw)
    elif kind == "weaviate":
        pw.io.weaviate.write(t, "Docs", primary_key=t.doc, vector=t.vector,
                             _http=store, **kw)
    else:
        getattr(pw.io, kind).write(t, vector_column="vector",
                                   metadata_columns=["doc"], _http=store,
                                   **SINKS[kind], **kw)


@pytest.mark.parametrize("kind", ["pinecone", "qdrant", "chroma", "milvus",
                                  "weaviate"])
def test_a_stream_of_vectors_equals_the_jax_packages(kind):
    """Inserts, an update and a delete: the same requests, and a store
    that holds the live rows' vectors."""
    rows = vec_stream()

    def build(pw):
        store = fakes.VectorStore(kind, milvus_pk="doc")
        t = pw.debug.table_from_rows(vec_schema(pw), rows, is_stream=True)
        write_to(kind, pw, store, t)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    assert got.items == want.items
    live = {d: v for d, v, _t, diff in rows if diff > 0}
    del live["d3"]
    assert len(got.items) == 3
    stored = sorted(np.asarray(v, np.float32).tobytes()
                    for v, _m in got.items.values())
    assert stored == sorted(v.tobytes() for v in live.values())


@pytest.mark.parametrize("kind", sorted(SINKS))
def test_vector_sinks_upsert_and_delete(kind):
    """The JAX package's own case: two vectors upserted with their
    metadata and the API key's header."""

    def build(pw):
        calls: list = []

        def fake_http(method, url, payload, headers):
            calls.append((method, url, payload, headers))
            return {}

        t = pw.debug.table_from_rows(vec_schema(pw), [
            ("d1", np.ones(4, np.float32)), ("d2", np.zeros(4, np.float32))])
        getattr(pw.io, kind).write(t, vector_column="vector",
                                   metadata_columns=["doc"],
                                   _http=fake_http, **SINKS[kind])
        return calls

    got, want = both(build)
    assert got == want
    (_m, _url, payload, headers), = got
    blob = json.dumps(payload)
    assert "d1" in blob and "d2" in blob
    if kind == "pinecone":
        assert headers.get("Api-Key") == "k"


# -- Weaviate -------------------------------------------------------------------


def test_weaviate_write_upsert_delete():
    def build(pw):
        store = fakes.VectorStore("weaviate")
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.weaviate.write(t, "Docs", primary_key=t.name, vector=None,
                             api_key="k", _http=store)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    [(method, path, payload)] = got.requests
    assert (method, path) == ("POST", "/v1/batch/objects")
    objs = payload["objects"]
    assert {o["properties"]["age"] for o in objs} == {30, 41}
    assert all(o["class"] == "Docs" for o in objs)
    assert all("name" not in o["properties"] for o in objs)
    from pathway_tpu_torch.io.weaviate import _uuid_for

    assert {o["id"] for o in objs} == {_uuid_for("alice"), _uuid_for("bob")}


def test_weaviate_vector_column():
    def build(pw):
        store = fakes.VectorStore("weaviate")
        t = pw.debug.table_from_markdown("""
        name | x | y
        a | 1.0 | 2.0
        """)
        t = t.select(pw.this.name, vec=pw.apply(lambda x, y: [x, y],
                                                pw.this.x, pw.this.y))
        pw.io.weaviate.write(t, "Vecs", primary_key=t.name, vector=t.vec,
                             _http=store)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    obj = got.requests[0][2]["objects"][0]
    assert obj["vector"] == [1.0, 2.0]
    assert "vec" not in obj["properties"]


@pytest.mark.parametrize("sink", ["weaviate", "milvus"])
def test_a_primary_key_of_another_table_is_refused(sink):
    for pw, pg in PKGS.values():
        pg.G.clear()
        try:
            t = pw.debug.table_from_markdown(TWO_ROWS)
            other = pw.debug.table_from_markdown("""
            z
            1
            """)
            with pytest.raises(ValueError, match="does not belong"):
                if sink == "weaviate":
                    pw.io.weaviate.write(t, "Docs", primary_key=other.z,
                                         _http=lambda *a: {})
                else:
                    pw.io.milvus.write(t, "http://x", "c",
                                       primary_key=other.z)
        finally:
            pg.G.clear()


# -- Milvus ---------------------------------------------------------------------


def test_milvus_upsert_and_delete_order():
    def build(pw):
        store = fakes.VectorStore("milvus", milvus_pk="name")
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.milvus.write(t, "http://milvus:19530", "docs",
                           primary_key=t.name, _http=store)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    [(_m, path, payload)] = got.requests
    assert path.endswith("/entities/upsert") and len(payload["data"]) == 2
    assert payload["collectionName"] == "docs"


@pytest.mark.parametrize("case", ["server_error", "float_key"])
def test_milvus_failures_surface(case):
    """A Milvus error code fails the run, and so does a float primary key
    (its filter rendering would miss the stored key)."""
    md = TWO_ROWS if case == "server_error" else """
    score | name
    1.5   | a
    """

    def build(pw):
        def fake_http(method, url, payload, headers):
            if case == "server_error":
                return {"code": 1100, "message": "collection not found"}
            return {"code": 0}

        t = pw.debug.table_from_markdown(md)
        pk = t.name if case == "server_error" else t.score
        pw.io.milvus.write(t, "http://x", "missing", primary_key=pk,
                           _http=fake_http)

    match = "collection not found" if case == "server_error" \
        else "primary key"
    for pkg in PKGS:
        with pytest.raises(Exception, match=match):
            run(pkg, build)


# -- LEANN ----------------------------------------------------------------------


def test_leann_write_and_native_search(tmp_path, caplog):
    """The native BM25 index (``leann`` is not installed): the same
    manifest and the same hits in both packages; the port says once that
    it writes the native index."""
    hits = {}
    for pkg, (pw, _pg) in PKGS.items():
        prefix = tmp_path / pkg / "articles.leann"

        def build(pw, prefix=prefix):
            t = pw.debug.table_from_markdown("""
            text | topic
            the quick brown fox | animals
            jax compiles to xla | tpu
            """)
            pw.io.leann.write(t, prefix, t.text, metadata_columns=[t.topic])

        with caplog.at_level(logging.INFO,
                             logger="pathway_tpu_torch.io.leann"):
            run(pkg, build)
        meta = json.loads((tmp_path / pkg / "articles.leann.meta.json"
                           ).read_text())
        assert meta["num_documents"] == 2
        loaded = pw.io.leann.load_native_index(prefix)
        found = loaded["index"].search("fox", k=1)
        hits[pkg] = [loaded["documents"][i] for i, *_s in found]
    assert hits["torch"] == hits["jax"]
    assert [d["metadata"]["topic"] for d in hits["torch"]] == ["animals"]
    said = [r for r in caplog.records if "native BM25 index" in r.getMessage()]
    assert len(said) == 1 and said[0].name == "pathway_tpu_torch.io.leann"


def test_leann_rejects_non_str_and_skips_empty(tmp_path):
    for pkg, (pw, pg) in PKGS.items():
        pg.G.clear()
        try:
            t = pw.debug.table_from_markdown(TWO_ROWS)
            with pytest.raises(ValueError, match="must be of type str"):
                pw.io.leann.write(t, tmp_path / "i", t.age)
        finally:
            pg.G.clear()

        def build(pw, pkg=pkg):
            t2 = pw.debug.table_from_markdown("""
            text
            hello
            """)
            t2 = t2.select(text=pw.apply_with_type(
                lambda s: "" if s == "hello" else s, str, pw.this.text))
            pw.io.leann.write(t2, tmp_path / f"{pkg}.leann", t2.text)

        run(pkg, build)
        assert not (tmp_path / f"{pkg}.leann.meta.json").exists()


def test_write_pinecone_is_gated_on_the_license(monkeypatch):
    from pathway_tpu.internals.config import pathway_config as jconf
    from pathway_tpu.internals.licensing import MissingLicenseError as JMiss
    from pathway_tpu_torch.internals.config import pathway_config as tconf
    from pathway_tpu_torch.internals.licensing import (
        MissingLicenseError as TMiss)

    for pw, conf, err in ((tpw, tconf, TMiss), (jpw, jconf, JMiss)):
        monkeypatch.setattr(conf, "license_key", None)
        with pytest.raises(err):
            pw.io.vector_writers.write_pinecone(None)
