"""ElasticSearch output connector (reference:
python/pathway/io/elasticsearch/__init__.py:97 over
src/connectors/data_storage/elasticsearch.rs, 931 LoC).

Rows serialize to JSON documents indexed per committed batch; deletions are
emitted for negative diffs.  The client seam accepts an injected object for
tests (elasticsearch-py when installed).

The port of ``pathway_tpu/io/elasticsearch.py``.  Of a failed delete only
an absent document is ignored, and a failed ``close`` raises."""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._utils import add_output_node
from ..internals.config import _check_entitlements


class ElasticSearchAuth:
    """Reference parity: basic/apikey/bearer auth descriptors."""

    def __init__(self, kind: str, **params):
        self.kind = kind
        self.params = params

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, apikey: str, apikey_id: str | None = None) -> "ElasticSearchAuth":
        return cls("apikey", apikey=apikey, apikey_id=apikey_id)

    @classmethod
    def bearer(cls, bearer: str) -> "ElasticSearchAuth":
        return cls("bearer", bearer=bearer)


def _make_client(host: str, auth: ElasticSearchAuth | None):
    if auth is not None and "client" in auth.params:
        return auth.params["client"]
    try:
        from elasticsearch import Elasticsearch
    except ImportError as exc:
        raise ImportError(
            "pw.io.elasticsearch requires the elasticsearch client (or an "
            "injected client for tests)"
        ) from exc
    kw: dict[str, Any] = {}
    if auth is not None:
        if auth.kind == "basic":
            kw["basic_auth"] = (auth.params["username"], auth.params["password"])
        elif auth.kind == "apikey":
            kw["api_key"] = auth.params["apikey"]
        elif auth.kind == "bearer":
            kw["bearer_auth"] = auth.params["bearer"]
    return Elasticsearch(host, **kw)


class _EsWriter:
    def __init__(self, host: str, auth, index_name: str):
        self.host = host
        self.auth = auth
        self.index_name = index_name
        self._client = None

    def write_batch(self, time_, colnames, updates) -> None:
        from ..engine.types import unwrap_row
        from ._utils import _jsonable

        if not updates:
            return
        if self._client is None:
            self._client = _make_client(self.host, self.auth)
        for key, row, diff in updates:
            doc = {
                c: _jsonable(v) for c, v in zip(colnames, unwrap_row(row))
            }
            doc_id = str(int(key))
            if diff > 0:
                self._client.index(
                    index=self.index_name, id=doc_id, document=doc
                )
            else:
                try:
                    self._client.delete(index=self.index_name, id=doc_id)
                except Exception as exc:
                    # only an absent document is ignorable; a transient
                    # failure would silently lose the retraction forever
                    status = getattr(exc, "status_code", None)
                    if status != 404 and type(exc).__name__ not in (
                        "NotFoundError", "KeyError",
                    ):
                        raise

    def close(self) -> None:
        # a failed close raises (the JAX writer swallows it)
        if self._client is not None:
            self._client.close()


def write(table: Table, host: str, auth: ElasticSearchAuth | None,
          index_name: str, **kwargs) -> None:
    _check_entitlements("elasticsearch")
    add_output_node(table, _EsWriter(host, auth, index_name))
