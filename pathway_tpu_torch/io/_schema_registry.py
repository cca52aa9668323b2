"""Confluent Schema Registry support (reference: engine.pyi:865 +
internals/_io_helpers.py SchemaRegistrySettings; Rust side in
src/connectors/data_format/).

Speaks the registry's REST API directly (GET /schemas/ids/{id},
POST /subjects/{subject}/versions) and the Confluent wire format (magic
byte 0x00 + big-endian 4-byte schema id + Avro payload) with the native
Avro codec from io/_avro.py — no confluent-kafka-avro dependency.  The
HTTP transport is injectable for tests.

The port of ``pathway_tpu/io/_schema_registry.py``.  A transport
error moves on to the registry's next URL; an HTTP error answer is a bad
message (``LookupError``), and no URL answering is a ``ConnectionError``
that fails the run.
"""

from __future__ import annotations

import base64
import json
import struct
import urllib.request
from typing import Any

from ..internals import dtype as dt
from ..internals.schema import SchemaMetaclass
from . import _avro


class SchemaRegistryHeader:
    """One extra HTTP header for registry requests (reference parity)."""

    def __init__(self, name: str, value: str):
        self.name = name
        self.value = value


class SchemaRegistrySettings:
    """Connection settings for the Confluent Schema Registry."""

    def __init__(self, urls: list[str] | str, *,
                 token_authorization: str | None = None,
                 username: str | None = None, password: str | None = None,
                 headers: list[SchemaRegistryHeader] | None = None,
                 proxy: str | None = None, timeout: float | None = None,
                 _http=None):
        self.urls = [urls] if isinstance(urls, str) else list(urls)
        if not self.urls:
            raise ValueError("schema registry needs at least one URL")
        if password is not None and username is None:
            raise ValueError("schema registry password requires a username")
        self.token = token_authorization
        self.username = username
        self.password = password
        self.headers = list(headers or [])
        self.proxy = proxy
        self.timeout = timeout or 30.0
        self._http = _http

    def _auth_headers(self) -> dict:
        out = {h.name: h.value for h in self.headers}
        if self.token:
            out["Authorization"] = f"Bearer {self.token}"
        elif self.username is not None:
            cred = f"{self.username}:{self.password or ''}".encode()
            out["Authorization"] = "Basic " + base64.b64encode(cred).decode()
        return out


class SchemaRegistryClient:
    """Minimal registry client: schema-by-id (cached) and register."""

    def __init__(self, settings: SchemaRegistrySettings):
        self.settings = settings
        self._by_id: dict[int, Any] = {}
        self._reg_ids: dict[str, int] = {}

    def _request(self, method: str, path: str,
                 payload: dict | None = None) -> dict:
        if self.settings._http is not None:  # test seam: no failover
            return self.settings._http(
                method, self.settings.urls[0].rstrip("/") + path, payload,
                self.settings._auth_headers())
        last_exc: Exception | None = None
        for base in self.settings.urls:
            url = base.rstrip("/") + path
            try:
                req = urllib.request.Request(
                    url,
                    data=None if payload is None
                    else json.dumps(payload).encode(),
                    headers={
                        "Content-Type":
                            "application/vnd.schemaregistry.v1+json",
                        **self.settings._auth_headers(),
                    },
                    method=method,
                )
                opener = urllib.request.build_opener(
                    *( [urllib.request.ProxyHandler(
                        {"http": self.settings.proxy,
                         "https": self.settings.proxy})]
                       if self.settings.proxy else [] )
                )
                with opener.open(req, timeout=self.settings.timeout) as r:
                    return json.loads(r.read() or b"{}")
            except urllib.error.HTTPError as exc:
                # the registry answered: a 4xx (unknown schema id, bad
                # subject) is a per-request error, NOT "unreachable" —
                # no URL failover, and callers treat it as a bad message
                body = b""
                try:
                    body = exc.read()
                except Exception:
                    pass
                raise LookupError(
                    f"schema registry returned {exc.code} for {path}: "
                    f"{body[:200]!r}"
                ) from exc
            except Exception as exc:  # transport: try the next URL
                last_exc = exc
        raise ConnectionError(
            f"schema registry unreachable via {self.settings.urls}: "
            f"{last_exc}"
        )

    def schema_by_id(self, schema_id: int) -> Any:
        if schema_id not in self._by_id:
            resp = self._request("GET", f"/schemas/ids/{schema_id}")
            self._by_id[schema_id] = json.loads(resp["schema"])
        return self._by_id[schema_id]

    def register(self, subject: str, schema: dict) -> int:
        key = subject
        if key not in self._reg_ids:
            resp = self._request(
                "POST", f"/subjects/{subject}/versions",
                {"schema": json.dumps(schema)},
            )
            self._reg_ids[key] = int(resp["id"])
            self._by_id[self._reg_ids[key]] = schema
        return self._reg_ids[key]


# -- Confluent wire format ---------------------------------------------------

def decode_confluent(raw: bytes) -> tuple[int, bytes]:
    """(schema_id, avro_payload) from a wire-format message."""
    if len(raw) < 5 or raw[0] != 0:
        raise ValueError("not a Confluent wire-format message")
    return struct.unpack(">I", raw[1:5])[0], raw[5:]


def encode_confluent(schema_id: int, payload: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", schema_id) + payload


def decode_avro_message(raw: bytes, client: SchemaRegistryClient) -> dict:
    schema_id, payload = decode_confluent(raw)
    schema = client.schema_by_id(schema_id)
    value, _pos = _avro.decode_value(schema, payload, 0, {})
    if not isinstance(value, dict):
        value = {"data": value}
    return value


def avro_schema_for(schema: SchemaMetaclass, name: str = "Row") -> dict:
    """Avro record schema derived from a pw.Schema (writer side)."""
    fields = []
    for c, d in schema.dtypes().items():
        base = d.strip_optional()
        typ: Any = {
            dt.INT: "long", dt.FLOAT: "double", dt.STR: "string",
            dt.BOOL: "boolean", dt.BYTES: "bytes",
        }.get(base, "string")
        if isinstance(d, dt.Optional) or base is dt.ANY:
            typ = ["null", typ]
        fields.append({"name": c, "type": typ})
    return {"type": "record", "name": name, "fields": fields}


def coerce_row_for_avro(row: dict, schema: dict) -> dict:
    """Make engine values encodable under the derived schema: bytes stay
    bytes, primitives pass through, anything else (ndarray, Json,
    datetime, values in ANY-typed string fields) stringifies — mirroring
    the json path's default=str."""
    types = {f["name"]: f["type"] for f in schema["fields"]}
    out = {}
    for k, v in row.items():
        t = types.get(k)
        base = ([b for b in t if b != "null"][0]
                if isinstance(t, list) else t)
        if v is None or isinstance(v, bool):
            out[k] = v
        elif base == "bytes":
            out[k] = bytes(v) if not isinstance(v, bytes) else v
        elif base in ("int", "long"):
            out[k] = int(v)
        elif base in ("float", "double"):
            out[k] = float(v)
        elif base == "string":
            out[k] = v if isinstance(v, str) else str(v)
        else:
            out[k] = v
    return out


def encode_avro_message(row: dict, schema: dict, schema_id: int) -> bytes:
    payload = _avro.encode_value(schema, coerce_row_for_avro(row, schema), {})
    return encode_confluent(schema_id, payload)
