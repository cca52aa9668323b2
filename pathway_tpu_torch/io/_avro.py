"""Native Avro object-container codec (schema-driven binary encoding), the
substrate for the Iceberg connector's manifest files (reference:
data_lake/iceberg.rs uses the avro crate; the container format is public:
magic 'Obj\\x01', metadata map with the writer schema JSON, sync-marked
deflate/null blocks, zigzag-varint primitives).

The port of ``pathway_tpu/io/_avro.py``: byte for byte the same
encodings.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary primitives


def _zigzag_encode(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    u = 0
    while True:
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1), pos


# ---------------------------------------------------------------------------
# schema-driven values


def _resolve(schema: Any, named: dict) -> Any:
    if isinstance(schema, str) and schema in named:
        return named[schema]
    return schema


def decode_value(schema: Any, data: bytes, pos: int, named: dict) -> tuple[Any, int]:
    schema = _resolve(schema, named)
    if isinstance(schema, list):  # union
        idx, pos = _zigzag_decode(data, pos)
        return decode_value(schema[idx], data, pos, named)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            named[schema.get("name", "")] = schema
            out = {}
            for f in schema["fields"]:
                out[f["name"]], pos = decode_value(f["type"], data, pos, named)
            return out, pos
        if t == "array":
            out_arr: list = []
            while True:
                count, pos = _zigzag_decode(data, pos)
                if count == 0:
                    return out_arr, pos
                if count < 0:
                    _blocksize, pos = _zigzag_decode(data, pos)
                    count = -count
                for _ in range(count):
                    v, pos = decode_value(schema["items"], data, pos, named)
                    out_arr.append(v)
        if t == "map":
            out_map: dict = {}
            while True:
                count, pos = _zigzag_decode(data, pos)
                if count == 0:
                    return out_map, pos
                if count < 0:
                    _blocksize, pos = _zigzag_decode(data, pos)
                    count = -count
                for _ in range(count):
                    k, pos = decode_value("string", data, pos, named)
                    out_map[k], pos = decode_value(
                        schema["values"], data, pos, named
                    )
        if t == "fixed":
            named[schema.get("name", "")] = schema
            n = schema["size"]
            return bytes(data[pos : pos + n]), pos + n
        if t == "enum":
            named[schema.get("name", "")] = schema
            idx, pos = _zigzag_decode(data, pos)
            return schema["symbols"][idx], pos
        return decode_value(t, data, pos, named)  # logicalType wrapper
    if schema == "null":
        return None, pos
    if schema == "boolean":
        return data[pos] == 1, pos + 1
    if schema in ("int", "long"):
        return _zigzag_decode(data, pos)
    if schema == "float":
        return struct.unpack_from("<f", data, pos)[0], pos + 4
    if schema == "double":
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if schema == "bytes":
        n, pos = _zigzag_decode(data, pos)
        return bytes(data[pos : pos + n]), pos + n
    if schema == "string":
        n, pos = _zigzag_decode(data, pos)
        return data[pos : pos + n].decode("utf-8"), pos + n
    raise ValueError(f"unsupported avro schema {schema!r}")


def encode_value(schema: Any, v: Any, named: dict) -> bytes:
    schema = _resolve(schema, named)
    if isinstance(schema, list):  # union: pick the branch matching v
        for i, branch in enumerate(schema):
            if _matches(branch, v, named):
                return _zigzag_encode(i) + encode_value(branch, v, named)
        raise ValueError(f"no union branch for {v!r} in {schema!r}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            named[schema.get("name", "")] = schema
            out = b""
            for f in schema["fields"]:
                fv = v.get(f["name"]) if isinstance(v, dict) else None
                out += encode_value(f["type"], fv, named)
            return out
        if t == "array":
            items = list(v or [])
            out = b""
            if items:
                out += _zigzag_encode(len(items))
                for x in items:
                    out += encode_value(schema["items"], x, named)
            return out + _zigzag_encode(0)
        if t == "map":
            entries = dict(v or {})
            out = b""
            if entries:
                out += _zigzag_encode(len(entries))
                for k, x in entries.items():
                    out += encode_value("string", k, named)
                    out += encode_value(schema["values"], x, named)
            return out + _zigzag_encode(0)
        if t == "fixed":
            named[schema.get("name", "")] = schema
            return bytes(v)
        if t == "enum":
            named[schema.get("name", "")] = schema
            return _zigzag_encode(schema["symbols"].index(v))
        return encode_value(t, v, named)
    if schema == "null":
        return b""
    if schema == "boolean":
        return b"\x01" if v else b"\x00"
    if schema in ("int", "long"):
        return _zigzag_encode(int(v))
    if schema == "float":
        return struct.pack("<f", float(v))
    if schema == "double":
        return struct.pack("<d", float(v))
    if schema == "bytes":
        return _zigzag_encode(len(v)) + bytes(v)
    if schema == "string":
        b = str(v).encode("utf-8")
        return _zigzag_encode(len(b)) + b
    raise ValueError(f"unsupported avro schema {schema!r}")


def _matches(branch: Any, v: Any, named: dict) -> bool:
    branch = _resolve(branch, named)
    if branch == "null":
        return v is None
    if v is None:
        return False
    if isinstance(branch, dict):
        t = branch["type"]
        if t == "record":
            return isinstance(v, dict)
        if t == "array":
            return isinstance(v, (list, tuple))
        if t == "map":
            return isinstance(v, dict)
        if t in ("fixed", "bytes"):
            return isinstance(v, (bytes, bytearray))
        if t == "enum":
            return isinstance(v, str)
        return _matches(t, v, named)
    if branch == "boolean":
        return isinstance(v, bool)
    if branch in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if branch in ("float", "double"):
        return isinstance(v, float)
    if branch == "bytes":
        return isinstance(v, (bytes, bytearray))
    if branch == "string":
        return isinstance(v, str)
    return False


# ---------------------------------------------------------------------------
# container files


def read_container(data: bytes) -> tuple[dict, list[Any]]:
    """Returns (file metadata, records)."""
    if data[:4] != MAGIC:
        raise ValueError("not an avro container file")
    named: dict = {}
    meta, pos = decode_value(
        {"type": "map", "values": "bytes"}, data, 4, named
    )
    sync = data[pos : pos + 16]
    pos += 16
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    records: list[Any] = []
    while pos < len(data):
        count, pos = _zigzag_decode(data, pos)
        size, pos = _zigzag_decode(data, pos)
        block = bytes(data[pos : pos + size])
        pos += size
        if data[pos : pos + 16] != sync:
            raise ValueError("avro sync marker mismatch")
        pos += 16
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bpos = 0
        for _ in range(count):
            v, bpos = decode_value(schema, block, bpos, dict(named))
            records.append(v)
    return {k: v for k, v in meta.items()}, records


def write_container(schema: dict, records: list[Any],
                    metadata: dict | None = None) -> bytes:
    named: dict = {}
    body = b"".join(encode_value(schema, r, named) for r in records)
    sync = b"\x00" * 8 + b"pathwayt"  # deterministic 16-byte marker
    meta = {
        "avro.schema": json.dumps(schema).encode(),
        "avro.codec": b"null",
        **{k: (v if isinstance(v, bytes) else str(v).encode())
           for k, v in (metadata or {}).items()},
    }
    out = MAGIC + encode_value(
        {"type": "map", "values": "bytes"}, meta, {}
    ) + sync
    if records:
        out += (_zigzag_encode(len(records)) + _zigzag_encode(len(body))
                + body + sync)
    return out
