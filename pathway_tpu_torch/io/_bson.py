"""Native BSON codec (reference: src/connectors/data_format/bson.rs, 652
LoC).  Implements the BSON 1.1 spec subset the reference emits/consumes:
double, string, document, array, binary, bool, null, int32, int64,
UTC datetime — no external bson library.

The port of ``pathway_tpu/io/_bson.py``: byte for byte the same
encodings.
"""

from __future__ import annotations

import datetime
import struct
from typing import Any


def encode_document(doc: dict) -> bytes:
    body = b"".join(
        _encode_element(str(k), v) for k, v in doc.items()
    )
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _cstr(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _encode_element(name: str, v: Any) -> bytes:
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + _cstr(name) + (b"\x01" if v else b"\x00")
    if isinstance(v, float):
        return b"\x01" + _cstr(name) + struct.pack("<d", v)
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + _cstr(name) + struct.pack("<i", v)
        return b"\x12" + _cstr(name) + struct.pack("<q", v)
    if isinstance(v, str):
        b = v.encode("utf-8") + b"\x00"
        return b"\x02" + _cstr(name) + struct.pack("<i", len(b)) + b
    if v is None:
        return b"\x0a" + _cstr(name)
    if isinstance(v, bytes):
        return (b"\x05" + _cstr(name) + struct.pack("<i", len(v))
                + b"\x00" + v)
    if isinstance(v, datetime.datetime):
        ms = int(v.timestamp() * 1000)
        return b"\x09" + _cstr(name) + struct.pack("<q", ms)
    if isinstance(v, (list, tuple)):
        arr = {str(i): x for i, x in enumerate(v)}
        return b"\x04" + _cstr(name) + encode_document(arr)
    if isinstance(v, dict):
        return b"\x03" + _cstr(name) + encode_document(v)
    from ..internals.value import Json

    if isinstance(v, Json):
        return _encode_element(name, v.value)
    return _encode_element(name, str(v))


def decode_document(data: bytes, offset: int = 0) -> tuple[dict, int]:
    """Returns (document, next_offset)."""
    (length,) = struct.unpack_from("<i", data, offset)
    end = offset + length - 1  # trailing \x00
    pos = offset + 4
    out: dict = {}
    while pos < end:
        etype = data[pos]
        pos += 1
        zero = data.index(b"\x00", pos)
        name = data[pos:zero].decode("utf-8")
        pos = zero + 1
        val, pos = _decode_value(etype, data, pos)
        out[name] = val
    return out, end + 1


def _decode_value(etype: int, data: bytes, pos: int):
    if etype == 0x01:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if etype == 0x02:
        (n,) = struct.unpack_from("<i", data, pos)
        s = data[pos + 4 : pos + 4 + n - 1].decode("utf-8")
        return s, pos + 4 + n
    if etype in (0x03, 0x04):
        doc, nxt = decode_document(data, pos)
        if etype == 0x04:
            return [doc[str(i)] for i in range(len(doc))], nxt
        return doc, nxt
    if etype == 0x05:
        (n,) = struct.unpack_from("<i", data, pos)
        return bytes(data[pos + 5 : pos + 5 + n]), pos + 5 + n
    if etype == 0x08:
        return data[pos] == 1, pos + 1
    if etype == 0x09:
        (ms,) = struct.unpack_from("<q", data, pos)
        return datetime.datetime.fromtimestamp(
            ms / 1000, datetime.timezone.utc
        ), pos + 8
    if etype == 0x0A:
        return None, pos
    if etype == 0x10:
        return struct.unpack_from("<i", data, pos)[0], pos + 4
    if etype == 0x12:
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    if etype == 0x07:  # ObjectId
        return data[pos : pos + 12].hex(), pos + 12
    if etype == 0x11:  # timestamp
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    raise ValueError(f"unsupported BSON element type 0x{etype:02x}")


def decode_stream(data: bytes) -> list[dict]:
    """Concatenated BSON documents -> list of dicts."""
    out = []
    pos = 0
    while pos < len(data):
        doc, pos = decode_document(data, pos)
        out.append(doc)
    return out
