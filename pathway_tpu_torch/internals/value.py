"""Stable 128-bit value hashing — the part of ``pathway_tpu``'s value
model the hash tokenizer needs (``hash_values`` and its canonical
serializer ``_ser``), and the ``Json`` wrapper that metadata filters
unwrap.  Kept as a copy so the port imports nothing of the
JAX package; the serialization must stay byte-identical to it, or token
ids would differ between the two packages."""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Any


class Pointer(int):
    """A 128-bit row id (tagged ``P`` by the serializer)."""

    __slots__ = ()


def _ser(value: Any, out: list[bytes]) -> None:
    """Canonical serialization for hashing. Type-tagged to avoid collisions."""
    if value is None:
        out.append(b"N")
    elif value is True:
        out.append(b"T")
    elif value is False:
        out.append(b"F")
    elif isinstance(value, Pointer):
        out.append(b"P" + int(value).to_bytes(16, "little"))
    elif isinstance(value, int):
        out.append(b"I" + value.to_bytes((value.bit_length() + 8) // 8 + 1,
                                         "little", signed=True))
    elif isinstance(value, float):
        if math.isnan(value):
            out.append(b"f" + b"nan")
        else:
            out.append(b"f" + struct.pack("<d", value))
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out.append(b"S" + len(b).to_bytes(8, "little") + b)
    elif isinstance(value, bytes):
        out.append(b"B" + len(value).to_bytes(8, "little") + value)
    elif isinstance(value, (tuple, list)):
        out.append(b"(" + len(value).to_bytes(8, "little"))
        for v in value:
            _ser(v, out)
        out.append(b")")
    elif isinstance(value, dict):
        out.append(b"{" + len(value).to_bytes(8, "little"))
        for k in sorted(value, key=str):
            _ser(str(k), out)
            _ser(value[k], out)
        out.append(b"}")
    else:
        import numpy as np

        if isinstance(value, np.ndarray):
            out.append(b"A" + str(value.dtype).encode()
                       + str(value.shape).encode() + value.tobytes())
        elif isinstance(value, np.generic):
            _ser(value.item(), out)
        elif hasattr(value, "_pw_hash_repr_"):
            _ser(value._pw_hash_repr_(), out)
        else:
            out.append(b"O" + repr(value).encode("utf-8"))


def hash_values(*values: Any) -> int:
    """128-bit stable hash of a value tuple."""
    out: list[bytes] = []
    for v in values:
        _ser(v, out)
    d = hashlib.blake2b(b"".join(out), digest_size=16).digest()
    return int.from_bytes(d, "little")


class Json:
    """A parsed JSON value: the part of ``pathway_tpu``'s ``pw.Json`` that
    metadata filters read (``value``)."""

    __slots__ = ("value",)

    def __init__(self, value: Any) -> None:
        if isinstance(value, Json):
            value = value.value
        self.value = value

    def __repr__(self) -> str:
        return f"pw.Json({self.value!r})"
