"""Value model: dynamic values, 128-bit keys (Pointers), stable hashing.

A copy of ``pathway_tpu``'s value model, kept so the port imports
nothing of the JAX package.  The serialization (``_ser``) and every key
derivation (``ref_scalar``, ``ref_pair``, ``auto_row_keys``, ...) must
stay byte-identical to it: token ids of the hash tokenizer and the row
keys of a ``pw.Table`` are equal in both packages only while they are.

Batched keys (``ref_scalar_batch``, ``ref_scalar_batch_rows``) and the
fill of ``auto_row_keys`` go through the native hash tier
(``pathway_tpu_torch/native``), as in the JAX package; its results are
bit-identical to the per-row Python code below.  A column type the tier
does not take keys per row.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import struct
import threading
from typing import Any, Iterable

_MASK128 = (1 << 128) - 1


class Pointer(int):
    """A 128-bit row id.  Subclass of int so it is cheap, hashable,
    sortable; tagged ``P`` by the serializer."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"^{int(self):032X}"[:12] + "…"


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


def ref_scalar(*values: Any) -> Pointer:
    """Derive a Pointer from values (reference: ``Key::for_values``)."""
    return Pointer(hash_values(*values) & _MASK128)


def ref_pair(a: int, b: int) -> Pointer:
    """``ref_scalar(a, b)`` for two POINTER keys, with the serializer's
    ``P`` + 16-byte little-endian bytes inlined (join output keys hash
    one per emitted pair).  Other keys go through ``ref_scalar``."""
    if type(a) is Pointer and type(b) is Pointer:
        d = hashlib.blake2b(
            b"P" + int(a).to_bytes(16, "little")
            + b"P" + int(b).to_bytes(16, "little"),
            digest_size=16,
        ).digest()
        return Pointer(int.from_bytes(d, "little") & _MASK128)
    return ref_scalar(a, b)


def _hashes_to_pointers(his, los) -> list[Pointer]:
    """(hi, lo) uint64 arrays -> Pointer list (packed bytes +
    ``from_bytes``)."""
    import numpy as np

    arr = np.empty((len(his), 2), dtype="<u8")
    arr[:, 0] = los
    arr[:, 1] = his
    buf = arr.tobytes()
    frm = int.from_bytes
    return [Pointer(frm(buf[i: i + 16], "little"))
            for i in range(0, len(buf), 16)]


def ref_scalar_batch_rows(key_rows: list, n_cols: int) -> list[Pointer] | None:
    """Batched ``ref_scalar(*row)`` over per-row key-value sequences when
    every column is uniformly int/float/str: the one typed-column
    dispatch, shared by debug tables and connector ingest.  None when a
    column's type is outside that set (or an int does not fit 64 bits):
    the caller keys per row."""
    if not key_rows:
        return None
    import numpy as np

    cols: list = []
    for j in range(n_cols):
        vals = [kv[j] for kv in key_rows]
        if all(type(v) is int for v in vals):
            try:
                cols.append(np.asarray(vals, np.int64))
            except OverflowError:
                return None
        elif all(type(v) is float for v in vals):
            cols.append(np.asarray(vals, np.float64))
        elif all(type(v) is str for v in vals):
            cols.append(vals)
        else:
            return None
    return ref_scalar_batch(cols)


def ref_scalar_batch(columns: list) -> list[Pointer] | None:
    """Batched ``ref_scalar`` over typed key columns (int64/float64
    ndarrays or list[str]) through the native blake2b tier, bit-identical
    to per-row ``ref_scalar``.  None when a column's type is outside that
    set."""
    from ..native import ref_scalar_rows_hashes

    hashed = ref_scalar_rows_hashes(columns)
    if hashed is None:
        return None
    return _hashes_to_pointers(*hashed)


def ref_scalar_with_instance(values: Iterable[Any], instance: Any) -> Pointer:
    return Pointer(hash_values(tuple(values), ("#instance", instance))
                   & _MASK128)


_SEQ_SALT = hash_values("__pathway_tpu_sequential__")


def sequential_pointer(n: int) -> Pointer:
    """Deterministic pointer for the n-th row of a generated sequence."""
    return Pointer(hash_values(_SEQ_SALT, n) & _MASK128)


_AUTO_ROW_KEYS: list[Pointer] = []
_AUTO_ROW_KEYS_LOCK = threading.Lock()
_AUTO_KEY_CACHE_MAX: int | None = None
# default cap on the process-lifetime auto-row-key memo (~50 MB per
# million keys); PATHWAY_AUTO_KEY_CACHE_MAX overrides it
_AUTO_KEY_CACHE_DEFAULT = 1_000_000


def _auto_key_cache_max() -> int:
    """Parsed once; a malformed env value logs and keeps the default."""
    global _AUTO_KEY_CACHE_MAX
    if _AUTO_KEY_CACHE_MAX is None:
        raw = os.environ.get("PATHWAY_AUTO_KEY_CACHE_MAX",
                             str(_AUTO_KEY_CACHE_DEFAULT))
        try:
            _AUTO_KEY_CACHE_MAX = int(raw)
        except ValueError:
            logging.getLogger(__name__).warning(
                "PATHWAY_AUTO_KEY_CACHE_MAX=%r is not an integer; using "
                "the %d default", raw, _AUTO_KEY_CACHE_DEFAULT)
            _AUTO_KEY_CACHE_MAX = _AUTO_KEY_CACHE_DEFAULT
    return _AUTO_KEY_CACHE_MAX


def release_auto_key_cache() -> int:
    """Drop the memoized auto-row-key prefix (and re-read the cap on
    next use); returns how many cached keys were released.  Live tables
    keep their own references to the keys they hold."""
    global _AUTO_ROW_KEYS, _AUTO_KEY_CACHE_MAX
    with _AUTO_ROW_KEYS_LOCK:
        released = len(_AUTO_ROW_KEYS)
        # rebind rather than clear(): a concurrent auto_row_keys() call
        # may still be slicing the old list it captured
        _AUTO_ROW_KEYS = []
        _AUTO_KEY_CACHE_MAX = None
    return released


def _auto_keys_range(start: int, stop: int) -> list[Pointer]:
    """``ref_scalar("#row", i)`` for ``start <= i < stop`` through the
    native tier."""
    if stop <= start:
        return []
    from ..native import auto_row_keys_hashes

    return _hashes_to_pointers(*auto_row_keys_hashes(start, stop - start))


def _py_auto_keys_range(start: int, stop: int) -> list[Pointer]:
    """The plain version of ``_auto_keys_range``: ``_ser("#row") +
    _ser(i)`` inlined (identical bytes) into blake2b."""
    prefix = b"S" + (4).to_bytes(8, "little") + b"#row" + b"I"
    blake2b = hashlib.blake2b
    frm = int.from_bytes
    out = []
    for i in range(start, stop):
        data = prefix + i.to_bytes((i.bit_length() + 8) // 8 + 1,
                                   "little", signed=True)
        d = blake2b(data, digest_size=16).digest()
        out.append(Pointer(frm(d, "little") & _MASK128))
    return out


def auto_row_keys(n: int) -> list[Pointer]:
    """Keys for auto-numbered rows — ``ref_scalar("#row", i)`` memoized
    per process (every static-table builder regenerates the same prefix).
    Beyond the cap the prefix stays cached and the tail is computed per
    call."""
    cap = _auto_key_cache_max()
    if n > cap:
        return auto_row_keys(cap) + _auto_keys_range(cap, n)
    cache = _AUTO_ROW_KEYS
    if len(cache) < n:
        with _AUTO_ROW_KEYS_LOCK:  # concurrent fills must not interleave
            cache.extend(_auto_keys_range(len(cache), n))
    return cache[:n]


class Json:
    """pw.Json — wrapper for parsed JSON values.

    Its hash serializes the value (``json.dumps``) once per object: the
    engine hashes a row at every consolidation, and a value holding an
    array (a CLIP embedding in a parser's metadata) formats it through
    numpy each time otherwise.  A Json's value is not mutated once it is
    in a table."""

    __slots__ = ("value", "_pw_repr")

    def __init__(self, value: Any) -> None:
        if isinstance(value, Json):
            value = value.value
        self.value = value

    # -- accessors ---------------------------------------------------------
    def __getitem__(self, item: Any) -> "Json":
        return Json(self.value[item])

    def get(self, key: Any, default: Any = None) -> Any:
        if isinstance(self.value, dict):
            v = self.value.get(key, default)
        elif isinstance(self.value, list) and isinstance(key, int):
            v = (self.value[key] if -len(self.value) <= key < len(self.value)
                 else default)
        else:
            v = default
        return Json(v) if not isinstance(v, Json) else v

    def as_int(self) -> int | None:
        return (self.value if isinstance(self.value, int)
                and not isinstance(self.value, bool) else None)

    def as_float(self) -> float | None:
        if isinstance(self.value, bool):
            return None
        return (float(self.value) if isinstance(self.value, (int, float))
                else None)

    def as_str(self) -> str | None:
        return self.value if isinstance(self.value, str) else None

    def as_bool(self) -> bool | None:
        return self.value if isinstance(self.value, bool) else None

    def as_list(self) -> list | None:
        return self.value if isinstance(self.value, list) else None

    def as_dict(self) -> dict | None:
        return self.value if isinstance(self.value, dict) else None

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Json):
            return self.value == other.value
        return self.value == other

    def __hash__(self) -> int:
        return hash_values(self._pw_hash_repr_()) & 0x7FFFFFFFFFFFFFFF

    def _pw_hash_repr_(self) -> Any:
        import json as _json

        cached = getattr(self, "_pw_repr", None)
        if cached is not None and cached[0] is self.value:
            return cached[1]
        out = ("#json", _json.dumps(self.value, sort_keys=True, default=str))
        self._pw_repr = (self.value, out)
        return out

    def __repr__(self) -> str:
        return f"pw.Json({self.value!r})"

    def __str__(self) -> str:
        import json as _json

        return _json.dumps(self.value, default=str)

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        import json as _json

        return Json(_json.loads(s))

    @staticmethod
    def dumps(value: Any) -> str:
        import json as _json

        if isinstance(value, Json):
            value = value.value
        return _json.dumps(value, default=str)

    NULL: "Json"


Json.NULL = Json(None)


class Error:
    """Singleton error value (reference: ``Value::Error``).

    Poisoning semantics: any expression consuming an Error yields Error.
    """

    _instance: "Error | None" = None

    def __new__(cls) -> "Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def _pw_hash_repr_(self) -> Any:
        return ("#error",)


ERROR = Error()


class Pending:
    """Singleton placeholder for fully-async UDF results."""

    _instance: "Pending | None" = None

    def __new__(cls) -> "Pending":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Pending"

    def _pw_hash_repr_(self) -> Any:
        return ("#pending",)


PENDING = Pending()
