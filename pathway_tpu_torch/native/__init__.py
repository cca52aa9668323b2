"""ctypes bindings for the native hash tier (``src/pw_native.cpp``).

The port of ``pathway_tpu/native``: the same C++ source, byte for byte,
built at first use with ``g++`` and the same flags into
``pathway_tpu_torch/_build/`` (never next to the source).  The library
is named by a hash of its source, its flags and the host's CPU (what
``-march=native`` compiles for), so an edited source, or a ``_build/``
carried to another CPU, is rebuilt and an unchanged one is reused;
concurrent builders each write their own file and move it into place.

Its 128-bit hash keys the rows of a file read without a primary key
(``io/_utils._auto_keys``), and its blake2b tier batches the canonical
row keys (``internals/value.ref_scalar_batch``, ``auto_row_keys``); both
are bit-identical to the Python code, which the keys of persisted
journals depend on.  Before the library is adopted, its hash is checked
against the Python mirror on a probe.

Unlike the JAX package, which falls back to Python quietly, a failed
build or a failed self-test raises with the compiler's output.  The
``_py_*`` functions are the plain versions the tests hold the library
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "pw_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _host_cpu() -> bytes:
    """The machine and its CPU's feature flags: a library built with
    ``-march=native`` on another CPU may not run on this one."""
    flags = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags}".encode()


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _host_cpu()).hexdigest()
    return BUILD_DIR / f"libpw_native-{digest[:16]}.so"


def _build() -> Path:
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise RuntimeError(
            f"g++ failed to build {SRC} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a torn file
    return out


def _bind(lib) -> None:
    lib.pw_hash128.restype = None
    lib.pw_hash128.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_uint64, _U64P, _U64P]
    lib.pw_hash_rows.restype = None
    lib.pw_hash_rows.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(_I64P),
        ctypes.c_uint64, _U64P, _U64P]
    lib.pw_consolidate.restype = ctypes.c_int64
    lib.pw_consolidate.argtypes = [ctypes.c_uint64, _U64P, _U64P, _U64P,
                                   _I64P, _I64P, _I64P]
    lib.pw_auto_row_keys.restype = None
    lib.pw_auto_row_keys.argtypes = [ctypes.c_int64, ctypes.c_uint64,
                                     _U64P, _U64P]
    lib.pw_ref_scalar_rows.restype = None
    lib.pw_ref_scalar_rows.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(_I64P),
        _U64P, _U64P]


def get_lib():
    """The loaded library, built and self-tested on first use; raises
    when either fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        # self-test against the Python mirror before adopting the library:
        # a foreign or stale .so must never become the canonical row-key
        # hash
        hi = ctypes.c_uint64()
        lo = ctypes.c_uint64()
        probe = b"pw-native-selftest\x00\x01\x02"
        lib.pw_hash128(probe, len(probe), 12345,
                       ctypes.byref(hi), ctypes.byref(lo))
        got = (hi.value << 64) | lo.value
        want = _py_hash128(probe, 12345)
        if got != want:
            raise RuntimeError(
                f"{so}: pw_hash128 self-test gave {got:#x}, the Python "
                f"mirror {want:#x}; remove the library to rebuild it")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Pure-Python mirror of pw_native.cpp's hash — bit-identical.
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


class _PyHashState:
    __slots__ = ("a", "b")

    def __init__(self, seed: int):
        self.a = 0x9E3779B97F4A7C15 ^ seed
        self.b = 0xBF58476D1CE4E5B9 ^ ((seed * 0x94D049BB133111EB + 1) & _M64)

    def update_u64(self, v: int) -> None:
        self.a = (_mix64(self.a ^ v) * 0x2545F4914F6CDD1D) & _M64
        self.b = _mix64((self.b + v + 0x165667B19E3779F9) & _M64)

    def update_bytes(self, data: bytes) -> None:
        i, ln = 0, len(data)
        while i + 8 <= ln:
            self.update_u64(int.from_bytes(data[i: i + 8], "little"))
            i += 8
        rem = ln - i
        if rem:
            tail = int.from_bytes(data[i:] + b"\0" * (8 - rem), "little")
            self.update_u64(tail ^ ((rem << 56) & _M64))
        self.update_u64(ln ^ 0xA5A5A5A5A5A5A5A5)

    def final(self) -> tuple[int, int]:
        hi = _mix64(self.a ^ (self.b >> 32))
        lo = _mix64(self.b ^ ((self.a << 17) & _M64) ^ 0x27D4EB2F165667C5)
        return hi, lo


def _py_hash128(data: bytes, seed: int = 0) -> int:
    s = _PyHashState(seed & _M64)
    s.update_bytes(data)
    hi, lo = s.final()
    return (hi << 64) | lo


def hash128(data: bytes, seed: int = 0) -> int:
    lib = get_lib()
    hi = ctypes.c_uint64()
    lo = ctypes.c_uint64()
    lib.pw_hash128(data, len(data), seed & _M64,
                   ctypes.byref(hi), ctypes.byref(lo))
    return (hi.value << 64) | lo.value


def _py_hash_rows(columns: list, seed: int = 0) -> np.ndarray:
    """Bit-identical Python mirror of pw_hash_rows."""
    import struct

    n = len(columns[0]) if columns else 0
    prepared = []
    for col in columns:
        if isinstance(col, np.ndarray) and col.dtype == np.int64:
            prepared.append((0, col))
        elif isinstance(col, np.ndarray) and col.dtype == np.float64:
            prepared.append((1, col))
        else:
            prepared.append(
                (2, [v.encode() if isinstance(v, str) else bytes(v)
                     for v in col]))
    out = np.empty(n, dtype=object)
    for i in range(n):
        s = _PyHashState(seed & _M64)
        for kind, col in prepared:
            s.update_u64(0x1000 + kind)
            if kind == 0:
                s.update_u64(int(col[i]) & _M64)
            elif kind == 1:
                s.update_u64(
                    int.from_bytes(struct.pack("<d", float(col[i])), "little"))
            else:
                s.update_bytes(col[i])
        hi, lo = s.final()
        out[i] = (hi << 64) | lo
    return out


class _Columns:
    """Typed columns marshalled for the C functions: int64 and float64
    arrays by pointer, byte strings packed with offsets.  ``strict``
    takes only ``list[str]`` for the third kind (the blake2b tier
    serializes ``str``); else ``None`` when a column is of another
    type."""

    def __init__(self, columns: list, n: int, strict: bool):
        self.ok = True
        kinds, values, offsets, self._keep = [], [], [], []
        for col in columns:
            if isinstance(col, np.ndarray) and col.dtype in (np.int64,
                                                             np.float64):
                kinds.append(0 if col.dtype == np.int64 else 1)
                c = np.ascontiguousarray(col)
                self._keep.append(c)
                values.append(c.ctypes.data)
                offsets.append(None)
                continue
            if strict and not (isinstance(col, list)
                               and all(isinstance(v, str) for v in col)):
                self.ok = False
                return
            kinds.append(2)
            bufs = [v.encode() if isinstance(v, str) else bytes(v)
                    for v in col]
            off = np.zeros(n + 1, np.int64)
            np.cumsum([len(b) for b in bufs], out=off[1:])
            raw = b"".join(bufs)
            cbuf = ctypes.create_string_buffer(raw, len(raw) or 1)
            self._keep.extend([cbuf, off])
            values.append(ctypes.addressof(cbuf))
            offsets.append(off.ctypes.data_as(_I64P))
        k = len(columns)
        self.k = k
        self.kinds = (ctypes.c_int32 * k)(*kinds)
        self.values = ctypes.cast((ctypes.c_void_p * k)(*values),
                                  ctypes.POINTER(ctypes.c_void_p))
        self.offsets = (_I64P * k)(*[o if o is not None else _I64P()
                                     for o in offsets])


def _out(n: int):
    hi = np.empty(n, np.uint64)
    lo = np.empty(n, np.uint64)
    return hi, lo, hi.ctypes.data_as(_U64P), lo.ctypes.data_as(_U64P)


def hash_rows_hashes(columns: list, seed: int = 0):
    """(hi, lo) uint64 arrays of pw_hash_rows over typed columns (int64
    arrays, float64 arrays, lists of bytes or str)."""
    n = len(columns[0]) if columns else 0
    lib = get_lib()
    hi, lo, phi, plo = _out(n)
    if n:
        cols = _Columns(columns, n, strict=False)
        lib.pw_hash_rows(n, cols.k, cols.kinds, cols.values, cols.offsets,
                         seed & _M64, phi, plo)
    return hi, lo


def hash_rows(columns: list, seed: int = 0) -> np.ndarray:
    """Batch-hash rows from typed columns -> uint128 as an (n,) object
    array of ints.  Columns: int64 arrays, float64 arrays, or lists of
    bytes/str; equal to ``_py_hash_rows`` bit for bit."""
    hi, lo = hash_rows_hashes(columns, seed)
    return np.array([(h << 64) | l for h, l in zip(hi.tolist(), lo.tolist())],
                    dtype=object)


def auto_row_keys_hashes(start: int, n: int):
    """(hi, lo) uint64 arrays of blake2b16(_ser("#row") + _ser(i)) for
    i in [start, start+n): the native fill of ``value.auto_row_keys``."""
    lib = get_lib()
    hi, lo, phi, plo = _out(max(n, 0))
    if n > 0:
        lib.pw_auto_row_keys(start, n, phi, plo)
    return hi, lo


def ref_scalar_rows_hashes(columns: list):
    """(hi, lo) uint64 arrays of the canonical key hash (blake2b16 over
    ``_ser`` of each row's values) for typed columns: int64 ndarray,
    float64 ndarray, or list[str].  None when a column's type is outside
    that set (the caller keys per row)."""
    if not columns:
        return None
    n = len(columns[0])
    if n == 0:
        return None
    cols = _Columns(columns, n, strict=True)
    if not cols.ok:
        return None
    lib = get_lib()
    hi, lo, phi, plo = _out(n)
    lib.pw_ref_scalar_rows(n, cols.k, cols.kinds, cols.values, cols.offsets,
                           phi, plo)
    return hi, lo


def _py_consolidate(key_hi, key_lo, row_tag, diffs):
    acc: dict = {}
    for i in range(len(diffs)):
        k = (int(key_hi[i]), int(key_lo[i]), int(row_tag[i]))
        if k in acc:
            acc[k][1] += int(diffs[i])
        else:
            acc[k] = [i, int(diffs[i])]
    pairs = sorted((v for v in acc.values() if v[1] != 0), key=lambda p: p[0])
    return (np.array([p[0] for p in pairs], np.int64),
            np.array([p[1] for p in pairs], np.int64))


def consolidate_hashed(key_hi: np.ndarray, key_lo: np.ndarray,
                       row_tag: np.ndarray, diffs: np.ndarray):
    """Returns (surviving first-occurrence indices, net diffs)."""
    n = len(diffs)
    lib = get_lib()
    out_index = np.empty(n, np.int64)
    out_diff = np.empty(n, np.int64)
    hi = np.ascontiguousarray(key_hi, np.uint64)
    lo = np.ascontiguousarray(key_lo, np.uint64)
    tag = np.ascontiguousarray(row_tag, np.uint64)
    d = np.ascontiguousarray(diffs, np.int64)
    m = lib.pw_consolidate(
        n, hi.ctypes.data_as(_U64P), lo.ctypes.data_as(_U64P),
        tag.ctypes.data_as(_U64P), d.ctypes.data_as(_I64P),
        out_index.ctypes.data_as(_I64P), out_diff.ctypes.data_as(_I64P))
    return out_index[:m].copy(), out_diff[:m].copy()
