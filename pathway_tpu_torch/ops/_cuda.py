"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with
``ctypes``.  Nothing here runs at import: the first launch on a CUDA
tensor builds (or finds) the library, so importing the package never
needs ``nvcc``.  Libraries are named by a hash of their source and
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels; the count is taken under a lock, since replicas of
a serving fleet launch from their own threads.  A sharded program
launches once per shard, so at tensor-parallel degree tp a layer's
kernel counts tp launches (each at H/tp heads).

A launch runs on the device its tensors are on, on that device's current
stream (a shard on ``cuda:1`` is launched there, not on the current
device): each wrapper holds every operand to one device with
:func:`check` and passes that device to :func:`launch`, which makes it
current around the C call when it is not (the ``cudaFuncSetAttribute``
opt-ins apply per device).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: source file -> {C function name: argtypes}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES = {
    "flash_attention.cu": {
        # q, k, v, out; B, T, H, hd; (batch, token, head) strides of q, k
        # and v in elements; causal, dtype; scale; stream
        "pw_flash_attention": [_P] * 4 + [_I] * 4 + [_L] * 9 + [_I] * 2
                              + [_F, _P],
    },
    "paged_attention.cu": {
        # q, k_pool, v_pool, out, block_tables, c0, cl, scratch, counters;
        # B, C, H, hd, BS, NBT, split, n_split, dtype; scale; stream
        "pw_paged_attention": [_P] * 9 + [_I] * 9 + [_F, _P],
        # q, k_new, v_new, k_pool, v_pool, out, block_tables, cl,
        # slot_blocks, slot_offsets, scratch, counters; B, H, hd, BS, NBT,
        # split, n_split, dtype; scale; stream
        "pw_paged_append_attend": [_P] * 12 + [_I] * 8 + [_F, _P],
    },
    "knn_scores.cu": {
        # queries, matrix, out; Q, N, d; stream (GEMM for Q >= 16, GEMV
        # for Q < 16)
        "pw_knn_scores_gemm": [_P] * 3 + [_I] * 3 + [_P],
        "pw_knn_scores_gemv": [_P] * 3 + [_I] * 3 + [_P],
    },
}

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first launch on a CUDA tensor"
    )


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def _start_build(source: str):
    """Start one nvcc process for ``source``; None when already built."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source, one nvcc per source, all started
    together; returns each source's compiler log (registers, shared
    memory and spills from ``-Xptxas -v``; empty when already built)."""
    with _LOCK:
        jobs = {s: _start_build(s) for s in SOURCES}
        return {s: (_finish_build(s, j) if j is not None else "")
                for s, j in jobs.items()}


def lib(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it on first use."""
    with _LOCK:
        handle = _LIBS.get(source)
        if handle is not None:
            return handle
        job = _start_build(source)
        if job is not None:
            _finish_build(source, job)
        handle = ctypes.CDLL(str(_lib_path(source)))
        for fn, argtypes in SOURCES[source].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        _LIBS[source] = handle
        return handle


def launch(source: str, fn: str, name: str, device: torch.device,
           *args) -> None:
    """Call C function ``fn`` on the current stream of ``device``, the
    device of the launch's tensors (the wrapper's :func:`check` holds
    them to it), with that device current; raise on a non-zero
    ``cudaGetLastError()``, and count the launch under ``name``."""
    call = getattr(lib(source), fn)
    if device.index == torch.cuda.current_device():
        err = call(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = call(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, *, dtype=None, ndim=None,
          device=None) -> None:
    """Device/dtype/shape/contiguity checks a kernel's inputs must pass;
    ``device``: the device every input of the launch must share."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != torch.device(device):
        raise ValueError(f"{name} is on {t.device}, the launch's other "
                         f"operands on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.ndim}")
