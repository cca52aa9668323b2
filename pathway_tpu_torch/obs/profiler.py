"""Device cost observatory: the program registry and per-dispatch profiles
(the port of ``pathway_tpu/obs/profiler.py``).

Nothing is jitted here, so the reference's ``profiled_jit`` becomes
``profiled(program, fn)``, returning a :class:`ProfiledFunction`.  The
registry, records, surfaces and probes keep their reference names; only
the mechanics change:

- **Bucket**: a call's bucket is the signature of its tensor arguments,
  labelled in the reference's format (``f32[2,96,4,8,8]``, ``tree(n)``
  for a parameter dict).  The HBM ledger finds a program's measured temp
  watermark by the pool shape in that label.
- **Compile event**: the FIRST CALL of a bucket through a wrapper, with
  its wall time (lazy ``nvcc`` build, cuBLAS handles, allocator growth)
  and a stack summary — so ``total_compiles()`` / ``compile_events(
  since=)`` keep their meaning, and a guard names the call site that
  brought a new shape.  A bucket seen before by another wrapper (another
  engine of the same configuration) is marked redundant.
- **Cost**: FLOPs and bytes of a bucket are counted once, over its first
  call: a dispatch mode applies ``torch.utils.flop_counter``'s formulas
  and counts bytes for the aten operations, plus what each hand-written
  kernel's wrapper reports through :func:`add_kernel_cost` (a ctypes
  launch is invisible to both modes).  So a K-step chained program
  counts K single steps.
- **Dispatch windows**: :meth:`ProfiledFunction.record_dispatch` keeps
  the reference's host window (dispatch -> the engine's sync,
  ``perf_counter``).  On the card each call also records a pair of
  ``torch.cuda.Event(enable_timing=True)`` on the current stream around
  the dispatch; a pair is read only when the engine's record of the
  window arrives, which the engine makes after its own device->host sync
  has passed the pair, so no synchronise is added.  An event window is
  the stream's wall time between the two events, gaps where the host had
  not yet issued included (``device_window_ms``), not busy time.  While
  ``torch.profiler`` records, each call is also a ``record_function``
  range named for its program, so a trace attributes kernels (busy
  time) to the programs that launched them.
- **Memory**: ``ProgramRecord.try_memory()`` stays on demand: it arms a
  measurement of the bucket's NEXT call (the peak of
  ``torch.cuda.max_memory_allocated`` over the call above
  ``memory_allocated`` before it) and returns what is recorded, None
  until then and always None on the CPU.  ``reset_peak_memory_stats`` is
  global to the process, so it never runs unasked.
- **Roofline probes**: :func:`measured_peak_flops` times a bf16 and an
  f32 GEMM, :func:`measured_membw` a copy of 1 GiB (larger than the
  card's L2), both with CUDA events; on the CPU a 1024^3 f32 matmul and a
  32 MB array.  A failing probe raises (the reference returns None).

The registry is process-global, monotonic and taken under a lock (every
replica's scheduler thread writes it).
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from collections import deque

import torch
# bounded per-(program, bucket) dispatch samples: sized so a bench
# window's dispatches never evict mid-window
_RESERVOIR = 1024
_STACK_DEPTH = 6  # app frames kept per compile event

_DT = {"float32": "f32", "int32": "i32", "bfloat16": "bf16",
       "float16": "f16", "int8": "i8", "bool": "b1", "float64": "f64",
       "int64": "i64", "uint8": "u8"}


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _dtype_name(t) -> str:
    dt = str(t.dtype).replace("torch.", "")
    return _DT.get(dt, dt)


def _leaf_sig(leaf):
    if _is_tensor(leaf):
        return (leaf.dtype, leaf.shape)
    return ("lit", repr(leaf)[:32])


def _sig_one(a):
    """Signature of ONE argument: tensors by dtype/shape, parameter trees
    by their leaves' signatures, a Python number by its type (a traced
    scalar: its value does not make a new bucket), anything else by a
    bounded repr."""
    if _is_tensor(a):
        return _leaf_sig(a)
    if isinstance(a, (dict, list, tuple)):
        leaves = _leaves(a)
        return ("tree", len(leaves), tuple(_leaf_sig(l) for l in leaves))
    if isinstance(a, (bool, int, float)):
        return ("scalar", type(a).__name__)
    return ("lit", repr(a)[:32])


def _label_one(a) -> str:
    if _is_tensor(a):
        return f"{_dtype_name(a)}[{','.join(str(d) for d in a.shape)}]"
    if isinstance(a, (dict, list, tuple)):
        return f"tree({len(_leaves(a))})"
    return repr(a)[:16]


def _bucket_label(args, kwargs) -> str:
    """Human-readable short form of the bucket for tables and metrics:
    ``f32[8,112]+tree(21)+i32[8]`` — trees collapse to a leaf count."""
    parts = [_label_one(a) for a in args]
    parts += [f"{k}={_label_one(kwargs[k])}" for k in sorted(kwargs)]
    out = "+".join(parts)
    return out if len(out) <= 160 else out[:157] + "..."


def _stand_in(a):
    """A memoryless stand-in with ``a``'s signature."""
    if _is_tensor(a):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if isinstance(a, (dict, list, tuple)):
        return {}
    return a


def _stack_summary() -> list[str]:
    """The last few APPLICATION frames of the triggering call (profiler
    and torch internals dropped) — the first-call provenance."""
    frames = traceback.extract_stack()
    keep = [
        f for f in frames
        if "obs/profiler" not in f.filename.replace("\\", "/")
        and os.sep + "torch" + os.sep not in f.filename
    ]
    return [
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in keep[-_STACK_DEPTH:]
    ]


# -- cost counting ----------------------------------------------------------

_COST = threading.local()


def add_kernel_cost(flops: float, nbytes: float) -> None:
    """A hand-written kernel's wrapper reports the work of one launch
    (the operations and bytes its roofline bound uses).  Counted only
    while a bucket's first call is being costed on this thread; a no-op
    otherwise."""
    acc = getattr(_COST, "acc", None)
    if acc is not None:
        acc[0] += float(flops)
        acc[1] += float(nbytes)


def counting_cost() -> bool:
    """True while a bucket's first call is being costed on this thread
    (a kernel wrapper then reads its data-dependent work once)."""
    return getattr(_COST, "acc", None) is not None


def _cost_mode():
    """A dispatch mode counting each aten operation's FLOPs (the formulas
    of ``torch.utils.flop_counter.flop_registry``: the products and
    convolutions) and the bytes it reads and writes: views move nothing;
    an in-place or indexed write counts the values it writes (read once,
    written once), not the whole destination; a gather counts what it
    reads (its output) and its indices.  ``FlopCounterMode`` itself is
    not entered: it imports the compiler stack into the process."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    gathers = {"index", "index_select", "gather", "embedding",
               "take_along_dim"}

    def nbytes(x) -> int:
        return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
            else 0

    class _Cost(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if func.is_view:
                return out
            name = func.overloadpacket.__name__
            ins = [l for l in _leaves(list(args) + list(kwargs.values()))
                   if isinstance(l, torch.Tensor)]
            outs = [l for l in _leaves(out) if isinstance(l, torch.Tensor)]
            if func._schema.is_mutable:
                self.bytes += 2 * sum(nbytes(t) for t in ins[1:])
            elif name in gathers:
                idx = [t for t in ins[1:] if not t.is_floating_point()]
                self.bytes += 2 * sum(nbytes(t) for t in outs) \
                    + sum(nbytes(t) for t in idx)
            else:
                self.bytes += sum(nbytes(t) for t in ins) \
                    + sum(nbytes(t) for t in outs)
            return out

    return _Cost()


def _costed_call(fn, args, kwargs):
    """Run ``fn`` once under the cost mode: ``(out, flops, bytes)``."""
    prev = getattr(_COST, "acc", None)
    acc = _COST.acc = [0.0, 0.0]
    try:
        with _cost_mode() as mode:
            out = fn(*args, **kwargs)
    finally:
        _COST.acc = prev
    return out, float(mode.flops) + acc[0], float(mode.bytes) + acc[1]


class CompileEvent:
    """One first call of a bucket: which program, what shapes, how long
    it took, and where the call came from."""

    __slots__ = ("seq", "program", "bucket", "label", "compile_s",
                 "redundant", "stack", "t_wall")

    def __init__(self, seq: int, program: str, bucket: tuple, label: str,
                 compile_s: float, redundant: bool, stack: list[str]):
        self.seq = seq
        self.program = program
        self.bucket = bucket
        self.label = label
        self.compile_s = compile_s
        # True when this (program, bucket) had been first-called before in
        # this process (another engine of the same configuration)
        self.redundant = redundant
        self.stack = stack
        self.t_wall = time.time()

    def describe(self) -> str:
        kind = "RECOMPILE" if self.redundant else "compile"
        lines = [
            f"{kind} #{self.seq}: {self.program} [{self.label}] "
            f"({self.compile_s:.3f}s)",
            "  triggering args: " + self.label,
        ]
        lines += [f"    {frame}" for frame in self.stack]
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "seq": self.seq, "program": self.program, "bucket": self.label,
            "compile_s": round(self.compile_s, 4),
            "redundant": self.redundant, "stack": list(self.stack),
        }


class ProgramRecord:
    """Everything known about one (program, bucket): first-call cost, the
    counted FLOPs/bytes, the on-demand memory watermark, and the bounded
    host and device dispatch reservoirs."""

    __slots__ = ("program", "bucket", "label", "n_compiles",
                 "compile_s_total", "analysis", "mem", "_wrapper_ref",
                 "reservoir", "dispatch_s_total", "dispatches",
                 "items_total", "calls", "device_reservoir",
                 "device_s_total", "device_windows", "device_unread")

    def __init__(self, program: str, bucket: tuple, label: str):
        self.program = program
        self.bucket = bucket
        self.label = label
        self.n_compiles = 0
        self.compile_s_total = 0.0
        self.analysis: dict | None = None  # {"flops", "bytes_accessed"}
        self.mem: dict | None = None  # {"temp", "argument", "output"} bytes
        self._wrapper_ref = None  # weakref to the newest owning wrapper
        # (t_end_perf_counter, duration_s, items) host windows
        self.reservoir: deque = deque(maxlen=_RESERVOIR)
        self.dispatch_s_total = 0.0
        self.dispatches = 0
        self.items_total = 0
        self.calls = 0
        # (t_end_perf_counter, event window s) on the card
        self.device_reservoir: deque = deque(maxlen=_RESERVOIR)
        self.device_s_total = 0.0
        self.device_windows = 0
        # windows whose event pair had not completed when recorded
        self.device_unread = 0

    def try_analyze(self) -> dict | None:
        """FLOPs / bytes counted over the bucket's first call."""
        return self.analysis

    def try_memory(self) -> dict | None:
        """The temp/argument/output bytes of one measured call of this
        bucket.  On the card this ARMS a measurement of the bucket's next
        call when none is recorded yet (on demand only: it resets the
        process's peak-memory statistics); None until that call, and
        always None on the CPU."""
        if self.mem is None:
            wrapper = self._wrapper_ref() if self._wrapper_ref else None
            if wrapper is not None and wrapper._cuda is not None:
                wrapper._mem_armed.add(self.bucket)
        return self.mem

    # -- dispatch stats ----------------------------------------------------
    def ms_percentile(self, q: float) -> float | None:
        if not self.reservoir:
            return None
        durs = sorted(d for _t, d, _i in self.reservoir)
        idx = min(int(q * len(durs)), len(durs) - 1)
        return durs[idx] * 1e3

    def device_ms_percentile(self, q: float) -> float | None:
        if not self.device_reservoir:
            return None
        durs = sorted(d for _t, d in self.device_reservoir)
        idx = min(int(q * len(durs)), len(durs) - 1)
        return durs[idx] * 1e3

    def as_row(self, peak_flops=None, membw=None, memory: bool = False,
               analyze: bool = True) -> dict:
        mem = self.try_memory() if memory else self.mem
        flops = (self.analysis or {}).get("flops")
        nbytes = (self.analysis or {}).get("bytes_accessed")
        ms_p50 = self.ms_percentile(0.5)
        achieved = (
            flops / (ms_p50 / 1e3) if flops and ms_p50 else None
        )
        ai = flops / nbytes if flops and nbytes else None
        dev_p50 = self.device_ms_percentile(0.5)
        row = {
            "program": self.program,
            "bucket": self.label,
            "n_compiles": self.n_compiles,
            "compile_s": round(self.compile_s_total, 4),
            "calls": self.calls,
            "dispatches": self.dispatches,
            "dispatch_s_total": round(self.dispatch_s_total, 4),
            "dispatch_ms_p50": round(ms_p50, 4) if ms_p50 else None,
            "dispatch_ms_min": (
                round(min(d for _t, d, _i in self.reservoir) * 1e3, 4)
                if self.reservoir else None
            ),
            "device_windows": self.device_windows,
            "device_window_ms": (
                round(self.device_s_total * 1e3, 4)
                if self.device_windows else None
            ),
            "device_window_ms_p50": (
                round(dev_p50, 4) if dev_p50 is not None else None
            ),
            "device_unread": self.device_unread,
            "items_total": self.items_total,
            "flops": flops,
            "bytes_accessed": nbytes,
            "arithmetic_intensity": round(ai, 3) if ai else None,
            "achieved_flops_per_s": (
                round(achieved, 1) if achieved else None
            ),
        }
        if mem:
            row["memory"] = dict(mem)
        # roofline placement: where this program sits against the
        # machine's peak-FLOPs / memory-bandwidth roof
        if peak_flops and achieved:
            row["mfu"] = round(achieved / peak_flops, 5)
        if peak_flops and membw and ai:
            ridge = peak_flops / membw
            attainable = min(peak_flops, ai * membw)
            row["roofline"] = {
                "bound": "memory" if ai < ridge else "compute",
                "ridge_ai": round(ridge, 2),
                "attainable_flops_per_s": round(attainable, 1),
                "attained_frac": (
                    round(achieved / attainable, 4) if achieved else None
                ),
            }
        return row


class ProgramRegistry:
    """Process-global table of profiled device programs."""

    def __init__(self):
        self._lock = threading.RLock()
        self._records: dict[tuple, ProgramRecord] = {}
        self._events: list[CompileEvent] = []
        self._n_compiles = 0
        self._n_redundant = 0

    # -- recording ---------------------------------------------------------
    def record_compile(self, wrapper, sig: tuple, label: str,
                       compile_s: float, cost: tuple | None
                       ) -> ProgramRecord:
        import weakref

        key = (wrapper.program, sig)
        with self._lock:
            rec = self._records.get(key)
            redundant = rec is not None and rec.n_compiles > 0
            if rec is None:
                rec = self._records[key] = ProgramRecord(
                    wrapper.program, sig, label
                )
            rec.n_compiles += 1
            rec.compile_s_total += compile_s
            rec._wrapper_ref = weakref.ref(wrapper)
            if cost is not None and rec.analysis is None:
                rec.analysis = {"flops": cost[0] or None,
                                "bytes_accessed": cost[1] or None}
            self._n_compiles += 1
            if redundant:
                self._n_redundant += 1
            self._events.append(CompileEvent(
                self._n_compiles, wrapper.program, sig, label, compile_s,
                redundant, _stack_summary(),
            ))
            # failure loops could otherwise grow the event list without
            # bound; the registry keeps the newest few thousand
            if len(self._events) > 4096:
                del self._events[:1024]
        return rec

    def record_dispatch(self, program: str, key: tuple | None,
                        duration_s: float, t_end: float,
                        items: int | None, device_s: float | None = None,
                        device_unread: bool = False) -> None:
        with self._lock:
            if key is not None:
                rec = self._records.get(key)
            else:
                # a multi-bucket wrapper: aggregate under a program-level
                # pseudo bucket
                rec = self._records.get((program, ("*",)))
                if rec is None:
                    rec = self._records[(program, ("*",))] = ProgramRecord(
                        program, ("*",), "*"
                    )
            if rec is None:
                return
            rec.reservoir.append((t_end, duration_s, items or 0))
            rec.dispatch_s_total += duration_s
            rec.dispatches += 1
            if items:
                rec.items_total += items
            if device_s is not None:
                rec.device_reservoir.append((t_end, device_s))
                rec.device_s_total += device_s
                rec.device_windows += 1
            if device_unread:
                rec.device_unread += 1

    # -- reading -----------------------------------------------------------
    def total_compiles(self) -> int:
        with self._lock:
            return self._n_compiles

    def compile_events(self, since: int = 0) -> list[CompileEvent]:
        """Events with seq > ``since`` (pair with :meth:`total_compiles`
        for a begin/end guard)."""
        with self._lock:
            return [e for e in self._events if e.seq > since]

    def records(self) -> list[ProgramRecord]:
        with self._lock:
            return list(self._records.values())

    def totals(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
            return {
                "n_device_programs": len(
                    {(r.program, r.bucket) for r in recs if r.n_compiles}
                ),
                "n_compiles": self._n_compiles,
                "recompiles_total": self._n_redundant,
                "compile_s_total": round(
                    sum(r.compile_s_total for r in recs), 4
                ),
                "dispatch_s_total": round(
                    sum(r.dispatch_s_total for r in recs), 4
                ),
                "device_window_s_total": round(
                    sum(r.device_s_total for r in recs), 4
                ),
            }

    def max_temp_bytes(self, prefix: str = "", cached_only: bool = True,
                       bucket_contains: str | None = None) -> int | None:
        """Largest known temp watermark over matching programs — the HBM
        ledger's measured input.  ``cached_only`` (default) never arms a
        measurement.  ``bucket_contains`` restricts the match to records
        whose bucket label carries the substring (the ledger passes the
        pool shape, so one engine's fit check is never contaminated by
        another model's watermark)."""
        best = None
        for rec in self.records():
            if prefix and not rec.program.startswith(prefix):
                continue
            if bucket_contains and bucket_contains not in rec.label:
                continue
            mem = rec.mem if cached_only else rec.try_memory()
            if mem and mem.get("temp_bytes") is not None:
                best = max(best or 0, mem["temp_bytes"])
        return best

    # -- summary / export --------------------------------------------------
    def summary(self, *, peak_flops=None, membw=None, analyze: bool = True,
                memory: bool = False) -> dict:
        if analyze and peak_flops is None:
            peak_flops = measured_peak_flops()
        if analyze and membw is None:
            membw = measured_membw()
        rows = [
            r.as_row(peak_flops=peak_flops, membw=membw, memory=memory,
                     analyze=analyze)
            for r in self.records()
        ]
        rows.sort(key=lambda r: -(r["dispatch_s_total"] or 0.0))
        events = self.compile_events()
        return {
            "peak_flops_per_s": peak_flops,
            "membw_bytes_per_s": membw,
            **self.totals(),
            "programs": rows,
            "recompile_events": [
                e.as_dict() for e in events if e.redundant
            ][-32:],
        }


_REGISTRY = ProgramRegistry()


def registry() -> ProgramRegistry:
    return _REGISTRY


class ProfiledFunction:
    """A step program that registers its buckets and dispatch windows.

    Same call signature as ``fn``.  Per call it computes the bucket
    signature (a parameter tree is re-flattened only when a different
    object is passed at its position), and on the card records one event
    pair; the first call of a bucket is costed and registered.

    The pair is recorded on the current stream of the first CUDA tensor
    argument's device.  A tensor-parallel program's first argument is
    shard 0's params, so its window is shard 0's: every psum and gather
    ends on shard 0's device, which waits there for the other shards'
    copies, so the window closes after every shard's work up to the
    step's last collective (on one card all shards share the stream)."""

    def __init__(self, program: str, fn):
        self.program = program
        self.fn = fn
        self.calls = 0
        self._seen: set = set()
        # (object, signature) of the tree last seen at each position
        self._tree_cache: dict[int, tuple] = {}
        # the single (program, bucket) key when exactly one bucket has
        # been called through this wrapper (the engine's static-shape
        # case); False once a second bucket appears
        self._key: tuple | None | bool = None
        # perf_counter at the end of the newest first call: windows that
        # overlap it are cold and would poison the warm reservoir
        self._last_compile_end = 0.0
        # the CUDA device index of the first tensor argument on a card
        self._cuda: int | None = None
        # (t_call, start, end) event pairs awaiting their window's record,
        # and read pairs kept for reuse (creating events costs more than
        # recording them)
        self._pending: deque = deque()
        self._spare: list = []
        self._mem_armed: set = set()
        self._lock = threading.Lock()
        # stand-ins of the first call's arguments (meta tensors: shapes
        # without memory) for probe_overhead
        self._probe_args: tuple = ()

    def _signature(self, args, kwargs) -> tuple:
        parts = []
        for i, a in enumerate(args):
            if isinstance(a, (dict, list, tuple)):
                hit = self._tree_cache.get(i)
                if hit is not None and hit[0] is a:
                    parts.append(hit[1])
                    continue
                sig = _sig_one(a)
                self._tree_cache[i] = (a, sig)
                parts.append(sig)
            else:
                parts.append(_sig_one(a))
        for k in sorted(kwargs):
            parts.append((k, _sig_one(kwargs[k])))
        return tuple(parts)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        sig = self._signature(args, kwargs)
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(self.program):
                return self._call(sig, args, kwargs)
        return self._call(sig, args, kwargs)

    def _call(self, sig, args, kwargs):
        if sig not in self._seen:
            return self._first_call(sig, args, kwargs)
        if self._cuda is None:
            return self.fn(*args, **kwargs)
        if sig in self._mem_armed:
            return self._measured_call(sig, args, kwargs)
        stream = torch.cuda.current_stream(self._cuda)
        start, end = self._event_pair()
        t_call = time.perf_counter()
        start.record(stream)
        out = self.fn(*args, **kwargs)
        end.record(stream)
        with self._lock:
            self._pending.append((t_call, start, end))
            if len(self._pending) > 64:
                self._pending.popleft()  # windows never recorded
        return out

    def _event_pair(self):
        with self._lock:
            if self._spare:
                return self._spare.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _first_call(self, sig, args, kwargs):
        label = _bucket_label(args, kwargs)
        if self._cuda is None:
            self._cuda = next((l.device.index for l in _leaves(list(args))
                               if _is_tensor(l) and l.device.type == "cuda"),
                              None)
        self._probe_args = tuple(_stand_in(a) for a in args)
        t0 = time.perf_counter()
        out, flops, nbytes = _costed_call(self.fn, args, kwargs)
        compile_s = time.perf_counter() - t0
        self._seen.add(sig)
        self._last_compile_end = time.perf_counter()
        rec = _REGISTRY.record_compile(self, sig, label, compile_s,
                                       (flops, nbytes))
        key = (rec.program, rec.bucket)
        if self._key is None:
            self._key = key
        elif self._key is not False and self._key != key:
            self._key = False
        return out

    def _measured_call(self, sig, args, kwargs):
        """One call with the process's peak-memory statistics reset around
        it: temp = peak above the allocation before the call, less the
        new outputs."""
        self._mem_armed.discard(sig)
        dev = self._cuda
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = self.fn(*args, **kwargs)
        peak = torch.cuda.max_memory_allocated(dev)
        arg_ptrs = {l.data_ptr() for l in _leaves(list(args))
                    if _is_tensor(l)}
        out_new = sum(l.numel() * l.element_size() for l in _leaves(out)
                      if _is_tensor(l) and l.data_ptr() not in arg_ptrs)
        arg_bytes = sum(l.numel() * l.element_size()
                        for l in _leaves(list(args)) if _is_tensor(l))
        rec = _REGISTRY._records.get((self.program, sig))
        if rec is not None:
            rec.mem = {"temp_bytes": max(int(peak - base - out_new), 0),
                       "argument_bytes": int(arg_bytes),
                       "output_bytes": int(out_new)}
        return out

    def _take_window(self, t_disp: float) -> tuple[float | None, bool]:
        """The device window of the call dispatched at or after
        ``t_disp``: older pairs (calls whose windows were never recorded)
        are dropped.  Returns ``(seconds | None, unread)``."""
        with self._lock:
            while self._pending and self._pending[0][0] < t_disp:
                self._spare.append(self._pending.popleft()[1:])
            if not self._pending:
                return None, False
            _t, start, end = self._pending.popleft()
        if not end.query():
            return None, True
        seconds = start.elapsed_time(end) / 1e3
        with self._lock:
            self._spare.append((start, end))
        return seconds, False

    def record_dispatch(self, duration_s: float, *, t_end: float | None = None,
                        items: int | None = None) -> None:
        """Attribute one dispatch->sync window to this program (the
        engine calls this after the sync that closes the window).
        ``t_end`` is the window's perf_counter end so window queries line
        up with the flight recorder.  Windows overlapping a first call
        are dropped — they measure the build, not the kernels."""
        end = t_end if t_end is not None else time.perf_counter()
        if end - duration_s < self._last_compile_end:
            return
        device_s, unread = (None, False)
        if self._cuda is not None:
            device_s, unread = self._take_window(end - duration_s)
        key = self._key if isinstance(self._key, tuple) else None
        _REGISTRY.record_dispatch(self.program, key, duration_s, end, items,
                                  device_s, unread)
        rec = _REGISTRY._records.get(key) if key else None
        if rec is not None:
            rec.calls = self.calls

    def probe_overhead(self, reps: int = 20000) -> float:
        """Measured per-call cost of the wrapper's FAST-PATH bookkeeping
        (signature of the last call's arguments + counter; on the card
        also the event pair), excluding the call itself — the per-event
        number the overhead guard multiplies by the event count."""
        args = self._probe_args
        cuda = self._cuda
        if cuda is not None:
            stream = torch.cuda.current_stream(cuda)
        t0 = time.perf_counter()
        for _ in range(reps):
            self.calls += 1
            if torch.autograd.profiler._is_profiler_enabled:
                pass  # pragma: no cover - never under a profiler here
            sig = self._signature(args, {})
            if sig in self._mem_armed:  # pragma: no cover - never in probe
                pass
            if cuda is not None:
                s, e = self._event_pair()
                s.record(stream)
                e.record(stream)
                with self._lock:
                    self._spare.append((s, e))
        per = (time.perf_counter() - t0) / reps
        self.calls -= reps
        return per


def profiled(program: str, fn) -> ProfiledFunction:
    """``fn`` registered in the device cost observatory under
    ``program`` (the reference's ``profiled_jit``; nothing is jitted)."""
    return ProfiledFunction(program, fn)


# -- machine roofline probes (lazy, cached) ---------------------------------

_PROBE_CACHE: dict = {}
_PROBE_LOCK = threading.Lock()


def _probe_device():
    """The card when one is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _best_s(fn, dev, reps: int = 5) -> float:
    """Best of ``reps`` timed calls (after one warm-up): CUDA events on
    the card, ``perf_counter`` on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def measured_peak_flops_by_dtype() -> dict:
    """Measured GEMM rates of the machine, by dtype: on the card a bf16
    8192^3 and an f32 4096^3 product (TF32 as the caller has set it), on
    the CPU an f32 1024^3 product.  Cached per process."""
    with _PROBE_LOCK:
        if "peak_by_dtype" in _PROBE_CACHE:
            return dict(_PROBE_CACHE["peak_by_dtype"])
        dev = _probe_device()
        sizes = ({torch.bfloat16: 8192, torch.float32: 4096}
                 if dev.type == "cuda" else {torch.float32: 1024})
        out = {}
        g = torch.Generator(device="cpu").manual_seed(0)
        for dtype, n in sizes.items():
            a = torch.randn((n, n), generator=g).to(dev, dtype)
            b = torch.randn((n, n), generator=g).to(dev, dtype)
            c = torch.empty((n, n), dtype=dtype, device=dev)
            s = _best_s(lambda: torch.matmul(a, b, out=c), dev)
            out[_DT[str(dtype).replace("torch.", "")]] = 2.0 * n ** 3 / s
            del a, b, c
        _PROBE_CACHE["peak_by_dtype"] = out
        return dict(out)


def measured_peak_flops() -> float:
    """The machine's measured matmul roof: the bf16 GEMM rate on the card
    (the denominator of per-program MFU), the f32 one on the CPU, unless
    :func:`set_peak_flops` installed another."""
    with _PROBE_LOCK:
        if "peak" in _PROBE_CACHE:
            return _PROBE_CACHE["peak"]
    rates = measured_peak_flops_by_dtype()
    with _PROBE_LOCK:
        _PROBE_CACHE.setdefault("peak", rates.get("bf16", rates["f32"]))
        return _PROBE_CACHE["peak"]


def set_peak_flops(peak: float | None) -> None:
    """Install an externally known peak so every surface reports MFU
    against the same roof."""
    with _PROBE_LOCK:
        if peak:
            _PROBE_CACHE["peak"] = float(peak)


def measured_membw() -> float:
    """Measured device memory bandwidth: the best of 5 copies of a 1 GiB
    buffer on the card (read + write counted; 1 GiB is far past the
    L2, so the copy runs at the memory's rate), of 32 MB on the CPU."""
    with _PROBE_LOCK:
        if "membw" in _PROBE_CACHE:
            return _PROBE_CACHE["membw"]
        dev = _probe_device()
        n = (1 << 30) if dev.type == "cuda" else (32 << 20)
        src = torch.ones(n, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        s = _best_s(lambda: dst.copy_(src), dev)
        del src, dst
        _PROBE_CACHE["membw"] = 2.0 * n / s
        return _PROBE_CACHE["membw"]


# -- surfaces ---------------------------------------------------------------

def profile_dump(params: dict | None = None) -> str:
    """A ``/debug/profile`` body: the registry summary as JSON.
    ``?memory=1`` additionally arms and reports the memory watermarks."""
    params = params or {}
    include_memory = str(params.get("memory", "")) in ("1", "true", "yes")
    return json.dumps(
        _REGISTRY.summary(memory=include_memory), default=str,
    )


def render_prometheus_lines() -> list[str]:
    """``pathway_xla_*`` Prometheus lines (the reference's metric names,
    so one dashboard reads both packages).  Recorded values only — a
    scrape never probes."""
    recs = _REGISTRY.records()
    if not recs:
        return []
    totals = _REGISTRY.totals()
    lines = [
        "# TYPE pathway_xla_programs gauge",
        f"pathway_xla_programs {totals['n_device_programs']}",
        "# TYPE pathway_xla_compiles_total counter",
        "# TYPE pathway_xla_recompiles_total counter",
        f"pathway_xla_recompiles_total {totals['recompiles_total']}",
        "# TYPE pathway_xla_compile_seconds_total counter",
        "# TYPE pathway_xla_dispatches_total counter",
        "# TYPE pathway_xla_dispatch_seconds_total counter",
        "# TYPE pathway_xla_program_flops gauge",
        "# TYPE pathway_xla_program_mfu gauge",
    ]
    peak = _PROBE_CACHE.get("peak")  # never probe on a scrape
    for rec in recs:
        lbl = f'program="{rec.program}",bucket="{rec.label}"'
        lines.append(
            f"pathway_xla_compiles_total{{{lbl}}} {rec.n_compiles}"
        )
        lines.append(
            f"pathway_xla_compile_seconds_total{{{lbl}}} "
            f"{rec.compile_s_total:.4f}"
        )
        lines.append(
            f"pathway_xla_dispatches_total{{{lbl}}} {rec.dispatches}"
        )
        lines.append(
            f"pathway_xla_dispatch_seconds_total{{{lbl}}} "
            f"{rec.dispatch_s_total:.4f}"
        )
        flops = (rec.analysis or {}).get("flops")
        if flops:
            lines.append(f"pathway_xla_program_flops{{{lbl}}} {flops:.0f}")
            ms = rec.ms_percentile(0.5)
            if ms and peak:
                lines.append(
                    f"pathway_xla_program_mfu{{{lbl}}} "
                    f"{flops / (ms / 1e3) / peak:.5f}"
                )
    return lines


def otlp_points(now_ns: str) -> list[dict]:
    """``pathway.xla`` OTLP data points."""
    points = []
    for rec in _REGISTRY.records():
        attrs = [
            {"key": "program", "value": {"stringValue": rec.program}},
            {"key": "bucket", "value": {"stringValue": rec.label}},
        ]
        for key, val in (("compiles", rec.n_compiles),
                         ("dispatches", rec.dispatches)):
            points.append({
                "asInt": str(val), "timeUnixNano": now_ns,
                "attributes": attrs + [
                    {"key": "counter", "value": {"stringValue": key}}
                ],
            })
        for key, val in (("compile_s", rec.compile_s_total),
                         ("dispatch_s", rec.dispatch_s_total)):
            points.append({
                "asDouble": val, "timeUnixNano": now_ns,
                "attributes": attrs + [
                    {"key": "counter", "value": {"stringValue": key}}
                ],
            })
    return points


def counter_events(epoch_perf: float, pid: int) -> list[dict]:
    """Chrome-trace COUNTER events ("ph": "C") from the dispatch
    reservoirs — per-program counter tracks in every flight-recorder
    dump."""
    events = []
    for rec in _REGISTRY.records():
        name = f"pw.xla.{rec.program}"
        for t_end, dur, _items in list(rec.reservoir):
            events.append({
                "name": name, "ph": "C",
                "ts": round((t_end - epoch_perf) * 1e6, 3),
                "pid": pid,
                "args": {"dispatch_ms": round(dur * 1e3, 4)},
            })
    events.sort(key=lambda e: e["ts"])
    return events


def publish_to_costdb(db=None, *, peak_flops=None) -> int:
    """Push every record with measured dispatches into the persistent
    cost store (obs/costdb.py).  Returns the number of entries written."""
    from . import costdb as _costdb

    if db is None:
        db = _costdb.default_db()
    if peak_flops is None:
        peak_flops = _PROBE_CACHE.get("peak")
    n = 0
    for rec in _REGISTRY.records():
        ms = rec.ms_percentile(0.5)
        if ms is None:
            continue
        flops = (rec.analysis or {}).get("flops")
        mfu = (
            flops / (ms / 1e3) / peak_flops
            if flops and peak_flops else None
        )
        extra = {"dispatches": rec.dispatches,
                 "compile_s": round(rec.compile_s_total, 4)}
        dev = rec.device_ms_percentile(0.5)
        if dev is not None:
            extra["device_window_ms_p50"] = round(dev, 4)
        db.observe(
            rec.program, rec.label, ms=ms,
            flops=flops,
            bytes=(rec.analysis or {}).get("bytes_accessed"),
            mfu=round(mfu, 5) if mfu else None,
            extra=extra,
        )
        n += 1
    return n


def profile_diff(before: dict, after: dict) -> list[dict]:
    """Per-program deltas between two ``registry().summary()`` snapshots
    (or their JSON round-trips): one row per (program, bucket) in EITHER
    snapshot (``new``, ``gone`` or ``both``), with before/after/delta of
    p50 dispatch ms, MFU and share of total dispatch seconds, sorted by
    |share delta| then |ms delta|."""
    def _index(snap):
        progs = (snap or {}).get("programs") or []
        return {((r.get("program") or "?"), r.get("bucket")): r
                for r in progs}

    def _share(rows):
        tot = sum(r.get("dispatch_s_total") or 0.0 for r in rows.values())
        return tot or 1.0

    b_rows, a_rows = _index(before), _index(after)
    b_tot, a_tot = _share(b_rows), _share(a_rows)
    out = []
    for key in sorted(set(b_rows) | set(a_rows), key=str):
        b, a = b_rows.get(key), a_rows.get(key)

        def _get(row, field):
            return row.get(field) if row else None

        def _delta(field):
            x, y = _get(b, field), _get(a, field)
            return round(y - x, 5) if x is not None and y is not None \
                else None

        b_share = ((b or {}).get("dispatch_s_total") or 0.0) / b_tot
        a_share = ((a or {}).get("dispatch_s_total") or 0.0) / a_tot
        out.append({
            "program": key[0],
            "bucket": key[1],
            "status": ("new" if b is None
                       else "gone" if a is None else "both"),
            "ms_p50_before": _get(b, "dispatch_ms_p50"),
            "ms_p50_after": _get(a, "dispatch_ms_p50"),
            "ms_p50_delta": _delta("dispatch_ms_p50"),
            "mfu_before": _get(b, "mfu"),
            "mfu_after": _get(a, "mfu"),
            "mfu_delta": _delta("mfu"),
            "share_before": round(b_share, 4),
            "share_after": round(a_share, 4),
            "share_delta": round(a_share - b_share, 4),
        })
    out.sort(key=lambda r: (-abs(r["share_delta"]),
                            -abs(r["ms_p50_delta"] or 0.0)))
    return out
