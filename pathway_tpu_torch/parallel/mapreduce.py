"""Per-shard map/reduce/join building blocks for the data plane.

The port of ``pathway_tpu/parallel/mapreduce.py``.  Per-shard work is
expressed as a map over shard-local arrays and segment reductions over
group codes, so a shard's aggregation is one device program and only
aggregates cross the process fabric:

  - :func:`segment_sum` / :func:`segment_reduce` — per-group
    sum/count/min/max/avg over int group codes; the exact numpy kernel
    or a device program (``pw.reduce.segment_*`` in the cost
    observatory): the sums are ``index_add_`` into a zeroed buffer,
    min/max ``scatter_reduce_`` (``amin``/``amax``) over a buffer that
    holds the dtype's identity.  ``GroupbyOperator._process_bulk_np``
    routes its scatter-add segment sums through here;
  - :func:`hash_join_membership` — build-side membership of probe join
    keys (``pw.join.member``): ``torch.searchsorted`` over the sorted
    build keys, clipped and compared.  ``JoinOperator``'s columnar bulk
    path uses it to skip arrangement probes for rows that provably
    produce no output;
  - :func:`jit_map` — an element-wise fn through ``torch.vmap``
    (``pw.map.<fn>``);
  - :func:`combine_for_exchange` — consolidation of an exchange batch
    bound for a key-insensitive groupby by ROW VALUE: the multiset of
    (row, diff) is preserved exactly while one entry per DISTINCT row
    is sent.

Exactness rules (the JAX package's, kept so that the same batches reach
the device):

  - consolidation never does arithmetic on VALUES — only diffs (ints)
    are summed — so it is exact for count/min/max unconditionally;
  - sum/avg reducers additionally require int-typed value columns,
    checked per ROW: rows whose sum/avg values are all ints consolidate,
    the rest pass through raw in place;
  - the device segment programs run only for int32/float32, and
    membership only for int32/int64 probes of the build's dtype;
    everything else takes the numpy path.  Integer, min/max and
    membership results are bit-identical on both paths; float32 sums
    follow the device's atomic order.

Every public function takes ``device`` (default ``"cuda"``, resolved
through ``_device.resolve_device``, so it raises without a card unless
``device="cpu"``).  The device/numpy crossover is pinned by
``PW_MAPREDUCE_JIT_MIN`` (or a test monkeypatching
``_JIT_MIN_ELEMENTS``); otherwise it comes from the planner's measured
cost pair ``pw.reduce.segment_sum.{jit,numpy}`` (obs/planner.py).  Both
sides record their wall time per call of at least 4,096 elements, so
after a run the crossovers are those of the device the run used.
Powers of two pad each device call (``_pow2_bucket``), so the bucket
labels of the programs and cost rows match the JAX package's.
"""

from __future__ import annotations

import os
import time as _time
from typing import Any

import numpy as np

from .._device import resolve_device

# the documented fresh-host default: below this many elements the device
# path cannot beat its dispatch overhead on any backend we measured
_JIT_MIN_DEFAULT = 65536
# operator pin (env) or test monkeypatch; None defers to the planner
_env_jit_min = os.environ.get("PW_MAPREDUCE_JIT_MIN")
_JIT_MIN_ELEMENTS: int | None = int(_env_jit_min) if _env_jit_min else None
# consolidation overhead (one dict pass) is only worth paying when the
# batch could plausibly compress
_COMBINE_MIN_ROWS = 32
# wall-time samples below this size are dispatch noise, not signal
_RECORD_MIN_ELEMENTS = 4096

_prog_cache: dict[tuple, Any] = {}

# which side ran (tests and the smoke assert on these); on the card, the
# bytes the device programs moved each way and their stream time from
# the first upload to the program's end (CUDA events)
STATS = {"segment_device": 0, "segment_numpy": 0, "member_device": 0,
         "member_numpy": 0, "h2d_bytes": 0, "d2h_bytes": 0,
         "device_ms": 0.0}


def jit_min_elements() -> int:
    """The active device/numpy crossover: an explicit pin
    (``PW_MAPREDUCE_JIT_MIN`` / monkeypatched ``_JIT_MIN_ELEMENTS``)
    wins; otherwise the planner's measured costdb crossover, defaulting
    to :data:`_JIT_MIN_DEFAULT` on a fresh host."""
    if _JIT_MIN_ELEMENTS is not None:
        return _JIT_MIN_ELEMENTS
    from ..obs import planner

    return planner.cached_crossover(
        "pw.reduce.segment_sum", default=_JIT_MIN_DEFAULT
    )


def _record_cost(program: str, n: int, ms: float) -> None:
    """One measured wall-time sample into the costdb (``n<pow2>``
    bucket).  ``ms_best`` converges to the warm cost, washing first
    calls and scheduler noise out of the planner's comparison."""
    from ..obs import costdb

    costdb.default_db().observe(program, f"n{_pow2_bucket(n)}", ms=ms)


def _pow2_bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _program(kind: str, n_padded: int, n_groups_padded: int,
             dtype_str: str):
    """One profiled program per (kind, padded length, padded groups,
    dtype) bucket, registered as ``pw.reduce.segment_<kind>`` alongside
    the serving-path programs."""
    key = (kind, n_padded, n_groups_padded, dtype_str)
    fn = _prog_cache.get(key)
    if fn is None:
        import torch

        from ..obs.profiler import profiled

        if kind == "sum":
            def prog(values, codes):
                acc = torch.zeros(n_groups_padded, dtype=values.dtype,
                                  device=values.device)
                return acc.index_add_(0, codes, values)
        else:
            reduce = "amin" if kind == "min" else "amax"
            ident = _identity(np.dtype(dtype_str), kind)

            def prog(values, codes):
                acc = torch.full((n_groups_padded,), ident,
                                 dtype=values.dtype, device=values.device)
                return acc.scatter_reduce_(0, codes.long(), values,
                                           reduce=reduce, include_self=True)

        fn = profiled(f"pw.reduce.segment_{kind}", prog)
        _prog_cache[key] = fn
    return fn


def _identity(dtype: np.dtype, kind: str):
    if np.issubdtype(dtype, np.floating):
        return np.inf if kind == "min" else -np.inf
    info = np.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _on_device(prog, dev, n: int, *host):
    """Run ``prog`` over host arrays moved to ``dev``, bring the result
    back with one copy, and record the dispatch window."""
    import torch

    card = dev.type == "cuda"
    t0 = _time.perf_counter()
    if card:
        stream = torch.cuda.current_stream(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(stream)
    out = prog(*[torch.from_numpy(a).to(dev) for a in host])
    if card:
        ev[1].record(stream)
    out = out.cpu()  # on the card: synchronous, past ev[1]
    if card:
        STATS["h2d_bytes"] += sum(a.nbytes for a in host)
        STATS["d2h_bytes"] += out.numel() * out.element_size()
        STATS["device_ms"] += ev[0].elapsed_time(ev[1])
    prog.record_dispatch(_time.perf_counter() - t0, items=n)
    return out.numpy()


def _run_device_segment(kind: str, values, codes, n_groups: int, dev,
                        pad_value=0):
    """The padded/bucketed device dispatch (shared by the reductions and
    the planner's calibration loop, so both measure the SAME program).
    Pad rows scatter into the last segment, sliced away unless a real
    group shares it, and then pad values are the kind's identity."""
    n_pad = _pow2_bucket(values.size)
    g_pad = _pow2_bucket(n_groups, floor=256)
    v = np.full(n_pad, pad_value, values.dtype)
    v[: values.size] = values
    c = np.full(n_pad, g_pad - 1, np.int32)
    c[: values.size] = codes
    prog = _program(kind, n_pad, g_pad, str(values.dtype))
    STATS["segment_device"] += 1
    return _on_device(prog, dev, values.size, v, c)[:n_groups]


def _run_jit_segment_sum(values, codes, n_groups: int, device="cuda"):
    """The device segment sum at the padded bucket (the JAX package's
    name: the planner's calibration times this call)."""
    return _run_device_segment("sum", np.asarray(values), codes, n_groups,
                               resolve_device(device))


def _device_dtype(values) -> bool:
    return values.dtype in (np.float32, np.int32)


def segment_sum(values, codes, n_groups: int, *, weights=None,
                device="cuda"):
    """reduce_sum building block: per-group sums of ``values`` (optionally
    ``values * weights``) over int group ``codes`` in [0, n_groups).

    The device program when the batch clears the crossover and the
    dtype is int32/float32; the exact numpy scatter-add otherwise (the
    engine's int64/float64 columns always land there)."""
    dev = resolve_device(device)
    values = np.asarray(values)
    if weights is not None:
        values = values * np.asarray(weights)
    use_dev = values.size >= jit_min_elements() and _device_dtype(values)
    record = values.size >= _RECORD_MIN_ELEMENTS
    t0 = _time.perf_counter() if record else 0.0
    if not use_dev:
        acc = np.zeros(n_groups, values.dtype)
        np.add.at(acc, codes, values)
        STATS["segment_numpy"] += 1
        if record:
            _record_cost("pw.reduce.segment_sum.numpy", values.size,
                         (_time.perf_counter() - t0) * 1e3)
        return acc
    out = _run_device_segment("sum", values, codes, n_groups, dev)
    if record:
        _record_cost("pw.reduce.segment_sum.jit", values.size,
                     (_time.perf_counter() - t0) * 1e3)
    return out


def segment_reduce(values, codes, n_groups: int, kind: str = "sum", *,
                   weights=None, device="cuda"):
    """Generalized per-group reduction over int group ``codes``:

    - ``"sum"``  — :func:`segment_sum` (optionally diff-weighted);
    - ``"count"`` — sum of ``weights`` (the diffs), or of ones;
    - ``"min"`` / ``"max"`` — per-group extrema; empty groups hold the
      dtype's identity (max for min, min for max).  No arithmetic is
      performed, so numpy and the device agree bit for bit;
    - ``"avg"`` — the (sums, counts) PAIR; the caller divides, because
      the division's rounding belongs to the reducer's own semantics,
      not the primitive's.

    Same crossover and dtype rules as :func:`segment_sum`; the device
    programs register as ``pw.reduce.segment_<kind>``."""
    if kind == "sum":
        return segment_sum(values, codes, n_groups, weights=weights,
                           device=device)
    if kind == "count":
        if weights is None:
            weights = np.ones(np.asarray(codes).size, np.int64)
        return segment_sum(weights, codes, n_groups, device=device)
    if kind == "avg":
        w = weights if weights is not None else np.ones(
            np.asarray(values).size, np.int64
        )
        return (
            segment_sum(values, codes, n_groups, weights=weights,
                        device=device),
            segment_sum(np.asarray(w), codes, n_groups, device=device),
        )
    if kind not in ("min", "max"):
        raise ValueError(f"unknown segment_reduce kind: {kind!r}")

    dev = resolve_device(device)
    values = np.asarray(values)
    ident = _identity(values.dtype, kind)
    use_dev = values.size >= jit_min_elements() and _device_dtype(values)
    record = values.size >= _RECORD_MIN_ELEMENTS
    t0 = _time.perf_counter() if record else 0.0
    if not use_dev:
        acc = np.full(n_groups, ident, values.dtype)
        (np.minimum if kind == "min" else np.maximum).at(acc, codes, values)
        STATS["segment_numpy"] += 1
        if record:
            _record_cost(f"pw.reduce.segment_{kind}.numpy", values.size,
                         (_time.perf_counter() - t0) * 1e3)
        return acc
    out = _run_device_segment(kind, values, codes, n_groups, dev,
                              pad_value=ident)
    if record:
        _record_cost(f"pw.reduce.segment_{kind}.jit", values.size,
                     (_time.perf_counter() - t0) * 1e3)
    return out


def _membership_program(n_probe_pad: int, n_build_pad: int, dtype_str: str):
    """Sorted-searchsorted membership as one device program
    (``pw.join.member``): for each probe key, whether it occurs in the
    sorted build array.  Pure comparisons — bit-exact on any dtype."""
    key = ("member", n_probe_pad, n_build_pad, dtype_str)
    fn = _prog_cache.get(key)
    if fn is None:
        import torch

        from ..obs.profiler import profiled

        def prog(probe, build_sorted):
            idx = torch.searchsorted(build_sorted, probe)
            idx = idx.clamp_(0, n_build_pad - 1)
            return build_sorted[idx] == probe

        fn = profiled("pw.join.member", prog)
        _prog_cache[key] = fn
    return fn


def hash_join_membership(probe, build, *, device="cuda"):
    """Vectorized hash-join building block: a bool mask over ``probe``
    marking keys present in ``build`` (both 1-d int arrays of join-key
    codes).  The numpy path is ``np.isin``; from the crossover up, for
    int32/int64 probes of the build's dtype, the device program runs
    instead.  Membership is pure comparison — both paths are exact — so
    the join operator may use the mask to SKIP work, never to change
    output."""
    dev = resolve_device(device)
    probe = np.asarray(probe)
    build = np.asarray(build)
    if build.size == 0:
        return np.zeros(probe.size, bool)
    use_dev = (
        probe.size >= jit_min_elements()
        and probe.dtype == build.dtype
        and probe.dtype in (np.int32, np.int64)
    )
    record = probe.size >= _RECORD_MIN_ELEMENTS
    t0 = _time.perf_counter() if record else 0.0
    if not use_dev:
        out = np.isin(probe, build)
        STATS["member_numpy"] += 1
        if record:
            _record_cost("pw.join.member.numpy", probe.size,
                         (_time.perf_counter() - t0) * 1e3)
        return out
    bs = np.sort(build)
    n_pad = _pow2_bucket(probe.size)
    b_pad = _pow2_bucket(build.size, floor=256)
    p = np.full(n_pad, probe[0], probe.dtype)
    p[: probe.size] = probe
    b = np.full(b_pad, bs[-1], bs.dtype)  # pad with the max: order kept,
    b[: bs.size] = bs                     # membership unchanged
    prog = _membership_program(n_pad, b_pad, str(probe.dtype))
    STATS["member_device"] += 1
    out = _on_device(prog, dev, probe.size, p, b)[: probe.size]
    if record:
        _record_cost("pw.join.member.jit", probe.size,
                     (_time.perf_counter() - t0) * 1e3)
    return out


def jit_map(fn):
    """map building block: element-wise ``fn`` through ``torch.vmap``
    once — the per-shard transform of a map/reduce pipeline as one
    program, registered in the cost observatory under the fn's name.
    The returned callable takes tensors on the device the caller chose."""
    import torch

    from ..obs.profiler import profiled

    name = getattr(fn, "__name__", "fn")
    return profiled(f"pw.map.{name}", torch.vmap(fn))


# -- exchange consolidation (aggregates-only fabric traffic) ---------------

def exchange_combine_spec(op) -> tuple | None:
    """Eligibility of a groupby operator's input exchange for row-value
    consolidation.  Requires the operator's columnar `simple_spec` (plain
    column groupings with count/sum/avg/min/max reducers — exactly the
    key-insensitive reducer set: no reducer reads the engine row key, so
    an update's identity is its (row, diff), not its key).  Returns
    (int_value_positions,) — row positions that must hold ints for a ROW
    to combine (sum/avg exactness), or None when ineligible."""
    spec = getattr(op, "simple_spec", None)
    if spec is None:
        return None
    if getattr(op, "key_fn", None) is not None:
        # custom id_expr may read the key — row identity is not enough
        return None
    _gb_pos, red_plan = spec
    int_positions = tuple(
        p[1] for p in red_plan if p[0] in ("sum", "avg")
    )
    return (int_positions,)


def combine_for_exchange(updates: list, spec: tuple) -> list | None:
    """Consolidate an outgoing exchange batch by ROW VALUE: updates with
    identical rows merge into one (first_key, row, summed_diff) entry and
    cancelled rows (net diff 0) vanish.  The multiset of (row, diff) is
    preserved exactly, so a key-insensitive groupby receiver computes
    byte-identical state.

    Eligibility is per ROW: a row whose sum/avg value columns are all
    ints merges; a row holding a float there (or an unhashable value)
    passes through RAW in its original relative position — merged float
    partial sums would re-order additions, but an exact row's
    consolidation is exact regardless of its batch-mates.  Returns None
    (send raw) when the batch is too small or nothing compressed."""
    if len(updates) < _COMBINE_MIN_ROWS:
        return None
    (int_positions,) = spec
    acc: dict = {}
    # emission walk in first-occurrence order: a merged row's slot, or a
    # raw passthrough update pinned in place
    order: list = []
    for u in updates:
        row = u[1]
        entry = None
        try:
            for p in int_positions:
                v = row[p]
                if not isinstance(v, int):  # bool is int; floats are not
                    entry = False  # ineligible: pass through raw
                    break
            if entry is None:
                entry = acc.get(row)
        except TypeError:
            entry = False  # unhashable row values: pass through raw
        if entry is False:
            order.append((None, u))
        elif entry is None:
            acc[row] = [u[0], u[2]]
            order.append((row, None))
        else:
            entry[1] += u[2]
    out: list = []
    for row, raw in order:
        if raw is not None:
            out.append(raw)
        else:
            key, diff = acc[row]
            if diff != 0:
                out.append((key, row, diff))
    if len(out) >= len(updates):
        return None  # nothing compressed: the pass bought no wire bytes
    return out
