"""Incremental reducer state machines with add/retract semantics.

Re-design of the reference's reducers (src/engine/reduce.rs:27-45,
python/pathway/internals/reducers.py): every reducer keeps enough state to
process retractions; append-only fast paths skip multiset bookkeeping where
possible.  ndarray-valued reducers accumulate with numpy.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..internals.value import ERROR, Error, hash_values


class ReducerState:
    """Per-group per-reducer state."""

    __slots__ = ("error_count",)

    def __init__(self) -> None:
        self.error_count = 0

    def update(self, args: tuple, diff: int, time: int, key: int) -> None:
        if any(isinstance(a, Error) for a in args):
            self.error_count += diff
            return
        self._update(args, diff, time, key)

    def _update(self, args: tuple, diff: int, time: int, key: int) -> None:
        raise NotImplementedError

    def value(self) -> Any:
        if self.error_count > 0:
            return ERROR
        return self._value()

    def _value(self) -> Any:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError


class _MultisetMixin:
    def _ms_update(self, ms: dict, item, diff: int) -> None:
        c = ms.get(item, 0) + diff
        if c == 0:
            ms.pop(item, None)
        else:
            ms[item] = c


class CountState(ReducerState):
    __slots__ = ("count",)

    def __init__(self):
        super().__init__()
        self.count = 0

    def _update(self, args, diff, time, key):
        self.count += diff

    def bulk_add(self, total_diff: int, _weighted_sum=None) -> None:
        """Columnar fast path: fold a whole batch's net diff at once."""
        self.count += total_diff

    def _value(self):
        return self.count

    def is_empty(self):
        return self.count == 0 and self.error_count == 0


class SumState(ReducerState):
    __slots__ = ("total", "count")

    def __init__(self):
        super().__init__()
        self.total = 0
        self.count = 0

    def _update(self, args, diff, time, key):
        v = args[0]
        if v is None:
            return
        # works for scalar and ndarray alike; a prior scalar total broadcasts
        # into the array accumulation instead of being discarded
        self.total = self.total + v * diff
        self.count += diff

    def bulk_add(self, total_diff: int, weighted_sum) -> None:
        """Columnar fast path: weighted_sum = sum(v_i * diff_i) for the batch."""
        if isinstance(self.total, int) and isinstance(weighted_sum, float):
            self.total = float(self.total)
        self.total += weighted_sum
        self.count += total_diff

    def _value(self):
        return self.total

    def is_empty(self):
        return self.count == 0 and self.error_count == 0


class AvgState(SumState):
    def _value(self):
        if self.count == 0:
            return None
        return self.total / self.count


class _OrderState(ReducerState, _MultisetMixin):
    """Multiset of scalar values; min/max computed on demand with caching."""

    __slots__ = ("ms", "_cache_valid", "_cache")
    _agg: Callable = min

    def __init__(self):
        super().__init__()
        self.ms: dict = {}
        self._cache_valid = False
        self._cache = None

    def _update(self, args, diff, time, key):
        v = args[0]
        if v is None:
            return
        self._ms_update(self.ms, v, diff)
        self._cache_valid = False

    def _value(self):
        if not self.ms:
            return None
        if not self._cache_valid:
            self._cache = type(self)._agg(self.ms.keys())
            self._cache_valid = True
        return self._cache

    def is_empty(self):
        return not self.ms and self.error_count == 0


    def bulk_merge(self, val_counts: dict) -> None:
        """Columnar fast path: merge per-batch (value -> net diff) counts."""
        for v, d in val_counts.items():
            if d:
                self._ms_update(self.ms, v, d)
        self._cache_valid = False


class MinState(_OrderState):
    _agg = min


class MaxState(_OrderState):
    _agg = max


class _ArgOrderState(ReducerState, _MultisetMixin):
    """args = (value, arg); returns arg at extreme value (ties: smallest pair)."""

    __slots__ = ("ms",)
    _is_min = True

    def __init__(self):
        super().__init__()
        self.ms: dict = {}

    def _update(self, args, diff, time, key):
        v, a = args[0], args[1]
        if v is None:
            return
        self._ms_update(self.ms, (v, hash_values(a), _H(a)), diff)

    def _value(self):
        if not self.ms:
            return None
        keys = self.ms.keys()
        best = min(keys, key=lambda t: (t[0], t[1])) if self._is_min else max(
            keys, key=lambda t: (t[0], -t[1])
        )
        return best[2].value

    def is_empty(self):
        return not self.ms and self.error_count == 0


class _H:
    """Hash-by-stable-hash wrapper so unhashable args can live in dict keys."""

    __slots__ = ("value", "_h")

    def __init__(self, value):
        self.value = value
        self._h = hash_values(value) & 0x7FFFFFFFFFFFFFFF

    def __hash__(self):
        return self._h

    def __eq__(self, other):
        return isinstance(other, _H) and self._h == other._h


class ArgMinState(_ArgOrderState):
    _is_min = True


class ArgMaxState(_ArgOrderState):
    _is_min = False


class UniqueState(ReducerState, _MultisetMixin):
    __slots__ = ("ms",)

    def __init__(self):
        super().__init__()
        self.ms: dict = {}

    def _update(self, args, diff, time, key):
        self._ms_update(self.ms, _H(args[0]), diff)

    def _value(self):
        if not self.ms:
            return None
        if len(self.ms) > 1:
            return ERROR
        return next(iter(self.ms)).value

    def is_empty(self):
        return not self.ms and self.error_count == 0


class AnyState(UniqueState):
    def _value(self):
        if not self.ms:
            return None
        return min(self.ms, key=lambda h: h._h).value


class CountDistinctState(UniqueState):
    def _value(self):
        return len(self.ms)

    def is_empty(self):
        return not self.ms and self.error_count == 0


class CountDistinctApproxState(CountDistinctState):
    """HyperLogLog estimate (reference: CountDistinctApproximate,
    src/engine/reduce.rs HyperLogLog++).

    Retraction support forces keeping the exact multiset anyway (a pure
    sketch cannot retract); the VALUE is the HLL estimate over the live
    distinct hashes, computed vectorized with numpy and cached per flush —
    semantics parity with the reference's approximate reducer."""

    __slots__ = ("_est_valid", "_est")
    _P = 12  # 4096 registers

    def __init__(self):
        super().__init__()
        self._est_valid = False
        self._est = 0

    def _update(self, args, diff, time, key):
        super()._update(args, diff, time, key)
        self._est_valid = False

    def _value(self):
        if not self.ms:
            return 0
        if self._est_valid:
            return self._est
        m = 1 << self._P
        # ms keys are _H wrappers: use their cached STABLE 128-bit-derived
        # hash (hashing the wrapper object itself would fall through _ser to
        # repr() and embed a memory address -> nondeterministic estimates)
        hashes = np.fromiter(
            (h._h & ((1 << 64) - 1) if isinstance(h, _H)
             else hash_values(h) & ((1 << 64) - 1)
             for h in self.ms.keys()),
            dtype=np.uint64, count=len(self.ms),
        )
        # _h is 63-bit (sign-masked): splitmix-style avalanche redistributes
        # it over all 64 bits so register indices and ranks stay unbiased
        with np.errstate(over="ignore"):
            hashes = hashes * np.uint64(0x9E3779B97F4A7C15)
            hashes ^= hashes >> np.uint64(31)
            hashes = hashes * np.uint64(0xBF58476D1CE4E5B9)
            hashes ^= hashes >> np.uint64(27)
        idx = (hashes >> np.uint64(64 - self._P)).astype(np.int64)
        rest = hashes << np.uint64(self._P)
        # rank = leading zeros of the remaining 64-P bits + 1
        lz = np.zeros(len(hashes), np.int64)
        cur = rest
        # vectorized leading-zero count via float log2 trick
        nz = cur != 0
        lz[nz] = 63 - np.floor(np.log2(cur[nz].astype(np.float64))).astype(np.int64)
        lz[~nz] = 64 - self._P
        rank = np.minimum(lz + 1, 64 - self._P + 1)
        registers = np.zeros(m, np.int64)
        np.maximum.at(registers, idx, rank)
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(np.power(2.0, -registers))
        zeros = int(np.sum(registers == 0))
        if est <= 2.5 * m and zeros:
            est = m * np.log(m / zeros)  # linear counting, small range
        self._est = int(round(est))
        self._est_valid = True
        return self._est


class SortedTupleState(ReducerState, _MultisetMixin):
    __slots__ = ("ms", "skip_nones")

    def __init__(self, skip_nones: bool = False):
        super().__init__()
        self.ms: dict = {}
        self.skip_nones = skip_nones

    def _update(self, args, diff, time, key):
        v = args[0]
        if v is None and self.skip_nones:
            return
        self._ms_update(self.ms, _H(v), diff)

    def _value(self):
        if not self.ms:
            return None
        out = []
        for h, c in self.ms.items():
            out.extend([h.value] * c)
        try:
            return tuple(sorted(out))
        except TypeError:
            return tuple(sorted(out, key=lambda v: hash_values(v)))

    def is_empty(self):
        return not self.ms and self.error_count == 0


class TupleState(ReducerState, _MultisetMixin):
    """Values ordered by row key (deterministic across runs)."""

    __slots__ = ("ms", "skip_nones")

    def __init__(self, skip_nones: bool = False):
        super().__init__()
        self.ms: dict = {}
        self.skip_nones = skip_nones

    def _update(self, args, diff, time, key):
        v = args[0]
        if v is None and self.skip_nones:
            return
        self._ms_update(self.ms, (key, _H(v)), diff)

    def _value(self):
        if not self.ms:
            return None
        out = []
        for (k, h), c in sorted(self.ms.items(), key=lambda kv: kv[0][0]):
            out.extend([h.value] * c)
        return tuple(out)

    def is_empty(self):
        return not self.ms and self.error_count == 0


class NdarrayState(TupleState):
    def _value(self):
        t = super()._value()
        if t is None:
            return None
        return np.array(t)


class EarliestState(ReducerState, _MultisetMixin):
    __slots__ = ("ms",)
    _is_min = True

    def __init__(self):
        super().__init__()
        self.ms: dict = {}

    def _update(self, args, diff, time, key):
        self._ms_update(self.ms, (time, key, _H(args[0])), diff)

    def _value(self):
        if not self.ms:
            return None
        agg = min if self._is_min else max
        return agg(self.ms.keys(), key=lambda t: (t[0], t[1]))[2].value

    def is_empty(self):
        return not self.ms and self.error_count == 0


class LatestState(EarliestState):
    _is_min = False


class StatefulState(ReducerState):
    """Append-only custom combine (reference: stateful_single/stateful_many,
    python/pathway/internals/custom_reducers.py:433)."""

    __slots__ = ("state", "combine_many", "initialized", "finish")

    def __init__(self, combine_many: Callable, finish: Callable | None = None):
        super().__init__()
        self.state = None
        self.combine_many = combine_many
        self.finish = finish
        self.initialized = False

    def _update(self, args, diff, time, key):
        if diff < 0:
            raise RuntimeError(
                "stateful reducers require an append-only input (no retractions)"
            )
        self.state = self.combine_many(self.state, [(args, diff)])
        self.initialized = True

    def _value(self):
        # finish maps the accumulator to the emitted value (reference:
        # BaseCustomAccumulator.compute_result)
        if self.finish is not None:
            return self.finish(self.state)
        return self.state

    def is_empty(self):
        return False


class UdfReducerState(ReducerState, _MultisetMixin):
    """Full-recompute custom reducer built from a ReducerProtocol object."""

    __slots__ = ("ms", "protocol")

    def __init__(self, protocol):
        super().__init__()
        self.ms: dict = {}
        self.protocol = protocol

    def _update(self, args, diff, time, key):
        self._ms_update(self.ms, (key, _H(args)), diff)

    def _value(self):
        if not self.ms:
            return None
        rows = []
        for (k, h), c in sorted(self.ms.items(), key=lambda kv: kv[0][0]):
            rows.extend([h.value] * c)
        return self.protocol(rows)

    def is_empty(self):
        return not self.ms and self.error_count == 0


# ---------------------------------------------------------------------------
# Registry: reducer id -> state factory
# ---------------------------------------------------------------------------

def make_state(reducer_id: str, kwargs: dict) -> ReducerState:
    if reducer_id == "count":
        return CountState()
    if reducer_id in ("sum", "int_sum", "float_sum", "array_sum", "npsum"):
        return SumState()
    if reducer_id == "avg":
        return AvgState()
    if reducer_id == "min":
        return MinState()
    if reducer_id == "max":
        return MaxState()
    if reducer_id == "argmin":
        return ArgMinState()
    if reducer_id == "argmax":
        return ArgMaxState()
    if reducer_id == "unique":
        return UniqueState()
    if reducer_id == "any":
        return AnyState()
    if reducer_id == "count_distinct":
        return CountDistinctState()
    if reducer_id == "count_distinct_approximate":
        return CountDistinctApproxState()
    if reducer_id == "sorted_tuple":
        return SortedTupleState(skip_nones=kwargs.get("skip_nones", False))
    if reducer_id == "tuple":
        return TupleState(skip_nones=kwargs.get("skip_nones", False))
    if reducer_id == "ndarray":
        return NdarrayState(skip_nones=kwargs.get("skip_nones", False))
    if reducer_id == "earliest":
        return EarliestState()
    if reducer_id == "latest":
        return LatestState()
    if reducer_id == "stateful":
        return StatefulState(kwargs["combine_many"], kwargs.get("finish"))
    if reducer_id == "udf":
        return UdfReducerState(kwargs["protocol"])
    raise ValueError(f"unknown reducer {reducer_id!r}")
