"""Engine operator base classes and the single-worker scheduler.

Execution model (a copy of ``pathway_tpu/engine/graph.py``; the reference's
differential-dataflow worker loop, src/engine/dataflow.rs): operators form
a DAG; data moves as Z-set update batches stamped with a logical time.  The
scheduler processes logical times strictly in order; within one time it walks
operators in topological order, first draining each operator's pending input
batches, then calling its `flush` hook.  Because emissions only flow downstream
(to later topo positions) at the same or a later time, a single pass per time
yields a consistent frontier: when time t finishes, every operator has seen
*all* updates at t — this is the engine's progress-tracking invariant,
replacing timely's distributed frontier gossip with a deterministic schedule.

Sharded multi-worker execution (parallel/) runs one scheduler per shard and
exchanges batches between shards at exchange boundaries (join/groupby re-key).
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from collections import defaultdict
from typing import Any, Callable, Iterable

from .types import Key, Row, Time, Update, consolidate, rows_equal

_op_counter = itertools.count()

# trace of the operator currently executing on this thread (error-log
# provenance for poisoned ERROR values); scheduler-managed, thread-local
import threading as _threading

_tls = _threading.local()


def _set_current_op_trace(trace):
    prev = getattr(_tls, "op_trace", None)
    _tls.op_trace = trace
    return prev


def current_op_trace():
    return getattr(_tls, "op_trace", None)


class Operator:
    """Base engine operator."""

    def __init__(self, name: str = ""):
        self.id = next(_op_counter)
        self.name = name or type(self).__name__
        self.inputs: list["Operator"] = []
        self.downstream: list[tuple["Operator", int]] = []
        self.scheduler: "Scheduler | None" = None
        # observability (reference: ProberStats, src/engine/dataflow/monitoring.rs)
        self.rows_in = 0
        self.rows_out = 0
        self.rows_out_neg = 0  # retractions emitted (diff < 0)
        self.busy_s = 0.0  # wall time spent inside process()/flush()
        # user stack frame that created this operator's ParseGraph node
        # (set by runner.lower; surfaced on engine errors)
        self.trace = None

    def connect(self, *upstream: "Operator") -> "Operator":
        for port, up in enumerate(upstream):
            self.inputs.append(up)
            up.downstream.append((self, port))
        return self

    # -- hooks -------------------------------------------------------------
    def process(self, port: int, updates: list[Update], time: Time) -> None:
        raise NotImplementedError

    def flush(self, time: Time) -> None:
        pass

    def on_end(self) -> None:
        """All input exhausted (batch mode) / graceful shutdown."""

    # -- emission ----------------------------------------------------------
    def emit(self, time: Time, updates: list[Update]) -> None:
        if not updates:
            return
        self.rows_out += len(updates)
        # ColumnarBatch exposes diffs directly — iterating the batch for
        # the negative count would materialize every row tuple of every
        # emitted batch
        diffs = getattr(updates, "diffs", None)
        if diffs is not None:
            self.rows_out_neg += sum(1 for d in diffs if d < 0)
        else:
            self.rows_out_neg += sum(1 for _k, _r, d in updates if d < 0)
        assert self.scheduler is not None
        self.scheduler.route(self, time, updates)

    # -- operator persistence ----------------------------------------------
    # names of attributes that constitute this operator's durable state
    # (reference: operator snapshots, src/persistence/operator_snapshot.rs:21-372);
    # empty tuple = stateless
    _STATE_ATTRS: tuple[str, ...] = ()

    def snapshot_state(self):
        """Picklable durable state, or None for stateless operators.
        Raises if a state attribute cannot be captured (the snapshot
        manager then disables snapshots for the run)."""
        if not self._STATE_ATTRS:
            return None
        return {a: getattr(self, a) for a in self._STATE_ATTRS}

    def restore_state(self, st) -> None:
        for a, v in st.items():
            setattr(self, a, v)

    def state_size(self) -> int:
        """Retained entries across this operator's durable state (arrangement
        size telemetry; reference: ProberStats/operator probes)."""
        total = 0
        for a in self._STATE_ATTRS:
            v = getattr(self, a, None)
            try:
                total += len(v)  # type: ignore[arg-type]
            except TypeError:
                pass
        return total


class Scheduler:
    def __init__(self) -> None:
        self.operators: list[Operator] = []
        self._topo: list[Operator] | None = None
        self._topo_pos: dict[int, int] = {}
        # pending[time][op_id] = list[(port, updates)]
        self.pending: dict[Time, dict[int, list[tuple[int, list[Update]]]]] = defaultdict(
            lambda: defaultdict(list)
        )
        self._times_heap: list[Time] = []
        self._times_set: set[Time] = set()
        self.current_time: Time | None = None
        self.frontier: Time = -1
        # cross-operator overlap (pipeline parallelism): operators in the
        # same topological level run on a thread pool; emissions are
        # captured per-op and routed in topo order afterwards, so results
        # are bit-identical to the sequential walk.  Real overlap comes
        # from GIL-releasing work (device dispatch, BLAS, IO) — exactly the
        # heavy paths.  Off by default (PATHWAY_PIPELINE_THREADS=1).
        import os as _os

        self.pipeline_threads = max(
            1, int(_os.environ.get("PATHWAY_PIPELINE_THREADS", "1") or "1")
        )
        self._pool = None
        self._levels_cache: list[list[Operator]] | None = None
        self._capture: dict[int, list] | None = None

    def register(self, op: Operator) -> Operator:
        op.scheduler = self
        self.operators.append(op)
        self._topo = None
        self._levels_cache = None
        return op

    # -- graph order -------------------------------------------------------
    def topo_order(self) -> list[Operator]:
        """Canonical LEVEL-ORDERED topological order: sorted by
        (depth, registration index) where depth(op) = 1 + max depth of its
        inputs.  Level-ordering (rather than raw Kahn output, which may
        interleave depths) makes the sequential walk and the level-parallel
        walk process-and-route in exactly the same order — the modes are
        bit-identical by construction, including which error surfaces
        first."""
        if self._topo is None:
            # Kahn pass for cycle detection + a valid propagation order
            indeg: dict[int, int] = {op.id: 0 for op in self.operators}
            for op in self.operators:
                for down, _ in op.downstream:
                    indeg[down.id] += 1
            ready = [op for op in self.operators if indeg[op.id] == 0]
            kahn: list[Operator] = []
            while ready:
                op = ready.pop()
                kahn.append(op)
                for down, _ in op.downstream:
                    indeg[down.id] -= 1
                    if indeg[down.id] == 0:
                        ready.append(down)
            if len(kahn) != len(self.operators):
                raise RuntimeError("cycle in engine graph (use iterate for loops)")
            depth: dict[int, int] = {}
            for op in kahn:
                depth[op.id] = 1 + max(
                    (depth[u.id] for u in op.inputs), default=-1
                )
            reg_pos = {op.id: i for i, op in enumerate(self.operators)}
            order = sorted(kahn, key=lambda op: (depth[op.id], reg_pos[op.id]))
            self._topo = order
            self._topo_pos = {op.id: i for i, op in enumerate(order)}
            by_depth: dict[int, list[Operator]] = defaultdict(list)
            for op in order:
                by_depth[depth[op.id]].append(op)
            self._levels_cache = [by_depth[d] for d in sorted(by_depth)]
        return self._topo

    def levels(self) -> list[list[Operator]]:
        """Topological antichains: level(op) = 1 + max(level(upstream)).
        Operators within a level have no dependency path between them, so
        at one logical time they may execute concurrently.  Concatenated in
        depth order these ARE topo_order() (level-ordered canonical form)."""
        if self._levels_cache is None:
            self.topo_order()
        return self._levels_cache

    # -- data movement -----------------------------------------------------
    def _note_time(self, time: Time) -> None:
        if time not in self._times_set:
            self._times_set.add(time)
            heapq.heappush(self._times_heap, time)

    def push_input(self, op: Operator, time: Time, updates: list[Update]) -> None:
        """External entry point: feed an input operator."""
        if time <= self.frontier:
            raise RuntimeError(
                f"input at time {time} but frontier already at {self.frontier}"
            )
        self.pending[time][op.id].append((0, updates))
        self._note_time(time)

    def route(self, source: Operator, time: Time, updates: list[Update]) -> None:
        if self.current_time is not None and time < self.current_time:
            raise RuntimeError(
                f"operator {source.name} emitted at past time {time} < {self.current_time}"
            )
        cap = self._capture
        if cap is not None and source.id in cap:
            # level-parallel execution: worker threads never touch the
            # shared pending/heap structures — emissions buffer per-op and
            # are routed in topo order after the level joins
            cap[source.id].append((time, updates))
            return
        for down, port in source.downstream:
            self.pending[time][down.id].append((port, updates))
        self._note_time(time)

    def _invoke(self, op: Operator, fn, *args):
        """Run one operator callback, attributing failures to the user code
        that created the operator (reference: EngineErrorWithTrace,
        graph_runner/__init__.py:228).  The error-log picks up the same
        trace for poisoned-ERROR provenance via _CURRENT_OP_TRACE."""
        from ..internals.trace import EngineErrorWithTrace

        token = _set_current_op_trace(op.trace)
        t0 = _time.perf_counter()
        try:
            return fn(*args)
        except EngineErrorWithTrace:
            raise
        except Exception as exc:
            raise EngineErrorWithTrace(
                f"{type(exc).__name__}: {exc}", operator=op.name,
                trace=op.trace,
            ) from exc
        finally:
            op.busy_s += _time.perf_counter() - t0
            _set_current_op_trace(token)

    # -- main loop ---------------------------------------------------------
    def step(self) -> bool:
        """Process the earliest pending time fully. Returns False when idle."""
        while self._times_heap:
            t = heapq.heappop(self._times_heap)
            self._times_set.discard(t)
            if t in self.pending or t > self.frontier:
                self._run_time(t)
                return True
        return False

    def _run_time(self, t: Time) -> None:
        if self.pipeline_threads > 1 and len(self.operators) > 1:
            self._run_time_parallel(t)
            return
        self.current_time = t
        order = self.topo_order()
        bucket = self.pending.get(t)
        for op in order:
            if bucket is not None:
                batches = bucket.pop(op.id, None)
                if batches:
                    for port, updates in batches:
                        op.rows_in += len(updates)
                        self._invoke(op, op.process, port, updates, t)
                    # route() may have added to this time's bucket again
                    bucket = self.pending.get(t)
            self._invoke(op, op.flush, t)
            bucket = self.pending.get(t)
        self.pending.pop(t, None)
        self.frontier = t
        self.current_time = None

    def _run_one(self, op: Operator, batches, t: Time) -> None:
        if batches:
            for port, updates in batches:
                op.rows_in += len(updates)
                self._invoke(op, op.process, port, updates, t)
        self._invoke(op, op.flush, t)

    def _run_time_parallel(self, t: Time) -> None:
        """Level-parallel variant of _run_time: each topological antichain
        runs on a thread pool.  Dependencies are respected (an op's inputs
        at time t all come from strictly lower levels), and emission routing
        is deferred + replayed in topo order — which IS level order, since
        topo_order() is canonically level-ordered — so the observable
        behavior is identical to the sequential walk, including which error
        surfaces first (lowest topo position of the failing level).  One
        caveat: same-level operators AFTER a failing one have already run
        when the error surfaces, so their in-memory state may be ahead of a
        sequential run's; errors abort the run before any snapshot, so no
        divergent state persists.  Overlap is real wherever the work
        releases the GIL (device dispatch, BLAS, IO, native code)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.pipeline_threads,
                thread_name_prefix="pw-pipeline",
            )
        self.current_time = t
        try:
            for level in self.levels():
                bucket = self.pending.get(t)
                work = [
                    (op, bucket.pop(op.id, None) if bucket else None)
                    for op in level
                ]
                if len(work) == 1:
                    self._run_one(work[0][0], work[0][1], t)
                    continue
                capture: dict[int, list] = {op.id: [] for op, _ in work}
                self._capture = capture
                try:
                    futures = [
                        (op, self._pool.submit(self._run_one, op, batches, t))
                        for op, batches in work
                    ]
                    errors = []
                    for op, fut in futures:
                        exc = fut.exception()
                        if exc is not None:
                            errors.append((self._topo_pos[op.id], exc))
                finally:
                    self._capture = None
                if errors:
                    # surface the same error the sequential walk would have
                    # hit first (lowest topo position)
                    raise min(errors)[1]
                # deterministic routing: emitting ops in topo order
                for op, _ in work:
                    for time_, updates in capture[op.id]:
                        self.route(op, time_, updates)
        finally:
            self._capture = None
            self.current_time = None
        self.pending.pop(t, None)
        self.frontier = t

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def close_pool(self) -> None:
        """Release pipeline-parallel worker threads (safe to call any time;
        a later parallel step lazily recreates the pool)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def finish(self) -> None:
        self.run_until_idle()
        # two-phase shutdown: interior operators first in topo order, draining
        # after each so downstream operators see upstream final batches BEFORE
        # their own on_end (async resolutions feeding a buffer, etc.); sinks
        # last — a subscriber's on_end truly means end-of-stream
        sinks = []
        for op in self.topo_order():
            if op.downstream:
                op.on_end()
                self.run_until_idle()
            else:
                sinks.append(op)
        for op in sinks:
            op.on_end()
        self.run_until_idle()
        self.close_pool()


# ---------------------------------------------------------------------------
# Shared state-cell helpers
# ---------------------------------------------------------------------------

class KeyedState:
    """key -> (row, count) with Z-set update semantics."""

    __slots__ = ("data",)

    def __init__(self) -> None:
        self.data: dict[Key, tuple[Row, int]] = {}

    def apply(self, key: Key, row: Row, diff: int) -> None:
        cur = self.data.get(key)
        if cur is None:
            if diff != 0:
                self.data[key] = (row, diff)
        else:
            crow, ccount = cur
            ncount = ccount + diff
            if ncount == 0:
                del self.data[key]
            else:
                # latest row wins on additions; keeps the live row on mixed batches
                self.data[key] = (row if diff > 0 else crow, ncount)

    def get_row(self, key: Key) -> Row | None:
        cur = self.data.get(key)
        if cur is None or cur[1] <= 0:
            return None
        return cur[0]

    def __contains__(self, key: Key) -> bool:
        return self.get_row(key) is not None

    def keys(self) -> Iterable[Key]:
        return (k for k, (_, c) in self.data.items() if c > 0)

    def items(self) -> Iterable[tuple[Key, Row]]:
        return ((k, r) for k, (r, c) in self.data.items() if c > 0)

    def __len__(self) -> int:
        return sum(1 for _, (_, c) in self.data.items() if c > 0)


class DiffOutputOperator(Operator):
    """Stateful operator that emits output-vs-last-emitted differences.

    Subclasses define `compute(out_key) -> Row | None` over the current input
    states and `dirty_keys_for(port, in_key)` mapping touched input keys to
    affected output keys.  The flush hook stabilizes output exactly once per
    logical time, so downstream sees one retract+insert per changed key per
    time regardless of intra-time churn.
    """

    _STATE_ATTRS = ("state", "last_out")

    def __init__(self, n_inputs: int, name: str = ""):
        super().__init__(name)
        self.state: list[KeyedState] = [KeyedState() for _ in range(n_inputs)]
        self.last_out: dict[Key, Row] = {}
        self._dirty: set[Key] = set()

    def state_size(self) -> int:
        # count retained ROWS, not the number of state cells
        return sum(len(st.data) for st in self.state) + len(self.last_out)

    def dirty_keys_for(self, port: int, key: Key) -> Iterable[Key]:
        return (key,)

    def compute(self, key: Key) -> Row | None:
        raise NotImplementedError

    def process(self, port: int, updates: list[Update], time: Time) -> None:
        st = self.state[port]
        for key, row, diff in updates:
            self.pre_apply(port, key, row, diff)
            st.apply(key, row, diff)
            self._dirty.update(self.dirty_keys_for(port, key))

    def pre_apply(self, port: int, key: Key, row: Row, diff: int) -> None:
        """Hook called before state mutation (for reverse-index upkeep)."""

    def flush(self, time: Time) -> None:
        if not self._dirty:
            return
        out: list[Update] = []
        for key in self._dirty:
            new_row = self.compute(key)
            old_row = self.last_out.get(key)
            if rows_equal(new_row, old_row):
                continue
            if old_row is not None:
                out.append((key, old_row, -1))
                del self.last_out[key]
            if new_row is not None:
                out.append((key, new_row, 1))
                self.last_out[key] = new_row
        self._dirty.clear()
        self.emit(time, consolidate(out))
