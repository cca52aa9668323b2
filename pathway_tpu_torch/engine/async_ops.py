"""Fully-async UDF execution: Pending placeholders resolved by later updates.

The port of ``pathway_tpu/engine/async_ops.py``: a failing call poisons
its row with ``ERROR`` and is recorded in the engine's error log; a UDF
cache's lookup or store that fails raises (the JAX package's swallows
are not copied).

Reference: udfs/executors.py fully_async executor (:226) — the UDF returns
immediately with `Pending`; when the coroutine completes, the engine emits a
retraction of the Pending row and an insertion of the resolved row at a
later logical time.  This keeps the dataflow non-blocking while staying
consistent (each key's row is revised exactly once per resolution).

A completion is emitted only at a time later than its row's insertion, so
every row shows ``PENDING`` at its own time, however fast its call
returns.  The JAX operator also emits a completion that has finished by
the flush of the insert's own time, at that time, where it cancels the
``PENDING`` row before any consumer sees it.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from ..internals.expression import _record_error
from ..internals.value import ERROR, PENDING, Error
from .graph import Operator
from .types import Update, consolidate


class FullyAsyncRowwise(Operator):
    """Rowwise select with fully-async expressions.

    Emits rows with Pending in async positions immediately; completions are
    queued and flushed as retract+insert pairs at the next flush (streaming)
    or drained at on_end (batch mode).
    """

    def __init__(self, env, sync_exprs: list, async_specs: list, name="select~async"):
        # sync_exprs: per output column, either ("sync", fn) or ("async", idx)
        super().__init__(name)
        self.env = env
        self.plan = sync_exprs
        self.async_specs = async_specs  # list of (fun, arg_fns, kwarg_fns, capacity)
        # pool provisions for the sum of per-spec capacities; each spec's
        # concurrency is bounded by its own semaphore
        caps = [c if c else 8 for _f, _a, _k, c in async_specs]
        self.pool = ThreadPoolExecutor(
            max_workers=max(1, min(sum(caps) or 8, 64)),
            thread_name_prefix="pw-async",
        )
        self._spec_sems = [threading.Semaphore(c) for c in caps]
        self._lock = threading.Lock()
        self._completions: list[tuple[Any, tuple, tuple]] = []  # key, old_row, new_row
        self._outstanding = 0
        self._done = threading.Condition(self._lock)
        # completions are only accepted when their generation matches, so
        # retract-then-reinsert never resolves with a stale row's result
        self._gen_counter = 0
        # key -> (generation awaiting, logical time its PENDING row went out)
        self._inflight: dict[Any, tuple[int, Any]] = {}
        self._resolved: dict[Any, tuple] = {}  # key -> emitted resolved row

    def process(self, port, updates, time):
        out: list[Update] = []
        for key, row, diff in updates:
            e = self.env.build(key, row)
            if diff < 0:
                with self._lock:
                    if key in self._inflight:
                        # cancel: the completion will be dropped; retract Pending
                        del self._inflight[key]
                        out.append((key, self._pending_row(e), diff))
                        continue
                    resolved = self._resolved.pop(key, None)
                if resolved is not None:
                    out.append((key, resolved, diff))
                else:
                    out.append((key, self._pending_row(e), diff))
                continue
            pending_row = self._pending_row(e)
            out.append((key, pending_row, diff))
            async_args = []
            for i, (fun, arg_fns, kwarg_fns, _cap) in enumerate(self.async_specs):
                args = tuple(f(e) for f in arg_fns)
                kwargs = {k: f(e) for k, f in kwarg_fns.items()}
                async_args.append((fun, args, kwargs))
            with self._lock:
                self._gen_counter += 1
                gen = self._gen_counter
                self._inflight[key] = (gen, time)
            self._submit(key, gen, pending_row, e, async_args)
        self.emit(time, out)

    def _pending_row(self, e) -> tuple:
        vals = []
        for kind, payload in self.plan:
            if kind == "sync":
                vals.append(payload(e))
            else:
                vals.append(PENDING)
        return tuple(vals)

    def _submit(self, key, gen, pending_row, env, async_args):
        with self._lock:
            self._outstanding += 1

        def work():
            results = []
            for si, (fun, args, kwargs) in enumerate(async_args):
                try:
                    if any(isinstance(a, Error) for a in args):
                        results.append(ERROR)
                        continue
                    with self._spec_sems[si]:
                        results.append(fun(*args, **kwargs))
                except Exception as exc:
                    _record_error(exc, getattr(fun, "__name__", "async udf"))
                    results.append(ERROR)
            new_vals = []
            ri = iter(results)
            for kind, payload in self.plan:
                if kind == "sync":
                    new_vals.append(payload(env))
                else:
                    new_vals.append(next(ri))
            with self._done:
                if self._inflight.get(key, (None,))[0] == gen:
                    self._completions.append((key, gen, pending_row, tuple(new_vals)))
                # else: retracted or superseded before resolution — drop
                self._outstanding -= 1
                self._done.notify_all()

        self.pool.submit(work)

    def flush(self, time):
        self._drain(time)

    def _drain(self, time):
        """Emit, at ``time``, the completions of rows inserted before it;
        a completion of a row inserted at ``time`` waits for a later one
        (the streaming loop ticks while ``_completions`` is non-empty)."""
        with self._lock:
            comps, self._completions = self._completions, []
            out = []
            for comp in comps:
                key, gen, old_row, new_row = comp
                inflight = self._inflight.get(key)
                if inflight is None or inflight[0] != gen:
                    continue  # retracted/superseded since completion was queued
                if inflight[1] >= time:
                    self._completions.append(comp)
                    continue
                del self._inflight[key]
                self._resolved[key] = new_row
                out.append((key, old_row, -1))
                out.append((key, new_row, 1))
        if out:
            self.emit(time, consolidate(out))

    def on_end(self):
        # batch mode: wait for all outstanding resolutions, emit at a later time
        with self._done:
            while self._outstanding > 0:
                self._done.wait(timeout=30)
        t = (self.scheduler.frontier + 2) if self.scheduler else 2
        t -= t % 2
        self._drain(max(t, 2))


class AsyncBatchRowwise(Operator):
    """Deterministic rowwise select whose async UDF calls are gathered per
    micro-batch (reference: async executor with capacity,
    udfs/executors.py:226) — one event loop run per batch, not per row."""

    def __init__(self, env, plan, async_specs, deterministic: bool = False,
                 name="select-async"):
        super().__init__(name)
        self.env = env
        self.plan = plan  # per column: ("sync", fn) | ("async", spec_idx)
        # spec: (coro_fun, arg_fns, kwarg_fns, capacity, timeout, retry,
        #        cache_strategy, cache_name)
        self.async_specs = async_specs
        self.deterministic = deterministic
        # non-deterministic results memoized per key so retractions cancel
        # (reference: expression_cache.rs); deterministic UDFs recompute
        # instead, keeping memory proportional to nothing
        self._result_cache: dict[Any, tuple] = {}

    def process(self, port, updates, time):
        import asyncio

        from ..internals.udfs import run_coroutine_batch

        todo = []  # update indices needing async evaluation
        out_rows: list = [None] * len(updates)
        envs: list = [None] * len(updates)
        for i, (key, row, diff) in enumerate(updates):
            if diff < 0 and key in self._result_cache:
                out_rows[i] = self._result_cache.pop(key)
            else:
                envs[i] = self.env.build(key, row)
                todo.append(i)
        resolved: dict[int, dict[int, Any]] = {}
        for si, spec in enumerate(self.async_specs):
            (fun, arg_fns, kwarg_fns, capacity, timeout, retry,
             cache, cache_name) = spec
            coros = []
            coro_idx = []  # representative update index per coroutine
            hits: dict[int, Any] = {}
            call_keys: dict[int, str] = {}
            dedup: dict[str, list[int]] = {}  # cache key -> follower indices
            for i in todo:
                e = envs[i]
                args = tuple(f(e) for f in arg_fns)
                kwargs = {k: f(e) for k, f in kwarg_fns.items()}
                if cache is not None:
                    from ..internals.udfs import _cache_key

                    ck = _cache_key(cache_name, args, kwargs)
                    hit = cache.lookup(ck)
                    if hit is not None:
                        hits[i] = hit[0]
                        continue
                    if ck in dedup:
                        # identical in-batch call: share one invocation
                        dedup[ck].append(i)
                        continue
                    dedup[ck] = []
                    call_keys[i] = ck

                async def one(args=args, kwargs=kwargs):
                    if any(isinstance(a, Error) for a in args):
                        return ERROR
                    c = retry.invoke(fun, *args, **kwargs) if retry else fun(*args, **kwargs)
                    if timeout is not None:
                        return await asyncio.wait_for(c, timeout)
                    return await c

                coros.append(one())
                coro_idx.append(i)
            results = dict(zip(coro_idx, run_coroutine_batch(coros, capacity)))
            if cache is not None:
                for i, ck in call_keys.items():
                    v = results.get(i)
                    for follower in dedup.get(ck, ()):
                        results[follower] = v
                    if v is not None and not isinstance(v, Error):
                        cache.store(ck, (v,))
            results.update(hits)
            resolved[si] = results
        for i in todo:
            key, _row, diff = updates[i]
            vals = []
            for kind, payload in self.plan:
                if kind == "sync":
                    vals.append(payload(envs[i]))
                else:
                    vals.append(resolved[payload][i])
            out_rows[i] = tuple(vals)
            if diff > 0 and not self.deterministic:
                self._result_cache[key] = out_rows[i]
        self.emit(
            time,
            [(u[0], out_rows[i], u[2]) for i, u in enumerate(updates)],
        )


def lower_async_batch(node, lg):
    from .runner import _env_for

    p = node.params
    src = node.input_tables[0]
    env = _env_for(src)
    plan = []
    specs = []
    for e in p["exprs"]:
        spec = getattr(e, "_async_spec", None)
        if spec is not None:
            fun, ex, cache, name = spec
            idx = len(specs)
            specs.append(
                (fun, [a._eval for a in e._args],
                 {k: a._eval for k, a in e._kwargs.items()},
                 ex.capacity, ex.timeout, ex.retry_strategy, cache, name)
            )
            plan.append(("async", idx))
        else:
            plan.append(("sync", e._eval))
    # determinism must cover ALL columns (a non-deterministic sync column
    # recomputed on retraction would fail to cancel its insertion)
    return AsyncBatchRowwise(
        env, plan, specs, deterministic=p.get("deterministic", False)
    )


def lower_fully_async(node, lg):
    from .runner import _env_for

    p = node.params
    src = node.input_tables[0]
    env = _env_for(src)
    plan = []
    specs = []
    from ..internals.expression import FullyAsyncApplyExpression

    for e in p["exprs"]:
        if isinstance(e, FullyAsyncApplyExpression):
            idx = len(specs)
            spec = getattr(e, "_async_spec", None)
            capacity = spec[1].capacity if spec is not None else None
            specs.append(
                (e._fun, [a._eval for a in e._args],
                 {k: a._eval for k, a in e._kwargs.items()}, capacity)
            )
            plan.append(("async", idx))
        else:
            plan.append(("sync", _compile_expr(e)))
    return FullyAsyncRowwise(env, plan, specs)


def _compile_expr(e):
    return e._eval
