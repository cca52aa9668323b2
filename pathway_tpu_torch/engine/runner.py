"""GraphRunner: lower the ParseGraph to engine operators and execute.

The port of ``pathway_tpu/engine/runner.py``.  Reference call stack being
re-designed: GraphRunner.run_outputs → run_with_new_graph → timely worker
loop.  Here the lowering and the scheduler live in-process; streaming mode
polls live sources and stamps wall-clock logical times (even-numbered,
matching the reference's alt-neu convention, src/connectors/mod.rs:248).

The runner takes the data plane's ``device`` (default ``"cuda"``) and
resolves it when it is built, so without a card a run raises before any
row moves unless ``device="cpu"``.  The operators that hold device
programs (the vectorized select/filter plans, the groupby's segment sums,
the join's membership) get it at lowering, and a lowering plugged in
from another module reads it as ``lg.device``.  Those modules plug
their node kinds in with :func:`register_lowering` when they are
imported: the time and stream operators (``engine/time_ops.py``,
``engine/stream_ops.py``), the as-of, as-of-now and sort operators
(``stdlib/temporal``), ``iterate`` (``internals/iterate.py``), the
external index (``stdlib/indexing/data_index.py``) and the REST response
writer (``io/http.py``).  A node kind that no module lowers raises at
lowering, naming it.  Rowwise selects over async UDFs lower to the
operators of ``engine/async_ops.py``; a run stays alive while their
completions are in flight.  Live sources are stopped when a streaming
run ends.  Under persistence (``persistence.attach_persistence``) the
streaming loop takes an operator snapshot when one is due, after each
iteration's sinks closed, and a paced journal backfill
(``realtime_replay``) or a file source reading new files counts as
activity for ``idle_stop_s``; a restored
snapshot moves the scheduler's frontier, and the loop's first time
follows it.  With ``PATHWAY_ELASTIC=1`` a ``WorkloadTracker`` watches the
loop's busy share, and under the ``spawn`` supervisor a sustained low or
high share ends the run with the down- or up-scale exit code.  Several
workers run through ``parallel/cluster.py``'s ``ClusterRunner``, which
lowers one graph per shard with :func:`lower`.
"""

from __future__ import annotations

import os
import sys
import time as _time
from collections import defaultdict
from typing import Any, Callable

from .._device import resolve_device
from ..internals import parse_graph as pg
from ..internals.expression import ColumnExpression
from ..internals.table import Table
from . import operators as ops
from .graph import Operator, Scheduler
from .types import CapturedStream, Update


_DEPS_PREFETCHED = False


def _prefetch_lazy_deps() -> None:
    """Import the hot-path lazy dependencies (pandas: the bulk groupby's
    C factorizer) on a daemon thread when the FIRST runner is built,
    overlapping the import with lowering.  Triggered at runner
    construction, not package import; PATHWAY_NO_DEP_PREFETCH=1 disables
    it (e.g. for fork-sensitive embedders — a child forked mid-import
    would inherit held per-module import locks)."""
    global _DEPS_PREFETCHED
    if _DEPS_PREFETCHED:
        return
    _DEPS_PREFETCHED = True
    import os as _os

    if _os.environ.get("PATHWAY_NO_DEP_PREFETCH"):
        return
    import threading

    def _imp():
        try:
            import pandas
        except ImportError:
            return
        try:
            # warm the factorizer machinery too, not just the import: the
            # first pandas.factorize call lazily initializes its C
            # hashtable classes, which would otherwise land inside the
            # first bulk groupby
            import numpy as _np

            pandas.factorize(_np.asarray(["w", "w2"], dtype=object))
            pandas.factorize(_np.asarray([1, 2], dtype=_np.int64))
        except Exception:  # noqa: BLE001 - warmup is best-effort
            pass

    threading.Thread(target=_imp, daemon=True,
                     name="pw-dep-prefetch").start()


def _compile(expr: ColumnExpression) -> Callable[[dict], Any]:
    return expr._eval


class LoweredGraph:
    def __init__(self, device=None) -> None:
        self.device = device  # the data plane's, resolved by lower()
        self.scheduler = Scheduler()
        self.by_node: dict[int, Operator] = {}
        self.input_ops: list[tuple[ops.InputOperator, Any]] = []  # (op, source)
        self.captures: dict[int, CapturedStream] = {}
        self.output_callbacks: list[Callable[[], None]] = []
        self.writers: list[Any] = []  # file sinks (snapshot-resume trimming)


def _groupby_simple_spec(src: Table, p: dict):
    """Columnar-ingest plan for plain-column groupbys with
    count/sum/avg/min/max reducers; None when anything needs the row
    interpreter."""
    from ..internals.expression import ColumnReference

    if p.get("id_expr") is not None or p.get("sort_by") is not None:
        return None
    if p.get("instance") is not None:
        return None
    positions = {n: i for i, n in enumerate(src._colnames)}

    def pos_of(e):
        if isinstance(e, ColumnReference) and e._table is src and e._name in positions:
            return positions[e._name]
        return None

    gb_pos = []
    for e in p["gb_exprs"]:
        i = pos_of(e)
        if i is None:
            return None
        gb_pos.append(i)
    red_plan = []
    for rid, args, kw in p["reducers"]:
        if rid == "count":
            red_plan.append(("count",))
        elif rid in ("sum", "avg", "min", "max") and len(args) == 1:
            i = pos_of(args[0])
            if i is None:
                return None
            red_plan.append((rid, i))
        else:
            return None
    return (gb_pos, red_plan)


def _join_simple_spec(lt: Table, rt: Table, p: dict):
    """Columnar join-key plan: per-side column positions when every on-expr
    is a plain column of its own side; None when anything needs the row
    interpreter (the bulk path then never engages)."""
    from ..internals.expression import ColumnReference

    def side_positions(src, exprs):
        positions = {n: i for i, n in enumerate(src._colnames)}
        out = []
        for e in exprs:
            if (
                isinstance(e, ColumnReference)
                and e._table is src
                and e._name in positions
            ):
                out.append(positions[e._name])
            else:
                return None
        return tuple(out)

    lp = side_positions(lt, p["left_on"])
    rp = side_positions(rt, p["right_on"])
    if lp is None or rp is None:
        return None
    return (lp, rp)


def _use_static_batches(source) -> bool:
    """The columnar fast path is only sound when static_events has not been
    instance-wrapped (persistence journaling/replay overrides it on the
    instance; bypassing the wrapper would skip the journal)."""
    return (
        hasattr(source, "static_batches")
        and "static_events" not in source.__dict__
    )


def _env_for(table: Table) -> ops.EnvBuilder:
    positions = {(id(table), n): i for i, n in enumerate(table._colnames)}
    if table._aliases:
        positions.update(table._aliases)
    return ops.EnvBuilder(positions)


def _env_multi(tables: list[Table]) -> ops.EnvBuilder:
    positions: dict[tuple[int, str], int] = {}
    offset = 0
    for t in tables:
        for i, n in enumerate(t._colnames):
            positions.setdefault((id(t), n), offset + i)
        if t._aliases:
            for k, p in t._aliases.items():
                positions.setdefault(k, offset + p)
        offset += len(t._colnames)
    return ops.EnvBuilder(positions)


def lower(sinks: list[pg.OpNode], device="cuda") -> LoweredGraph:
    """The engine operators of every node the sinks reach; ``device`` is
    the data plane's (the runner passes the one it resolved)."""
    device = resolve_device(device)
    lg = LoweredGraph(device)

    def build(node: pg.OpNode) -> Operator:
        if node.id in lg.by_node:
            return lg.by_node[node.id]
        upstream = [build(t._node) for t in node.input_tables]
        op = _make_operator(node, lg, device)
        op.trace = node.trace  # user file:line for error attribution
        lg.scheduler.register(op)
        op.connect(*upstream)
        lg.by_node[node.id] = op
        return op

    for sink in sinks:
        build(sink)
    # companion sinks: a feedback-loop source (AsyncTransformer) is fed by a
    # subscribe node on its INPUT table — a side-effect sink the tree-shake
    # from the requested outputs cannot see.  Pull such sinks in whenever
    # their source landed in the lowered graph (fixpoint: a companion may
    # itself reference further sources with companions).
    while True:
        extra = []
        for _op, source in list(lg.input_ops):
            for node in getattr(source, "companion_sinks", ()):
                if node.id not in lg.by_node:
                    extra.append(node)
        if not extra:
            break
        for node in extra:
            build(node)
    return lg


def _make_operator(node: pg.OpNode, lg: LoweredGraph, device) -> Operator:
    kind = node.kind
    p = node.params
    tables = node.input_tables

    if kind == "input":
        op = ops.InputOperator(name=f"input:{node.id}")
        lg.input_ops.append((op, p["source"]))
        return op

    if kind == "rowwise":
        if p.get("fully_async"):
            from .async_ops import lower_fully_async

            return lower_fully_async(node, lg)
        if len(tables) == 1 and any(
            getattr(e, "_async_spec", None) is not None for e in p["exprs"]
        ):
            from .async_ops import lower_async_batch

            return lower_async_batch(node, lg)
        exprs = [_compile(e) for e in p["exprs"]]
        if p.get("deterministic", True) and len(tables) == 1:
            return ops.StatelessRowwise(
                _env_for(tables[0]), exprs, raw_exprs=p["exprs"],
                n_in_cols=len(tables[0]._colnames), name="select",
                device=device,
            )
        return ops.StatefulRowwise(len(tables), _env_multi(tables), exprs,
                                   name="select*", raw_exprs=p["exprs"])

    if kind == "filter":
        pred = _compile(p["predicate"])
        if p.get("deterministic", True) and len(tables) == 1:
            return ops.StatelessFilter(
                _env_for(tables[0]), pred, raw_predicate=p["predicate"],
                n_in_cols=len(tables[0]._colnames), name="filter",
                device=device,
            )
        return ops.StatefulFilter(len(tables), _env_multi(tables), pred, name="filter*")

    if kind == "reindex":
        return ops.ReindexOperator(_env_for(tables[0]), _compile(p["key_expr"]), name="reindex")

    if kind == "concat":
        return ops.ConcatOperator(name="concat")

    if kind == "flatten":
        return ops.FlattenOperator(p["position"], name="flatten")

    if kind == "join":
        lt, rt = tables
        return ops.JoinOperator(
            _env_for(lt),
            _env_for(rt),
            [_compile(e) for e in p["left_on"]],
            [_compile(e) for e in p["right_on"]],
            p["how"],
            p["id_policy"],
            len(lt._colnames),
            len(rt._colnames),
            simple_on=_join_simple_spec(lt, rt, p),
            name=f"join:{p['how']}",
            device=device,
        )

    if kind == "groupby":
        src = tables[0]
        n_out = len(p["gb_exprs"])
        gb_fns = [_compile(e) for e in p["gb_exprs"]]
        if p.get("instance") is not None:
            gb_fns.append(_compile(p["instance"]))
        reducers = [
            (rid, [_compile(a) for a in args], kw) for rid, args, kw in p["reducers"]
        ]
        return ops.GroupbyOperator(
            _env_for(src),
            gb_fns,
            reducers,
            n_out_gvals=n_out,
            key_fn=_compile(p["id_expr"]) if p.get("id_expr") is not None else None,
            sort_fn=_compile(p["sort_by"]) if p.get("sort_by") is not None else None,
            simple_spec=_groupby_simple_spec(src, p),
            name="groupby",
            device=device,
        )

    if kind == "ix":
        src, target = tables
        return ops.IxOperator(
            _env_for(src),
            _compile(p["ptr_expr"]),
            p["optional"],
            len(target._colnames),
            name="ix",
        )

    if kind == "difference":
        return ops.DifferenceOperator(name="difference")

    if kind == "intersect":
        return ops.IntersectOperator(len(tables), name="intersect")

    if kind == "update_rows":
        return ops.UpdateRowsOperator(name="update_rows")

    if kind == "update_cells":
        return ops.UpdateCellsOperator(p["positions"], name="update_cells")

    if kind == "deduplicate":
        src = tables[0]
        return ops.DeduplicateOperator(
            _env_for(src),
            _compile(p["value_expr"]),
            [_compile(e) for e in p["instance_exprs"]],
            p["acceptor"],
            name="deduplicate",
        )

    if kind == "capture":
        cap = CapturedStream(p["colnames"])
        lg.captures[node.id] = cap

        def on_time(t, updates, _cap=cap):
            _cap.extend(t, updates)

        return ops.OutputOperator(on_time, name="capture")

    if kind == "subscribe":
        on_change = p.get("on_change")
        on_time_end = p.get("on_time_end")
        on_end = p.get("on_end")
        colnames = p["colnames"]

        def on_time(t, updates):
            if on_change is not None:
                from .types import unwrap_row

                for key, row, diff in updates:
                    row_d = dict(zip(colnames, unwrap_row(row)))
                    on_change(key=key, row=row_d, time=t, is_addition=diff > 0)
            if on_time_end is not None:
                on_time_end(t)

        return ops.OutputOperator(on_time, on_end=on_end, name="subscribe")

    if kind == "output":
        writer = p["writer"]
        colnames = p["colnames"]
        lg.writers.append(writer)

        def on_time(t, updates, _w=writer):
            _w.write_batch(t, colnames, updates)

        return ops.OutputOperator(on_time, on_end=getattr(writer, "close", None), name="output")

    if kind == "gradual_broadcast":
        from .gradual_broadcast import GradualBroadcastOperator

        _src, thr = tables
        return GradualBroadcastOperator(
            _compile(p["lower"]), _compile(p["value"]), _compile(p["upper"]),
            _env_for(thr), name="gradual_broadcast",
        )

    if kind in _EXTRA_LOWERINGS:
        return _EXTRA_LOWERINGS[kind](node, lg)

    raise NotImplementedError(f"no lowering for node kind {kind!r}")


# plug-in lowering registry: node kinds lowered by the modules that build
# them (time and stream operators, asof/asof_now joins, sort, iterate,
# external_index, raw_output)
_EXTRA_LOWERINGS: dict[str, Callable[[pg.OpNode, "LoweredGraph"], Operator]] = {}


def register_lowering(kind: str):
    def deco(fn):
        _EXTRA_LOWERINGS[kind] = fn
        return fn

    return deco


class GraphRunner:
    #: set by ``persistence.attach_persistence`` when snapshots are on
    _snapshot_mgr = None

    def __init__(self, sinks: list[pg.OpNode], terminate_on_error: bool = False,
                 device="cuda"):
        # resolved first: without a card the run raises before lowering
        self.device = resolve_device(device)
        _prefetch_lazy_deps()
        self.lg = lower(sinks, self.device)
        if terminate_on_error:
            from . import operators as _o

            for op in self.lg.scheduler.operators:
                if isinstance(op, _o.OutputOperator):
                    op.terminate_on_error = True

    def run_batch(self) -> dict[int, CapturedStream]:
        """Feed all static events, process times in order, finish."""
        by_time: dict[int, dict[int, list]] = defaultdict(lambda: defaultdict(list))
        columnar: list[tuple[Operator, int, Any]] = []
        for op, source in self.lg.input_ops:
            if _use_static_batches(source):
                # struct-of-arrays sources skip event-tuple plumbing
                for t, batch in source.static_batches():
                    columnar.append((op, t, batch))
                continue
            for t, key, row, diff in source.static_events():
                by_time[t][op.id].append((key, row, diff))
        sched = self.lg.scheduler
        op_by_id = {op.id: op for op, _ in self.lg.input_ops}
        times = sorted(set(by_time) | {t for _op, t, _b in columnar})
        for t in times:
            for op_id, updates in by_time.get(t, {}).items():
                sched.push_input(op_by_id[op_id], t, updates)
            for op, bt, batch in columnar:
                if bt == t:
                    sched.push_input(op, t, batch)
        sched.finish()
        return self.lg.captures

    def run_streaming(
        self,
        autocommit_ms: int = 50,
        timeout_s: float | None = None,
        idle_stop_s: float | None = None,
    ) -> dict[int, CapturedStream]:
        """Poll live sources; stamp each commit with an even logical time."""
        sched = self.lg.scheduler
        live = []
        start = _time.monotonic()
        for op, source in self.lg.input_ops:
            if source.is_live():
                source.start()
                live.append((op, source))
            elif _use_static_batches(source):
                for t, batch in sorted(
                    source.static_batches(), key=lambda tb: tb[0]
                ):
                    sched.push_input(op, t, batch)
                op.finished = True
            else:
                events = source.static_events()
                if events:
                    by_t: dict[int, list[Update]] = defaultdict(list)
                    for t, key, row, diff in events:
                        by_t[t].append((key, row, diff))
                    for t in sorted(by_t):
                        sched.push_input(op, t, by_t[t])
                op.finished = True
        try:
            return self._stream(live, start, autocommit_ms, timeout_s,
                                idle_stop_s)
        finally:
            # the live sources end here (a REST endpoint's webserver shuts
            # down), after a failure too
            for _op, source in live:
                source.stop()

    def _stream(self, live, start, autocommit_ms, timeout_s, idle_stop_s):
        sched = self.lg.scheduler
        sched.run_until_idle()
        last_event = _time.monotonic()
        finished: set[int] = set()
        logical = sched.frontier + 2 if sched.frontier >= 0 else 0
        if logical % 2:
            logical += 1
        # close the initial static time so its output flushes to the sinks
        # even if no live source ever produces an event (an AsyncTransformer
        # feeding only off static input needs its on_change/on_time_end NOW,
        # not at the first live commit)
        sched.pending[logical]  # touch: creates the bucket
        sched._note_time(logical)
        sched.run_until_idle()
        logical += 2

        # per-sink upstream live sources: a sink whose upstream inputs have
        # ALL finished gets its on_end early (reference: subscribe's
        # on_subscribe_end fires when the input frontier closes, not when
        # the whole run stops — the AsyncTransformer feedback loop relies on
        # this to know no more invocations are coming)
        from . import operators as _ops

        live_ids = {op.id for op, _s in live}
        upstream_live: dict[int, set[int]] = {}
        for op in sched.operators:
            if isinstance(op, _ops.OutputOperator):
                seen_up: set[int] = set()
                stack = list(op.inputs)
                ups: set[int] = set()
                while stack:
                    u = stack.pop()
                    if u.id in seen_up:
                        continue
                    seen_up.add(u.id)
                    if u.id in live_ids:
                        ups.add(u.id)
                    stack.extend(u.inputs)
                upstream_live[op.id] = ups
        closed_sinks: set[int] = set()

        def _close_finished_sinks() -> None:
            # in-flight fully-async UDF completions still deliver rows after
            # their (static) inputs finished — no sink may close before they
            # drain, or subscribers would see on_end before those on_changes
            if any(
                getattr(op, "_completions", None) for op in sched.operators
            ):
                return
            for op in sched.operators:
                if (
                    isinstance(op, _ops.OutputOperator)
                    and op.id not in closed_sinks
                    and upstream_live.get(op.id, set()) <= finished
                ):
                    closed_sinks.add(op.id)
                    op.on_end()

        _close_finished_sinks()
        tracker = None
        if os.environ.get("PATHWAY_ELASTIC") == "1":
            from .telemetry import WorkloadTracker

            tracker = WorkloadTracker()
        rescale_code: int | None = None
        while live and len(finished) < len(live):
            loop_t0 = _time.monotonic()
            slept = 0.0
            got_any = False
            for op, source in live:
                if op.id in finished:
                    continue
                events = source.poll()
                if events is None:
                    finished.add(op.id)
                    op.finished = True
                    got_any = True  # a flush tick delivers buffered output
                    continue
                if events:
                    got_any = True
                    updates = [(key, row, diff) for _, key, row, diff in events]
                    sched.push_input(op, logical, updates)
            # async completions need a tick so their flush runs
            has_completions = any(
                getattr(op, "_completions", None) for op in sched.operators
            )
            if got_any or has_completions:
                if not got_any:
                    # schedule an empty time so every operator's flush runs
                    sched.pending[logical]  # touch: creates the bucket
                    sched._note_time(logical)
                sched.run_until_idle()
                logical += 2
                last_event = _time.monotonic()
            else:
                slept = autocommit_ms / 1000.0
                _time.sleep(slept)
            _close_finished_sinks()
            if self._snapshot_mgr is not None:
                self._snapshot_mgr.maybe_snapshot()
            now = _time.monotonic()
            if tracker is not None:
                # busy fraction = non-sleep time / loop time
                loop_el = max(now - loop_t0, 1e-9)
                tracker.record(max(0.0, min(1.0, (loop_el - slept) / loop_el)))
                code = tracker.recommendation()
                if code is not None:
                    from ..cli import MAX_PROCESSES
                    from .telemetry import WorkloadTracker as _WT

                    n_procs = int(os.environ.get("PATHWAY_PROCESSES", "1"))
                    supervised = os.environ.get("PATHWAY_SPAWNED") == "1"
                    at_min = code == _WT.EXIT_CODE_DOWNSCALE and n_procs <= 1
                    at_max = (code == _WT.EXIT_CODE_UPSCALE
                              and n_procs >= MAX_PROCESSES)
                    if supervised and not at_min and not at_max:
                        rescale_code = code
                        break
                    # standalone or at a bound: keep running
            if timeout_s is not None and now - start > timeout_s:
                break
            if any(getattr(s, "replay_backfill_pending", False)
                   or getattr(s, "reading", False) for _o, s in live):
                # waiting out a recorded gap of a paced journal backfill,
                # or a file source reading new files on its thread, is
                # activity, not idleness (timeout_s stays a hard cap)
                last_event = now
            elif idle_stop_s is not None and now - last_event > idle_stop_s:
                break
        # graceful drain, on a rescale too: flush buffered sink output
        for op in self.lg.scheduler.topo_order():
            op.on_end()
        sched.run_until_idle()
        sched.close_pool()
        if rescale_code is not None:
            print(f"[pathway-tpu] workload tracker requests rescale "
                  f"(exit {rescale_code})", file=sys.stderr)
            sys.exit(rescale_code)
        return self.lg.captures


def run_tables(
    *tables: Table, terminate_on_error: bool = False, device="cuda"
) -> list[CapturedStream]:
    """Capture the final update streams of the given tables (test harness —
    mirrors GraphRunner.run_tables, reference tests/utils.py:314), with
    the data plane on ``device`` (default the card; ``device="cpu"``
    runs it on the CPU).

    Graphs with live sources (AsyncTransformer feedback loops, connector
    subjects that close when done) run the streaming loop until those
    sources finish; pure-static graphs take the batch path."""
    sinks = [t._materialize_capture() for t in tables]
    runner = GraphRunner(sinks, terminate_on_error=terminate_on_error,
                         device=device)
    if has_live_sources(sinks):
        # the harness must terminate: sources that close when done (the
        # AsyncTransformer loop, finite connector subjects) finish the run; a genuinely endless source stops after the
        # idle window instead of hanging the test (pw.run is the
        # production entry point with explicit timeout control)
        caps = runner.run_streaming(autocommit_ms=20, idle_stop_s=10.0)
    else:
        caps = runner.run_batch()
    return [caps[s.id] for s in sinks]


def has_live_sources(sinks: list[pg.OpNode]) -> bool:
    seen = set()

    def visit(node) -> bool:
        if node.id in seen:
            return False
        seen.add(node.id)
        if node.kind == "input" and node.params["source"].is_live():
            return True
        return any(visit(t._node) for t in node.input_tables)

    return any(visit(s) for s in sinks)
