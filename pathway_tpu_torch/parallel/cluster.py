"""Multi-worker execution of the sharded data plane.

The port of ``pathway_tpu/parallel/cluster.py`` (the reference's worker
cluster, src/engine/dataflow/config.rs:109-185 with the vendored
timely-dataflow): `workers = threads x processes` shards, collections
partitioned by key, records exchanged at re-key boundaries, progress agreed
through a deterministic per-time protocol instead of timely's asynchronous
frontier gossip.

One `ClusterRunner` per OS process owns `threads` contiguous shards and
walks (time, topo-position, shard) in the same deterministic order on every
process.  Exchange edges (groupby/join re-key, centralized ops) are "wait
positions": before processing one, a process posts a COUNTED mark ("I
finished every earlier position at this time; here is how many data
frames I stamped for you at every earlier exchange point") and
count-proves all peers' exchange points instead of treating the mark as
a FIFO barrier.  Marks ride the fabric's control lane while bulk data
frames are pickled+written on per-peer sender threads, so a peer's
serialization never extends this process's mark wait, and a quiet
exchange point costs one tiny control frame.  The coordinator (process
0) agrees the next time via an allreduce-min over pending times; each
process folds the target times of its not-yet-walked sends into its
report (the sender "vouches" a frame until it has itself processed the
target time, whose counted mark points then prove delivery everywhere)
— the round is split into an async `begin` posted at the tail of each
processed time and a `finish` that blocks only when the next time is
actually needed, so the round for time t+1 rides under the slowest
peer's compute for time t.  Output/capture operators are centralized on
shard 0 (process 0), so sink effects happen exactly once.

Cross-process traffic is aggregates-first: exchange edges into
key-insensitive groupbys (plain-column groupings with count/sum/avg/
min/max reducers) consolidate the outgoing batch by row value
(``mapreduce.combine_for_exchange``) — the multiset of (row, diff) is
preserved exactly, so results are identical — and partitioned live
sources keep their polled rows on the polling process's own shards
(keys are content-derived, and the next key/group-routed exchange
re-partitions anyway), so raw input rows are never shuffled.

The device: every shard is lowered with ``runner.lower(sinks, device)``,
so its vectorized plans, segment reductions and join membership run on
the process's data-plane device (default ``"cuda"``, resolved before any
lowering or mesh formation: a process without a card raises at once,
and there is no CPU fallback).  The threads of one process are shards
walked in turn on that one device; the processes of one host all use
``cuda:0``.  Each shard's batches are the rows routed to it, so the
vectorized tier's crossovers (``engine.vectorize.DEVICE_THRESHOLD``,
``mapreduce._JIT_MIN_ELEMENTS``) compare against a shard's share of a
batch, not the whole.

With n_processes == 1 there is no fabric and the same walk degrades to the
sequential sharded execution.  Live sources are stopped when a streaming
run ends, after a failure too.
"""

from __future__ import annotations

import os
import sys
import time as _time
from collections import defaultdict
from typing import Any, Callable

from .. import faults, obs
from .._device import resolve_device
from ..engine import runner as runner_mod
from ..engine.graph import Operator
from ..engine.types import CapturedStream, Update
from ..internals import parse_graph as pg
from .sharded import ShardRouter, edge_router, _BROADCAST, _CENTRAL, _SHARD_BY_KEY
from .comm import ClusterAborted, Fabric, FabricError
from . import mapreduce

# node kinds whose output keys equal their input keys, so key-routed
# downstream edges never move rows between shards
_KEY_PRESERVING = {
    "rowwise", "filter", "update_rows", "update_cells", "concat",
    "difference", "intersect",
}


class ClusterRunner:
    def __init__(
        self,
        sinks: list[pg.OpNode],
        n_local_shards: int = 1,
        pid: int = 0,
        nprocs: int = 1,
        first_port: int = 10000,
        device="cuda",
    ):
        # resolved first: a process without a card raises before it
        # lowers anything or joins the mesh
        self.device = resolve_device(device)
        self.pid = pid
        self.nprocs = nprocs
        self.threads = n_local_shards
        self.n_total = n_local_shards * nprocs
        self.owned = list(
            range(pid * n_local_shards, (pid + 1) * n_local_shards)
        )
        self.sinks = sinks
        # one lowered graph per owned shard (same deterministic lowering on
        # every process, so topo positions and operator ids line up)
        self.graphs = {s: runner_mod.lower(sinks, self.device)
                       for s in self.owned}
        self.lg = self.graphs[self.owned[0]]
        base = self.lg
        self.topo: dict[int, list[Operator]] = {
            s: g.scheduler.topo_order() for s, g in self.graphs.items()
        }
        self.n_pos = len(self.topo[self.owned[0]])
        base_topo = self.topo[self.owned[0]]
        pos_of_opid = {op.id: i for i, op in enumerate(base_topo)}
        # node per position (base graph)
        opid_to_nid = {op.id: nid for nid, op in base.by_node.items()}
        self.nodes: dict[int, pg.OpNode] = {}
        all_nodes = _collect_nodes(sinks)
        for pos, op in enumerate(base_topo):
            nid = opid_to_nid.get(op.id)
            if nid is not None and nid in all_nodes:
                self.nodes[pos] = all_nodes[nid]
        # routers per (downstream pos, port)
        self.routers: dict[tuple[int, int], ShardRouter] = {}
        for pos, node in self.nodes.items():
            for port in range(max(1, len(node.input_tables))):
                self.routers[(pos, port)] = edge_router(node, port, self.n_total)
        # per-shard edge lists: op.id -> [(down_pos, port)]
        self.edges: dict[int, dict[int, list[tuple[int, int]]]] = {}
        for s, topo in self.topo.items():
            pos_of = {op.id: i for i, op in enumerate(topo)}
            emap: dict[int, list[tuple[int, int]]] = {}
            for op in topo:
                emap[op.id] = [
                    (pos_of[down.id], port) for down, port in op.downstream
                ]
            self.edges[s] = emap
        # positions of input operators (base graph)
        self.input_pos: dict[int, int] = {}  # pos -> index into input_ops
        base_inputs = {op.id: i for i, (op, _src) in enumerate(base.input_ops)}
        for pos, op in enumerate(base_topo):
            if op.id in base_inputs:
                self.input_pos[pos] = base_inputs[op.id]
        # inputs whose live source is partitioned across processes keep
        # their polled rows on the polling process's own shards — which also means their output is NOT
        # key-partitioned, so downstream key-routed edges must exchange
        self._local_keep_inputs: set[int] = set()
        if nprocs > 1:
            for idx, (_op, source) in enumerate(base.input_ops):
                if source.is_live() and hasattr(source, "set_partition"):
                    self._local_keep_inputs.add(idx)
        self.wait_positions = self._compute_wait_positions()
        # exchange combiner specs: edges into key-insensitive
        # groupbys consolidate outgoing batches by row value, so only
        # aggregates cross the fabric (parallel/mapreduce.py)
        self._combine_specs: dict[tuple[int, int], tuple] = {}
        if nprocs > 1:
            base_ops = self.topo[self.owned[0]]
            for pos, node in self.nodes.items():
                if node.kind != "groupby":
                    continue
                spec = mapreduce.exchange_combine_spec(base_ops[pos])
                if spec is not None:
                    self._combine_specs[(pos, 0)] = spec
        # execution state
        # pending[time][(pos, shard)] = [(producer, seq, port, updates)]
        self.pending: dict[int, dict[tuple[int, int], list]] = defaultdict(
            lambda: defaultdict(list)
        )
        self._seq = 0
        self.frontier = -2
        self.cur_t: int | None = None
        # times that must run even with no data (flush-only ticks so async
        # completions and temporal-behavior flushes fire)
        self._force_times: set[int] = set()
        self.captures: dict[int, CapturedStream] = dict(base.captures)
        self.fabric: Fabric | None = None
        if nprocs > 1:
            self.fabric = Fabric(pid, nprocs, first_port)
        self._aborted = False
        # outstanding pipelined min-agreement round (posted report), if any
        self._agree_pending: tuple | None = None
        # data-plane trace: per-round spans (run_time / agree_min) for
        # this process land here
        self._obs_ctx = (obs.new_trace_id(), 0)
        # redirect each shard scheduler's route() into the cluster router —
        # bound once here, never per visit
        for s in self.owned:
            self.graphs[s].scheduler.route = self._make_route(s)  # type: ignore[method-assign]
        self.input_router = ShardRouter(_SHARD_BY_KEY, self.n_total)

    # -- topology analysis -------------------------------------------------
    def _compute_wait_positions(self) -> set[int]:
        """Positions that can receive batches from another process: any
        input edge whose router is not provably shard-local.  A key-routed
        edge is local iff its producer's output is key-partitioned (keys
        unchanged since the key-partitioned input)."""
        keypart: dict[int, bool] = {}  # node id -> bool
        wait: set[int] = set()
        for pos in range(self.n_pos):
            node = self.nodes.get(pos)
            if node is None:
                continue
            if node.kind == "input":
                # a local-keep input (a partitioned live source)
                # places rows on the POLLING process's shards, so its
                # output is not key-partitioned and downstream key-routed
                # edges must exchange; every other input injects by key
                idx = self.input_pos.get(pos)
                keypart[node.id] = idx not in self._local_keep_inputs
                wait.add(pos)
                continue
            ups = [t._node for t in node.input_tables]
            if node.kind in _KEY_PRESERVING and ups:
                keypart[node.id] = all(keypart.get(u.id, False) for u in ups)
            else:
                keypart[node.id] = False
            for port, up in enumerate(ups):
                router = self.routers.get((pos, port))
                if router is None:
                    wait.add(pos)
                elif router.kind == _SHARD_BY_KEY and keypart.get(up.id, False):
                    continue  # provably local
                else:
                    wait.add(pos)
        return wait

    def owner_of(self, shard: int) -> int:
        return shard // self.threads

    def owns_event(self, event) -> bool:
        """Ownership filter for replicated injection (static reads, journal
        replay): (time, key, row, diff) belongs to this process iff the input
        key router lands it on an owned shard."""
        shard = self.input_router.shard_of((event[1], event[2], event[3]))
        return self.owner_of(shard) == self.pid

    # -- routing -----------------------------------------------------------
    def _make_route(self, shard: int) -> Callable:
        edges = self.edges[shard]
        routers = self.routers

        def route(source: Operator, time: int, updates: list[Update]) -> None:
            if self.cur_t is not None and time < self.cur_t:
                raise RuntimeError(
                    f"operator {source.name} emitted at past time "
                    f"{time} < {self.cur_t}"
                )
            for down_pos, port in edges[source.id]:
                router = routers.get((down_pos, port))
                if router is None or router.kind == _CENTRAL:
                    self._deliver(time, down_pos, port, 0, updates)
                    continue
                if router.kind == _BROADCAST:
                    for s2 in range(self.n_total):
                        self._deliver(time, down_pos, port, s2, updates)
                    continue
                edge_updates = updates
                spec = self._combine_specs.get((down_pos, port))
                if spec is not None:
                    # consolidate BEFORE routing: the edge
                    # feeds a key-insensitive groupby, so merging equal
                    # rows first means the per-row group-key hash below
                    # runs once per DISTINCT row — profiling showed that
                    # hash, not the wire, was the 2-proc exchange tax
                    combined = mapreduce.combine_for_exchange(
                        edge_updates, spec
                    )
                    if combined is not None:
                        edge_updates = combined
                per_shard: dict[int, list[Update]] = defaultdict(list)
                for u in edge_updates:
                    per_shard[router.shard_of(u)].append(u)
                for s2, us in per_shard.items():
                    self._deliver(time, down_pos, port, s2, us)

        return route

    def _deliver(self, time: int, pos: int, port: int, shard: int,
                 updates: list[Update]) -> None:
        owner = self.owner_of(shard)
        self._seq += 1
        if owner == self.pid:
            self.pending[time][(pos, shard)].append(
                (self.pid, self._seq, port, updates)
            )
        else:
            assert self.fabric is not None
            # NOTE: no consolidation here — combine-eligible edges are
            # groupby inputs, whose router is always the keyed kind, so
            # route() consolidated the batch BEFORE the per-shard split
            # (re-combining the already-distinct slice would be a wasted
            # O(n) pass on the hot path).
            # A send stamped at the currently-walked time is covered by
            # the counted mark this process posts when crossing (time,
            # pos); anything else (cross-time emission, on_end flush) is
            # vouched in the min-agreement until this process has walked
            # the target time.
            self.fabric.send_data(owner, time, pos, port, shard, self._seq,
                                  updates, vouch=(time != self.cur_t))

    def _inject(self, input_idx: int, events: list, exclusive: bool,
                time_override: int | None = None) -> None:
        """Feed source events.  Replicated sources (every process read the
        whole thing, e.g. static files) keep only owned shards.  Exclusive
        sources (one reader per event) route their slice: a PARTITIONED
        source keeps its rows on this process's own shards (keys are
        content-derived, so a row's owner does not depend on which process
        parsed it, and the next key- or group-routed exchange re-partitions
        anyway), while a pinned unpartitioned source still ships rows to
        their key's owner so downstream work spreads across processes."""
        pos = next(p for p, i in self.input_pos.items() if i == input_idx)
        local_keep = input_idx in self._local_keep_inputs
        per: dict[tuple[int, int], list[Update]] = defaultdict(list)
        for t, key, row, diff in events:
            if time_override is not None:
                t = time_override
            shard = self.input_router.shard_of((key, row, diff))
            if local_keep:
                shard = self.owned[shard % self.threads]
            owner = self.owner_of(shard)
            if owner != self.pid and not exclusive:
                continue
            per[(t, shard)].append((key, row, diff))
        for (t, shard), ups in per.items():
            owner = self.owner_of(shard)
            self._seq += 1
            if owner == self.pid:
                self.pending[t][(pos, shard)].append(
                    (self.pid, self._seq, 0, ups)
                )
            else:
                assert self.fabric is not None
                self.fabric.send_data(owner, t, pos, 0, shard, self._seq, ups)

    # -- per-time execution ------------------------------------------------
    def _fabric_wait_s(self) -> float:
        """Sum of the fabric's attributed non-compute time (serialize +
        socket writes, mark/data/ctl barrier waits) — the subtrahend of
        the compute_s attribution below."""
        st = self.fabric.stats
        return (st["send_s"] + st["wait_marks_s"] + st["wait_data_s"]
                + st["wait_ctl_s"])

    def _run_time(self, t: int) -> None:
        rt0 = _time.perf_counter()
        w0 = self._fabric_wait_s() if self.fabric is not None else 0.0
        self.cur_t = t
        bucket = self.pending[t]
        for pos in range(self.n_pos):
            if self.fabric is not None and pos in self.wait_positions:
                # counted mark: posted on the control lane with
                # this process's cumulative per-(peer, t, pos') frame
                # counts; the wait count-proves every peer's exchange
                # point instead of blocking on a FIFO mark frame queued
                # behind bulk data
                # chaos: fabric.mark is the "die mid-exchange" fault
                # point (fire() early-returns cheaply when nothing armed)
                faults.fire("fabric.mark", time=t, pos=pos)
                self.fabric.post_mark(t, pos)
                self.fabric.wait_marks(t, pos)
                for producer, seq, port, shard, updates in self.fabric.take_data(t, pos):
                    bucket[(pos, shard)].append((producer, seq, port, updates))
            for s in self.owned:
                batches = bucket.pop((pos, s), None)
                op = self.topo[s][pos]
                if batches:
                    batches.sort(key=lambda b: (b[0], b[1]))
                    for _pr, _seq, port, updates in batches:
                        op.rows_in += len(updates)
                        op.process(port, updates, t)
                op.flush(t)
        if not self.pending.get(t):
            self.pending.pop(t, None)
        self._force_times.discard(t)
        self.frontier = max(self.frontier, t)
        # each shard's scheduler keeps the walked frontier too: operators
        # read it (an async select's on_end emits after it) and so do the
        # metrics server and the dashboards
        for s in self.owned:
            self.graphs[s].scheduler.frontier = self.frontier
        self.cur_t = None
        if self.fabric is not None:
            # this process has walked `t` under the agreement, so every
            # send targeting times <= t is delivery-proven by the counted
            # mark points of that walk — stop vouching for them
            self.fabric.confirm_below(t)
            # pipelined coordinator round: post the NEXT min
            # report right here, before bookkeeping and before whatever
            # host work the caller does next, so the round for time t+1
            # rides under the slowest peer's remaining compute for t
            self._begin_agree_min()
            self.fabric.prune_marks(t)
            # this time's wall minus the
            # fabric waits/sends that accrued inside it is the process's
            # COMPUTE share — the `pathway_fabric{stat="compute_s"}`
            # bucket that turns "wait_marks dominates the 2-proc wall"
            # from a guess into a measured split
            rt1 = _time.perf_counter()
            st = self.fabric.stats
            st["compute_s"] += max(
                (rt1 - rt0) - (self._fabric_wait_s() - w0), 0.0
            )
            obs.record_span("cluster.run_time", rt0, rt1,
                            ctx=self._obs_ctx, time=t)

    def _local_min_pending(self) -> int | None:
        times = [t for t, b in self.pending.items() if b]
        times.extend(self._force_times)
        if self.fabric is not None:
            times.extend(self.fabric.pending_times())
        return min(times) if times else None

    # -- control plane -----------------------------------------------------
    def _timed_recv_ctl(self, stat: str = "wait_ctl_s"):
        """recv_ctl with the wait billed to an explicit stat: wait_ctl_s
        inside the min-agreement round (coordinator-round cost),
        wait_sync_s for gather/broadcast rendezvous (tick/shutdown
        synchronization — kept distinct so the overlap work
        cannot hide stalls there; a streaming worker's idle recv_ctl for
        the next tick command lands in wait_sync_s, visible but separate
        from the compute/marks/round split)."""
        t0 = _time.perf_counter()
        msg = self.fabric.recv_ctl()
        self.fabric.stats[stat] += _time.perf_counter() - t0
        return msg

    def _begin_agree_min(self) -> None:
        """Async half of the allreduce-min round: snapshot this
        process's minimum pending logical time — local pending buckets,
        force-ticks, stashed remote data, and the target times of sends
        it still vouches for (out-of-walk sends whose delivery is proven
        only once their target time is walked) — and post the report.
        Non-blocking: the report rides the fabric's sender thread, and
        the coordinator's gather happens in :meth:`_finish_agree_min`,
        so the round overlaps whatever compute happens in between."""
        if self.fabric is None or self._agree_pending is not None:
            return
        b0 = _time.perf_counter()
        local = self._local_min_pending()
        vmin = self.fabric.vouched_min()
        if vmin is not None:
            local = vmin if local is None else min(local, vmin)
        if self.pid != 0:
            self.fabric.send_ctl(0, ("min", self.pid, local))
        self._agree_pending = (local, b0)

    def _finish_agree_min(self) -> int | None:
        """Blocking half: gather (coordinator) or await (worker) the
        round posted by :meth:`_begin_agree_min` and return the agreed
        next time.  Only this half can stall, and only when the next
        time is actually needed — the report/reply transport already
        happened under overlapped compute."""
        assert self._agree_pending is not None, "begin_agree_min not posted"
        local, b0 = self._agree_pending
        self._agree_pending = None
        am0 = _time.perf_counter()
        if self.pid == 0:
            vals = [] if local is None else [local]
            for _ in range(self.nprocs - 1):
                tag, _pid, m = self._timed_recv_ctl()
                assert tag == "min", tag
                if m is not None:
                    vals.append(m)
            agreed = min(vals) if vals else None
            self.fabric.broadcast_ctl(("adv", agreed))
        else:
            tag, agreed = self._timed_recv_ctl()
            assert tag == "adv", tag
        am1 = _time.perf_counter()
        # agree_min_s counts only the blocking finish; the span covers
        # begin->finish so traces show how much of the round was hidden
        self.fabric.stats["agree_min_s"] += am1 - am0
        obs.record_span("cluster.agree_min", b0, am1, ctx=self._obs_ctx,
                        agreed=agreed if agreed is not None else "none",
                        finish_wait_s=round(am1 - am0, 6))
        return agreed

    def _gather(self, payload: tuple) -> list | None:
        """Workers send payload to pid0; pid0 returns the list (incl. own)."""
        if self.fabric is None:
            return [payload]
        if self.pid == 0:
            out = [payload]
            for _ in range(self.nprocs - 1):
                tag, p = self._timed_recv_ctl("wait_sync_s")
                assert tag == "rep", tag
                out.append(p)
            return out
        self.fabric.send_ctl(0, ("rep", payload))
        return None

    def _broadcast(self, payload) -> Any:
        if self.fabric is None:
            return payload
        if self.pid == 0:
            self.fabric.broadcast_ctl(("cmd", payload))
            return payload
        tag, p = self._timed_recv_ctl("wait_sync_s")
        assert tag == "cmd", tag
        return p

    # -- drains ------------------------------------------------------------
    def _agreed_drain(self) -> None:
        """Process every globally-pending logical time in ascending order.
        With a fabric, each round is pipelined: `_run_time` posts the next
        round's report at its own tail, so the blocking `finish` here
        usually finds the reports already gathered."""
        if self.fabric is None:
            while True:
                m = self._local_min_pending()
                if m is None:
                    return
                self._run_time(m)
        self._begin_agree_min()
        while True:
            m = self._finish_agree_min()
            if m is None:
                return
            self._run_time(m)
            # normally a no-op: _run_time already began the next round
            self._begin_agree_min()

    def _input_barrier(self) -> None:
        """A protocol point, not a rendezvous: emissions shipped to peers
        must arrive before the next agreed drain decides there is no
        work, and the drain's min-agreement sees
        in-flight sends directly (the sender reports their target times
        and per-peer counts until delivery is count-confirmed —
        :meth:`_begin_agree_min`), so no round trip is needed.  An
        explicit no-op so the call sites mark where the guarantee is
        consumed."""
        return

    def _end_phase(self) -> None:
        """Graceful shutdown mirroring Scheduler.finish: interior operators'
        on_end position by position (each followed by a full agreed drain so
        downstream sees upstream final batches before its own on_end), then
        sinks last."""
        sink_positions: list[int] = []
        for pos in range(self.n_pos):
            base_op = self.topo[self.owned[0]][pos]
            if not base_op.downstream:
                sink_positions.append(pos)
                continue
            self.cur_t = None
            for s in self.owned:
                op = self.topo[s][pos]
                # interior on_end emissions route normally (often at the end
                # time; temporal buffers may flush at their own earlier times)
                op.on_end()
            self._input_barrier()
            self._agreed_drain()
        for pos in sink_positions:
            router = self.routers.get((pos, 0))
            for s in self.owned:
                if s != 0 and (router is None or router.kind == _CENTRAL):
                    # a centralized sink lives on shard 0: its replicas
                    # saw no row, and a user's on_end runs once
                    continue
                self.topo[s][pos].on_end()
        self._input_barrier()
        self._agreed_drain()

    # -- sources -----------------------------------------------------------
    def _prepare_sources(self):
        """Partition live sources across processes where supported; pin
        non-partitionable live sources to process 0 (reference: non-sharded
        readers run on one worker, src/connectors/data_storage/sharding.rs).
        Every live source has exactly one reader per event, so its events
        are always injected exclusively (shipped to their owners)."""
        static_srcs: list[tuple[int, Any]] = []
        live_srcs: list[tuple[int, Any]] = []
        for idx, (_op, source) in enumerate(self.lg.input_ops):
            if source.is_live():
                partitioned = False
                if self.nprocs > 1 and hasattr(source, "set_partition"):
                    source.set_partition(self.pid, self.nprocs)
                    partitioned = True
                if partitioned or self.pid == 0 or self.nprocs == 1:
                    live_srcs.append((idx, source))
            else:
                static_srcs.append((idx, source))
        return static_srcs, live_srcs

    # -- coordinated abort --------------------------------------
    def _abort(self, exc: BaseException) -> None:
        """Failure path for a cluster run: poison every peer (so the
        whole mesh aborts at its current protocol point instead of each
        survivor timing out alone), dump fabric stats + the flight
        recorder, and close the fabric.  The original typed error
        (PeerLostError / ClusterAborted / whatever the operator raised)
        propagates to the caller unchanged."""
        if self._aborted or self.fabric is None:
            return
        self._aborted = True
        import logging

        logging.getLogger(__name__).error(
            "pid %d aborting cluster run: %s: %s",
            self.pid, type(exc).__name__, exc,
        )
        try:
            if not isinstance(exc, ClusterAborted):
                # a ClusterAborted means a peer already poisoned the mesh
                self.fabric.poison(
                    f"pid {self.pid}: {type(exc).__name__}: {exc}"
                )
        except Exception:  # noqa: BLE001 - abort is best-effort
            pass
        try:
            _dump_fabric_stats(self.fabric, self.pid)
        except Exception:  # noqa: BLE001
            pass
        try:
            obs.recorder().dump_on_failure("cluster_abort", exc)
        except Exception:  # noqa: BLE001
            pass
        try:
            self.fabric.close()
        except Exception:  # noqa: BLE001
            pass

    # -- public entry points ----------------------------------------------
    def run_batch(self) -> dict[int, CapturedStream]:
        try:
            return self._run_batch_inner()
        except SystemExit:
            raise
        except BaseException as exc:
            self._abort(exc)
            raise

    def _run_batch_inner(self) -> dict[int, CapturedStream]:
        static_srcs, live_srcs = self._prepare_sources()
        for idx, source in static_srcs:
            self._inject(idx, source.static_events(), exclusive=False)
        self._input_barrier()
        self._agreed_drain()
        self._end_phase()
        if self.fabric is not None:
            self.fabric.shutdown_barrier()
            _dump_fabric_stats(self.fabric, self.pid)
            self.fabric.close()
        return self.captures

    def run_streaming(
        self,
        autocommit_ms: int = 50,
        timeout_s: float | None = None,
        idle_stop_s: float | None = None,
    ) -> dict[int, CapturedStream]:
        try:
            return self._run_streaming_inner(
                autocommit_ms=autocommit_ms, timeout_s=timeout_s,
                idle_stop_s=idle_stop_s,
            )
        except SystemExit:
            raise
        except BaseException as exc:
            self._abort(exc)
            raise
        finally:
            # the live sources end here (a REST endpoint's webserver
            # shuts down), after a failure too
            for _idx, source in getattr(self, "_live_srcs", ()):
                source.stop()

    def _run_streaming_inner(
        self,
        autocommit_ms: int = 50,
        timeout_s: float | None = None,
        idle_stop_s: float | None = None,
    ) -> dict[int, CapturedStream]:
        static_srcs, live_srcs = self._prepare_sources()
        self._live_srcs = live_srcs
        for idx, source in static_srcs:
            self._inject(idx, source.static_events(), exclusive=False)
        for _idx, source in live_srcs:
            source.start()
        self._input_barrier()
        self._agreed_drain()
        start = _time.monotonic()
        last_event = _time.monotonic()
        finished: set[int] = set()
        rescale_code: int | None = None
        tracker = None
        if os.environ.get("PATHWAY_ELASTIC") == "1" and self.pid == 0:
            from ..engine.telemetry import WorkloadTracker

            tracker = WorkloadTracker()
        logical = self.frontier + 2
        logical += logical % 2
        # total live sources across the cluster (for the finish decision)
        n_live_total = self._sum_across(len(live_srcs))
        prev_active = True
        # the run-deadline stop decision is AGREED, not local.
        # Every process reports its own elapsed wall clock in the
        # per-round gather; the coordinator finishes when the cluster-wide
        # MAX elapsed passes timeout_s and broadcasts the single finish
        # command — so all peers stop at the same agreed tick instead of
        # racing their own clocks (a worker whose clock started earlier
        # can no longer observe its own deadline mid-protocol).
        peers_elapsed = 0.0
        while True:
            loop_t0 = _time.monotonic()
            # coordinator decides the tick; everyone else follows
            if self.pid == 0:
                slept = 0.0
                if not prev_active:
                    slept = autocommit_ms / 1000.0
                    _time.sleep(slept)
                now = _time.monotonic()
                elapsed = max(now - start, peers_elapsed)
                cmd: tuple
                if timeout_s is not None and elapsed > timeout_s:
                    cmd = ("finish",)
                elif idle_stop_s is not None and now - last_event > idle_stop_s:
                    cmd = ("finish",)
                elif rescale_code is not None:
                    cmd = ("rescale", rescale_code)
                else:
                    # coordinated snapshot wave: every process snapshots
                    # after draining the SAME tick, so the per-process
                    # snapshots form one consistent cut of the cluster
                    snap_now = False
                    mgr0 = getattr(self, "_snapshot_mgr", None)
                    if mgr0 is not None and mgr0.due():
                        snap_now = True
                    cmd = ("tick", logical, snap_now)
                cmd = self._broadcast(cmd)
            else:
                slept = 0.0
                cmd = self._broadcast(None)
            if cmd[0] == "finish":
                break
            if cmd[0] == "rescale":
                rescale_code = cmd[1]
                break
            t = cmd[1]
            got_any = False
            for idx, source in live_srcs:
                if idx in finished:
                    continue
                events = source.poll()
                if events is None:
                    finished.add(idx)
                    continue
                if events:
                    got_any = True
                    self._inject(idx, events, exclusive=True, time_override=t)
            self._input_barrier()
            has_completions = any(
                getattr(op, "_completions", None)
                for s in self.owned
                for op in self.topo[s]
            )
            if got_any or has_completions:
                # force the tick time so every operator's flush runs even if
                # all this tick's rows were shipped to peers
                self._force_times.add(t)
            # every process drains unconditionally: the agreement protocol
            # itself discovers whether any peer has work at any time
            self._agreed_drain()
            mgr = getattr(self, "_snapshot_mgr", None)
            if mgr is not None and len(cmd) > 2 and cmd[2]:
                mgr.snapshot()
            # gather round state (incl. each process's elapsed clock —
            # the agreed-deadline input for the next round's decision,
            # and whether a file source is reading new files)
            reading = any(getattr(source, "reading", False)
                          for _idx, source in live_srcs)
            reports = self._gather(
                (len(finished), got_any, has_completions, self.frontier,
                 _time.monotonic() - start, reading)
            )
            if self.pid == 0:
                assert reports is not None
                n_finished = sum(r[0] for r in reports)
                any_events = any(r[1] for r in reports)
                any_comps = any(r[2] for r in reports)
                global_frontier = max(r[3] for r in reports)
                peers_elapsed = max(r[4] for r in reports)
                prev_active = any_events or any_comps
                if any_events or any(r[5] for r in reports):
                    # a source reading new files is activity
                    last_event = _time.monotonic()
                logical = max(logical + 2, global_frontier + 2)
                logical += logical % 2
                if n_live_total and n_finished >= n_live_total and not any_comps:
                    # all sources done everywhere: one more loop to broadcast
                    timeout_s = -1.0  # force finish next round
                if tracker is not None:
                    now2 = _time.monotonic()
                    loop_el = max(now2 - loop_t0, 1e-9)
                    tracker.record(
                        max(0.0, min(1.0, (loop_el - slept) / loop_el))
                    )
                    code = tracker.recommendation()
                    if code is not None:
                        from ..cli import MAX_PROCESSES
                        from ..engine.telemetry import WorkloadTracker as _WT

                        supervised = os.environ.get("PATHWAY_SPAWNED") == "1"
                        at_min = (
                            code == _WT.EXIT_CODE_DOWNSCALE and self.nprocs <= 1
                        )
                        at_max = (
                            code == _WT.EXIT_CODE_UPSCALE
                            and self.nprocs >= MAX_PROCESSES
                        )
                        if supervised and not at_min and not at_max:
                            rescale_code = code
        self._end_phase()
        if self.pid == 0:
            # one measured epoch row per completed run: the planner's
            # elastic-membership evidence (choose_process_count argmins
            # over these p<n> buckets on the next supervised restart)
            try:
                from ..obs import costdb

                costdb.default_db().observe(
                    "pw.cluster.epoch", f"p{self.nprocs}",
                    ms=(_time.monotonic() - start) * 1e3,
                )
            except Exception:  # noqa: BLE001 - read-only cache dirs etc.
                pass
        if self.fabric is not None:
            self.fabric.shutdown_barrier()
            _dump_fabric_stats(self.fabric, self.pid)
            self.fabric.close()
        if rescale_code is not None:
            print(
                f"[pathway-tpu] workload tracker requests rescale "
                f"(exit {rescale_code})", file=sys.stderr,
            )
            sys.exit(rescale_code)
        return self.captures

    def _sum_across(self, local: int) -> int:
        reports = self._gather((local,))
        if self.pid == 0:
            assert reports is not None
            total = sum(r[0] for r in reports)
            return int(self._broadcast(("sum", total))[1])
        return int(self._broadcast(None)[1])


def _collect_nodes(sinks: list[pg.OpNode]) -> dict[int, pg.OpNode]:
    seen: dict[int, pg.OpNode] = {}
    stack = list(sinks)
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen[node.id] = node
        stack.extend(t._node for t in node.input_tables)
    return seen


def run_tables_sharded(*tables, n_shards: int = 4,
                       device="cuda") -> list[CapturedStream]:
    """Single-process sharded execution (test harness parity with
    ``runner.run_tables``; reference tests run suites under
    PATHWAY_THREADS>1).  Graphs with live sources run the streaming loop
    until they finish, as ``run_tables`` does."""
    sinks = [t._materialize_capture() for t in tables]
    runner = ClusterRunner(sinks, n_local_shards=n_shards, device=device)
    if runner_mod.has_live_sources(sinks):
        caps = runner.run_streaming(autocommit_ms=20, idle_stop_s=10.0)
    else:
        caps = runner.run_batch()
    return [caps[s.id] for s in sinks]


def _dump_fabric_stats(fabric, pid: int) -> None:
    """Write exchange counters, with the wall-clock time the mesh formed
    (``formed_unix``), where the supervisor or a benchmark can read them
    (PW_FABRIC_STATS_DIR); always logged at debug level."""
    import json as _json
    import logging as _logging
    import os as _os

    _logging.getLogger(__name__).debug("fabric stats pid=%s: %s", pid,
                                       fabric.stats)
    d = _os.environ.get("PW_FABRIC_STATS_DIR")
    if d:
        try:
            _os.makedirs(d, exist_ok=True)
            with open(_os.path.join(d, f"fabric_{pid}.json"), "w") as f:
                _json.dump(dict(fabric.stats, formed_unix=getattr(
                    fabric, "formed_unix", None)), f)
        except OSError:
            pass
