"""Replica-parallel serving front over the decode engines.

The port of ``pathway_tpu/serve/fleet.py``.  :class:`ReplicaFleet` runs R
independent :class:`~pathway_tpu_torch.kvcache.engine.PagedDecodeEngine`
replicas (or, with ``cache="state"``,
:class:`~pathway_tpu_torch.kvcache.statecache.StateDecodeEngine`
replicas), each behind its own
:class:`~pathway_tpu_torch.serve.scheduler.RequestScheduler`, and adds
what a fleet needs that an engine cannot provide:

**Prefix-affine routing.**  Prompts are digested with the prefix cache's
own ``chain_hashes`` (one chained digest per full block) and routed to
the replica recorded for the deepest matching digest, so a follow-up
turn of a conversation lands where its history's K/V lives.  Misses go
to the least-loaded live replica, and the route is recorded for the
prompt AND the response (the next turn's prefix).  The table is a
bounded LRU and advisory only: a stale entry costs a cache miss, never
correctness.

**Failover.**  Each engine's ``degrade_fn`` is the fleet's handoff hook
(the ``req=`` form): when a replica's restart budget is spent, every
stranded request re-admits on a live peer carrying its emitted tokens,
its sampling spec (the emit-index seed schedule resumes where the dead
replica stopped, so sampled output is bit-identical) and its streaming
callback.  Requests fail typed (:class:`EngineFailedError`) only when
no live replica remains.

**Shared session tier.**  All replicas point at one
:class:`~pathway_tpu_torch.kvcache.tiering.SessionStore`, so a session
suspended on replica A resumes on replica B (K/V blocks, or a state
cache's fixed-size state).

On one card every replica issues its kernels from its own scheduler
thread on the thread's current stream, which is the device's default
stream unless a caller sets another: the paged kernels share their split
scratch by launch shape (``kvcache/paged_attention.py``) and rely on
running one after another on one stream.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

from ..kvcache.prefix_cache import chain_hashes
from .admission import EngineFailedError, Priority
from .metrics import fleet_stats
from .scheduler import RequestScheduler

logger = logging.getLogger(__name__)


class _Replica:
    __slots__ = ("idx", "engine", "scheduler", "dead", "submitted",
                 "completed", "affinity_hits", "handoffs_out",
                 "recovered_in")

    def __init__(self, idx: int, engine, scheduler):
        self.idx = idx
        self.engine = engine
        self.scheduler = scheduler
        self.dead = False
        self.submitted = 0
        self.completed = 0
        self.affinity_hits = 0
        self.handoffs_out = 0
        self.recovered_in = 0


class ReplicaFleet:
    """R decode engines behind prefix-affine routing with
    cross-replica failover and a shared host session tier.

    Engine keyword arguments (``num_blocks``, ``block_size``,
    ``watchdog_timeout_s``, ``max_restarts``, ``speculative``,
    ``device``, ``tp``, ``devices``, ...) pass through to every replica,
    so ``tp=`` builds each replica's engine sharded at that degree (over
    the same ``devices``); ``degrade_fn`` (if given) becomes the
    LAST-resort tier, consulted only when the whole fleet is dead.

    ``cache="state"`` builds every replica as a constant-memory
    ``StateDecodeEngine``.  Routing, failover and the session tier are
    unchanged: the state cache keeps a ``block_size``, so affinity
    digests chunk prompts the same way (with no prefix cache behind them
    a digest only says where a conversation ran; misses go to the least
    loaded replica), and its suspended states flow through the same
    store."""

    def __init__(self, cfg, params, *, replicas: int = 2,
                 name: str = "fleet", session_store=None,
                 affinity_entries: int = 4096,
                 failover_timeout_s: float = 120.0,
                 scheduler_kwargs: dict | None = None,
                 degrade_fn: Callable | None = None,
                 cache: str = "paged",
                 **engine_kwargs):
        if cache == "state":
            from ..kvcache.statecache import StateDecodeEngine as engine_cls
        elif cache == "paged":
            from ..kvcache.engine import PagedDecodeEngine as engine_cls
        else:
            raise ValueError(f"cache={cache!r}: expected 'paged' or 'state'")
        if int(replicas) < 1:
            raise ValueError("a fleet needs at least one replica")
        self.name = name
        self.session_store = session_store
        self.affinity_entries = int(affinity_entries)
        self.failover_timeout_s = float(failover_timeout_s)
        self._user_degrade = degrade_fn
        self._lock = threading.RLock()
        self._affinity: "OrderedDict[bytes, int]" = OrderedDict()
        self.affinity_hit_count = 0
        self.affinity_miss_count = 0
        # failure -> first-recovered-token-on-a-peer samples (seconds)
        self.recovery_s: list[float] = []
        self._replicas: list[_Replica] = []
        sched_kw = dict(scheduler_kwargs or {})
        sched_kw.setdefault("max_batch_size",
                            int(engine_kwargs.get("max_batch_size", 8)))
        for i in range(int(replicas)):
            engine = engine_cls(
                cfg, params, name=f"{name}_r{i}",
                session_store=session_store,
                degrade_fn=self._make_handoff(i), **engine_kwargs,
            )
            self._replicas.append(self._wire_replica(i, engine, sched_kw))
        self.stats_block = fleet_stats(
            name, replicas=int(replicas),
            live_fn=lambda: len(self.live_replicas()),
            store=session_store, snapshot_fn=self.stats,
        )

    def _wire_replica(self, idx: int, engine, sched_kw: dict) -> _Replica:
        holder: dict = {}

        def batch_fn(reqs, _engine=engine, _h=holder):
            return _engine.serve_batch(reqs, _h.get("sched"))

        sched = RequestScheduler(
            batch_fn, name=f"{self.name}_r{idx}", start=False, **sched_kw,
        )
        holder["sched"] = sched
        sched.start()
        return _Replica(idx, engine, sched)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> list[_Replica]:
        return list(self._replicas)

    def live_replicas(self) -> list[_Replica]:
        with self._lock:
            return [r for r in self._replicas if not r.dead]

    def _load(self, rep: _Replica) -> tuple:
        inflight = rep.submitted - rep.completed
        return (rep.scheduler.queue_depth + inflight, rep.idx)

    # -- routing -----------------------------------------------------------
    def route(self, prompt) -> int:
        """Replica index for this prompt: deepest affinity-digest hit
        among live replicas, else least-loaded."""
        block_size = self._replicas[0].engine.pool.block_size
        digests = chain_hashes(list(prompt), block_size)
        with self._lock:
            live = [r for r in self._replicas if not r.dead]
            if not live:
                raise EngineFailedError(
                    f"every replica of fleet {self.name!r} is dead",
                    retry_after_s=30.0,
                )
            for d in reversed(digests):
                idx = self._affinity.get(d)
                if idx is not None and not self._replicas[idx].dead:
                    self._affinity.move_to_end(d)
                    self.affinity_hit_count += 1
                    self._replicas[idx].affinity_hits += 1
                    self.stats_block.record_route(hit=True)
                    return idx
            self.affinity_miss_count += 1
            self.stats_block.record_route(hit=False)
            return min(live, key=self._load).idx

    def _note_affinity(self, tokens, idx: int) -> None:
        block_size = self._replicas[0].engine.pool.block_size
        digests = chain_hashes(list(tokens), block_size)
        with self._lock:
            for d in digests:
                self._affinity[d] = idx
                self._affinity.move_to_end(d)
            while len(self._affinity) > self.affinity_entries:
                self._affinity.popitem(last=False)

    # -- serving -----------------------------------------------------------
    def submit(self, prompt, max_new: int, *,
               priority: "Priority | str | int" = Priority.NORMAL,
               sampling=None, session=None,
               on_token: Callable | None = None,
               deadline_s: float | None = None,
               timeout_s: float | None = None) -> list[int]:
        """Decode ``max_new`` tokens for ``prompt`` on the routed
        replica, blocking until done.  ``sampling`` is ``(temperature,
        top_k, top_p, seed)`` (or the dict form) — None decodes greedy;
        ``session`` enables KV tiering for the conversation;
        ``on_token`` streams each token as it lands, surviving replica
        failover mid-stream."""
        prompt = [int(t) for t in prompt]
        idx = self.route(prompt)
        rep = self._replicas[idx]
        opts: dict[str, Any] = {}
        if sampling is not None:
            opts["sampling"] = sampling
        if session is not None:
            opts["session"] = session
        if on_token is not None:
            opts["on_token"] = on_token
        payload: tuple = (prompt, int(max_new))
        if opts:
            payload = payload + (opts,)
        with self._lock:
            rep.submitted += 1
        try:
            out = rep.scheduler.submit(
                payload, priority=priority, deadline_s=deadline_s,
                timeout_s=timeout_s,
            )
        finally:
            with self._lock:
                rep.completed += 1
        # affinity learns the prompt AND the response: the next turn
        # extends prompt+out, whose deepest digest now routes back here
        # (after a failover, a dead replica's routes re-learn on the next
        # turn's miss)
        self._note_affinity(prompt + list(out), idx)
        return list(out)

    # -- failover ----------------------------------------------------------
    def _make_handoff(self, idx: int):
        def handoff(prompt, n_remaining, emitted, *, req=None):
            return self._failover(idx, prompt, n_remaining, emitted, req)
        return handoff

    def _failover(self, idx: int, prompt, n_remaining: int, emitted,
                  req) -> list[int]:
        """Re-admit one stranded request on a live peer.  Called from the
        dead replica's ``_try_degrade`` (its restart budget is spent), on
        that replica's scheduler thread, which waits here up to
        ``failover_timeout_s``; raising makes the engine fail the request
        typed, which is right when no peer can take it."""
        t_fail = time.perf_counter()
        rep = self._replicas[idx]
        with self._lock:
            newly_dead = not rep.dead
            rep.dead = True
            rep.handoffs_out += 1
            live = [r for r in self._replicas if not r.dead]
        if newly_dead:
            logger.warning(
                "fleet %s: replica %d is dead (restart budget spent); "
                "%d live peer(s) remain", self.name, idx, len(live),
            )
            self.stats_block.record_replica_death()
        if not live:
            if self._user_degrade is not None:
                return self._user_degrade(
                    list(prompt), n_remaining, list(emitted)
                )
            raise RuntimeError(
                f"fleet {self.name!r}: no live replica to fail over to"
            )
        peer = min(live, key=self._load)
        emitted = [int(t) for t in emitted]
        opts: dict[str, Any] = {"emitted": emitted}
        orig_on_token = None
        priority: Any = Priority.NORMAL
        if req is not None:
            priority = req.priority
            if req.sampling is not None:
                opts["sampling"] = req.sampling
            if req.session is not None:
                opts["session"] = req.session
            orig_on_token = req.on_token

        state = {"first": None}

        def on_token(tok, _s=state, _cb=orig_on_token):
            # failure -> first-recovered-token window, measured at the
            # peer's emit
            if _s["first"] is None:
                _s["first"] = time.perf_counter()
                with self._lock:
                    self.recovery_s.append(_s["first"] - t_fail)
                self.stats_block.record_recovery(_s["first"] - t_fail)
            if _cb is not None:
                _cb(tok)

        opts["on_token"] = on_token
        with self._lock:
            peer.submitted += 1
        try:
            full = peer.scheduler.submit(
                (list(prompt), n_remaining + len(emitted), opts),
                priority=priority, timeout_s=self.failover_timeout_s,
            )
        finally:
            with self._lock:
                peer.completed += 1
                peer.recovered_in += 1
        # the peer returns the FULL emitted list (the carried prefix
        # included); the dead engine's _try_degrade appends only the tail
        return list(full)[len(emitted):]

    # -- ops ---------------------------------------------------------------
    def kill(self, idx: int) -> None:
        """Mark a replica dead for routing (to kill one MID-decode, arm a
        ``faults`` dispatch fault instead and let failover prove itself)."""
        with self._lock:
            self._replicas[idx].dead = True

    def revive(self, idx: int) -> None:
        """Return a (restarted/replaced) replica to the routing set."""
        with self._lock:
            self._replicas[idx].dead = False

    def stats(self) -> dict:
        with self._lock:
            per_replica = [
                {
                    "replica": r.idx,
                    "dead": r.dead,
                    "submitted": r.submitted,
                    "completed": r.completed,
                    "inflight": r.submitted - r.completed,
                    "queue_depth": r.scheduler.queue_depth,
                    "affinity_hits": r.affinity_hits,
                    "handoffs_out": r.handoffs_out,
                    "recovered_in": r.recovered_in,
                }
                for r in self._replicas
            ]
            routed = self.affinity_hit_count + self.affinity_miss_count
            out = {
                "name": self.name,
                "replicas": len(self._replicas),
                "live": sum(1 for r in self._replicas if not r.dead),
                "affinity_hit_rate": (
                    self.affinity_hit_count / routed if routed else 0.0
                ),
                "affinity_entries": len(self._affinity),
                "recovery_s": list(self.recovery_s),
                "per_replica": per_replica,
            }
        if self.session_store is not None:
            out["sessions"] = self.session_store.stats()
        return out

    def shutdown(self, *, drain: bool = True,
                 timeout_s: float = 10.0) -> None:
        for rep in self._replicas:
            rep.scheduler.shutdown(drain=drain, timeout_s=timeout_s)


__all__ = ["ReplicaFleet"]
