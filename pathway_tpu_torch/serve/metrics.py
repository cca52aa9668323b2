"""Serving, cache and fleet counters and their Prometheus/OTLP rendering
(the port of ``pathway_tpu/serve/metrics.py``).

One :class:`ServeStats` per scheduler or admission controller, one
:class:`KVCacheStats` per KV pool (every engine records its TTFT, chain,
host-gap, speculation and restart counters there, whatever its cache),
one :class:`StateCacheStats` per SSD state cache, one :class:`FleetStats`
per replica fleet, and the session stores (``kvcache/tiering.py``), each
in a process-wide registry.  :func:`render_prometheus_lines` and
:func:`otlp_points` render them, the observatory's ``pathway_xla_*``
program lines included, under the reference's metric names (one
dashboard reads both packages).

Metric names (Prometheus):

- ``pathway_serve_queue_depth{scheduler}``           gauge
- ``pathway_serve_admitted_total{scheduler}``        counter
- ``pathway_serve_completed_total{scheduler}``       counter
- ``pathway_serve_shed_total{scheduler,reason}``     counter
  (reasons: ``queue_full``, ``deadline``, ``timeout``, ``rate_limit``,
  ``closed``)
- ``pathway_serve_degraded_total{scheduler}``        counter
- ``pathway_serve_deadline_miss_total{scheduler}``   counter
- ``pathway_serve_batches_total{scheduler}``         counter (device calls)
- ``pathway_serve_batched_requests_total{scheduler}``counter
- ``pathway_serve_batch_occupancy_avg{scheduler}``   gauge (req / device call)
- ``pathway_serve_time_in_queue_seconds_total{scheduler}`` counter
- ``pathway_kv_*{pool}``, ``pathway_state_*{cache}``, ``pathway_fleet_*
  {fleet}``, ``pathway_kv_tier_*{store}`` and ``pathway_xla_*`` (see
  each class).

A gauge callback that raises propagates (the reference renders 0).
"""

from __future__ import annotations

import threading
from collections import Counter

_SHED_REASONS = ("queue_full", "deadline", "timeout", "rate_limit", "closed")


class ServeStats:
    """Thread-safe counter block for one scheduler / admission controller."""

    def __init__(self, name: str, depth_fn=None):
        self.name = name
        self._lock = threading.Lock()
        self._depth_fn = depth_fn
        self.admitted = 0
        self.completed = 0
        self.degraded = 0
        self.deadline_miss = 0
        self.shed: Counter = Counter()
        self.batches = 0
        self.batched_requests = 0
        self.time_in_queue_s = 0.0

    # -- recording ---------------------------------------------------------
    def record_admitted(self, n: int = 1) -> None:
        with self._lock:
            self.admitted += n

    def record_completed(self, n: int = 1) -> None:
        with self._lock:
            self.completed += n

    def record_degraded(self, n: int = 1) -> None:
        with self._lock:
            self.degraded += n

    def record_shed(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.shed[reason] += n
            if reason == "deadline":
                self.deadline_miss += n

    def record_batch(self, occupancy: int, time_in_queue_s: float = 0.0) -> None:
        """One device/tier call serving `occupancy` coalesced requests."""
        with self._lock:
            self.batches += 1
            self.batched_requests += occupancy
            self.time_in_queue_s += time_in_queue_s

    def record_queue_wait(self, seconds: float) -> None:
        """Queue time of requests that left the queue for execution: a
        forming batch's and those an in-flight batch admits alike."""
        with self._lock:
            self.time_in_queue_s += seconds

    # -- reading -----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        if self._depth_fn is None:
            return 0
        return int(self._depth_fn())

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    @property
    def batch_occupancy_avg(self) -> float:
        return self.batched_requests / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "queue_depth": self.queue_depth,
                "admitted": self.admitted,
                "completed": self.completed,
                "degraded": self.degraded,
                "shed": dict(self.shed),
                "deadline_miss": self.deadline_miss,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "batch_occupancy_avg": self.batch_occupancy_avg,
                "time_in_queue_s": self.time_in_queue_s,
            }


# TTFT histogram bucket upper bounds (seconds): spans a warm CPU decode
# (~ms) through a cold first-call admission (~s); +Inf is implicit
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0)

# chained-decode K histogram bucket upper bounds (steps per dispatch):
# covers K=1 (busy queue) through the deepest plausible chain; +Inf implicit
CHAIN_BUCKETS = (1, 2, 4, 8, 16, 32)


class KVCacheStats:
    """Thread-safe counter block for one paged KV-cache pool
    (kvcache/block_pool.py + prefix_cache.py + engine.py).

    Prometheus names (rendered by :func:`render_prometheus_lines`):

    - ``pathway_kv_blocks_in_use{pool}``        gauge
    - ``pathway_kv_blocks_total{pool}``         gauge
    - ``pathway_kv_prefix_hit_total{pool}``     counter (full shared blocks)
    - ``pathway_kv_prefix_miss_total{pool}``    counter
    - ``pathway_kv_preemptions_total{pool}``    counter
    - ``pathway_kv_cow_copies_total{pool}``     counter
    - ``pathway_kv_prefix_evictions_total{pool}`` counter
    - ``pathway_kv_prefill_chunks_total{pool}`` counter (prompt
      chunks streamed through the ragged fused step)
    - ``pathway_kv_mixed_steps_total{pool}``    counter (mixed dispatches)
    - ``pathway_kv_mixed_step_occupancy_avg{pool}`` gauge (live rows —
      decode + chunk — per mixed dispatch)
    - ``pathway_kv_ttft_seconds{pool}``         histogram (time from
      request arrival at the engine to its first emitted token)
    - ``pathway_kv_chain_steps{pool}``          histogram (K of
      each decode-advancing dispatch — 1 for per-step/mixed rounds
      (admission pressure), ``chain_steps`` for quiet-queue chains, so
      the le=1 bucket shows the adaptive-K policy working)
    - ``pathway_kv_chain_slots_total{pool}``    counter (dispatched chain
      slots, rows x K — occupancy denominator)
    - ``pathway_kv_chain_emitted_total{pool}``  counter (tokens actually
      emitted from chains; emitted/slots = chain occupancy)
    - ``pathway_kv_host_gap_seconds_total{pool}`` counter (host-critical-
      path seconds between a chain's results landing and the next chain
      being queued — the window the device may sit idle; ~0 when the
      double-buffered overlap is working)
    - ``pathway_kv_spec_proposed_total{pool}``  counter (draft
      tokens proposed into verify dispatches)
    - ``pathway_kv_spec_accepted_total{pool}``  counter (draft tokens the
      target's argmax confirmed — emitted as real output)
    - ``pathway_kv_spec_rejected_total{pool}``  counter (refuted drafts;
      their pre-extended slots were rolled back)
    - ``pathway_kv_spec_accept_rate{pool}``     gauge (accepted/proposed)
    - ``pathway_kv_spec_emitted_total{pool}``   counter (ALL tokens out
      of verify dispatches, accepts + the per-row bonus token;
      /spec_rounds = accepted tokens per dispatch, the headline)
    - ``pathway_kv_spec_rounds_total{pool}``    counter (verify
      dispatches)
    - ``pathway_kv_shard_hbm_bytes{pool,shard}``     gauge (K+V
      HBM held by each tensor-parallel shard)
    - ``pathway_kv_shard_blocks_in_use{pool,shard}`` gauge (block
      occupancy per shard — allocation is replicated bookkeeping, so the
      same block count occupies every shard's head-slice)
    """

    def __init__(self, name: str, blocks_in_use_fn=None, blocks_total: int = 0,
                 shards: int = 1, shard_hbm_bytes: int = 0):
        self.name = name
        self._lock = threading.Lock()
        self._blocks_in_use_fn = blocks_in_use_fn
        self.blocks_total = blocks_total
        self.shards = shards
        self.shard_hbm_bytes = shard_hbm_bytes
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.preemptions = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self.prefill_chunks = 0
        self.mixed_steps = 0
        self.mixed_step_rows = 0
        self.ttft_count = 0
        self.ttft_sum = 0.0
        self.ttft_bucket_counts = [0] * len(TTFT_BUCKETS)
        self.chain_count = 0
        self.chain_steps_sum = 0
        self.chain_bucket_counts = [0] * len(CHAIN_BUCKETS)
        self.chain_slots = 0
        self.chain_emitted = 0
        self.host_gap_s = 0.0
        # speculative decoding: proposed/accepted/rejected draft
        # tokens, total verify-emitted tokens and verify dispatches
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_emitted = 0
        self.spec_rounds = 0
        # failure domain: supervised engine restarts (pool
        # rebuild + recompute re-admission), their cost, and degraded
        # handoffs when the restart budget ran out
        self.engine_restarts = 0
        self.engine_restart_rebuild_s = 0.0
        self.engine_recovery_count = 0
        self.engine_recovery_s_sum = 0.0
        self.last_engine_recovery_s = 0.0
        self.engine_degraded = 0
        # bounded recent observations so callers can compute
        # percentiles without a second instrumentation channel
        from collections import deque as _deque

        self.recent_ttfts = _deque(maxlen=256)

    def record_prefix_hit(self, n: int = 1) -> None:
        with self._lock:
            self.prefix_hits += n

    def record_prefix_miss(self, n: int = 1) -> None:
        with self._lock:
            self.prefix_misses += n

    def record_preemption(self, n: int = 1) -> None:
        with self._lock:
            self.preemptions += n

    def record_cow(self, n: int = 1) -> None:
        with self._lock:
            self.cow_copies += n

    def record_prefix_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.prefix_evictions += n

    def record_prefill_chunks(self, n: int = 1) -> None:
        with self._lock:
            self.prefill_chunks += n

    def record_mixed_step(self, occupancy: int) -> None:
        """One ragged fused dispatch serving `occupancy` live rows."""
        with self._lock:
            self.mixed_steps += 1
            self.mixed_step_rows += occupancy

    def record_chain(self, steps: int, slots: int, emitted: int) -> None:
        """One chained multi-step dispatch of ``steps`` greedy steps over
        ``slots`` row-step slots, of which ``emitted`` produced tokens the
        engine kept (EOS/max_new truncation wastes the rest)."""
        with self._lock:
            self.chain_count += 1
            self.chain_steps_sum += steps
            for i, ub in enumerate(CHAIN_BUCKETS):
                if steps <= ub:
                    self.chain_bucket_counts[i] += 1
                    break
            self.chain_slots += slots
            self.chain_emitted += emitted

    def record_spec(self, proposed: int, accepted: int,
                    emitted: int) -> None:
        """One speculative verify dispatch: ``proposed`` draft
        tokens went in, ``accepted`` came back confirmed by the target's
        argmax, ``emitted`` tokens total left the dispatch (accepts plus
        each row's free bonus token).  rejected = proposed - accepted."""
        with self._lock:
            self.spec_rounds += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            self.spec_rejected += proposed - accepted
            self.spec_emitted += emitted

    def record_host_gap(self, seconds: float) -> None:
        """Host-critical-path time between a round's sync returning and
        the next round's dispatch, whatever the rounds' kind (chain,
        decode step, mixed, prefill, verify)."""
        with self._lock:
            self.host_gap_s += seconds

    def record_engine_restart(self, rebuild_seconds: float) -> None:
        """One supervised engine restart (pool rebuild time only; the
        failure -> first-recovered-token window lands separately via
        :meth:`record_engine_recovery`)."""
        with self._lock:
            self.engine_restarts += 1
            self.engine_restart_rebuild_s += rebuild_seconds

    def record_engine_recovery(self, seconds: float) -> None:
        """Failure -> first recovered token (the engine_restart_s MTTR
        an engine's MTTR)."""
        with self._lock:
            self.engine_recovery_count += 1
            self.engine_recovery_s_sum += seconds
            self.last_engine_recovery_s = seconds

    def record_engine_degrade(self, n: int = 1) -> None:
        with self._lock:
            self.engine_degraded += n

    def record_ttft(self, seconds: float) -> None:
        with self._lock:
            self.ttft_count += 1
            self.ttft_sum += seconds
            for i, ub in enumerate(TTFT_BUCKETS):
                if seconds <= ub:
                    self.ttft_bucket_counts[i] += 1
                    break
            self.recent_ttfts.append(seconds)

    @property
    def blocks_in_use(self) -> int:
        if self._blocks_in_use_fn is None:
            return 0
        return int(self._blocks_in_use_fn())

    @property
    def mixed_step_occupancy_avg(self) -> float:
        return self.mixed_step_rows / self.mixed_steps \
            if self.mixed_steps else 0.0

    @property
    def chain_occupancy(self) -> float:
        """Fraction of dispatched chain slots that produced an emitted
        token (EOS/max_new truncation and short-budget rows waste the
        rest — bounded by K per row per chain)."""
        return self.chain_emitted / self.chain_slots \
            if self.chain_slots else 0.0

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of proposed draft tokens the target's argmax
        confirmed — the drafter's quality signal, and what
        the SpecController's cooloff gate watches per round."""
        return self.spec_accepted / self.spec_proposed \
            if self.spec_proposed else 0.0

    @property
    def spec_emitted_per_round(self) -> float:
        """Tokens emitted per verify dispatch — the speculative
        multi-token multiplier (1.0 would mean plain decode)."""
        return self.spec_emitted / self.spec_rounds \
            if self.spec_rounds else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "blocks_in_use": self.blocks_in_use,
                "blocks_total": self.blocks_total,
                "shards": self.shards,
                "shard_hbm_bytes": self.shard_hbm_bytes,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "preemptions": self.preemptions,
                "cow_copies": self.cow_copies,
                "prefix_evictions": self.prefix_evictions,
                "prefill_chunks": self.prefill_chunks,
                "mixed_steps": self.mixed_steps,
                "mixed_step_rows": self.mixed_step_rows,
                "mixed_step_occupancy_avg": self.mixed_step_occupancy_avg,
                "ttft_count": self.ttft_count,
                "ttft_sum": self.ttft_sum,
                "ttft_buckets": list(self.ttft_bucket_counts),
                "recent_ttfts": list(self.recent_ttfts),
                "chain_count": self.chain_count,
                "chain_steps_sum": self.chain_steps_sum,
                "chain_buckets": list(self.chain_bucket_counts),
                "chain_slots": self.chain_slots,
                "chain_emitted": self.chain_emitted,
                "chain_occupancy": self.chain_occupancy,
                "host_gap_s": self.host_gap_s,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_rejected": self.spec_rejected,
                "spec_emitted": self.spec_emitted,
                "spec_rounds": self.spec_rounds,
                "spec_accept_rate": self.spec_accept_rate,
                "spec_emitted_per_round": self.spec_emitted_per_round,
                "engine_restarts": self.engine_restarts,
                "engine_restart_rebuild_s": self.engine_restart_rebuild_s,
                "engine_recovery_count": self.engine_recovery_count,
                "engine_recovery_s_sum": self.engine_recovery_s_sum,
                "last_engine_recovery_s": self.last_engine_recovery_s,
                "engine_degraded": self.engine_degraded,
            }


class FleetStats:
    """Thread-safe counter block for one replica fleet (serve/fleet.py).

    Prometheus names (rendered by :func:`render_prometheus_lines`):

    - ``pathway_fleet_replicas{fleet}``               gauge (configured R)
    - ``pathway_fleet_live_replicas{fleet}``          gauge
    - ``pathway_fleet_replica_deaths_total{fleet}``   counter
    - ``pathway_fleet_recoveries_total{fleet}``       counter (requests
      that re-admitted on a peer and emitted a recovered token)
    - ``pathway_fleet_recovery_seconds_total{fleet}`` counter (failure ->
      first-recovered-token-on-a-peer, summed; /recoveries_total = mean)
    - ``pathway_fleet_last_recovery_seconds{fleet}``  gauge
    - ``pathway_fleet_affinity_hit_total{fleet}``     counter (routes that
      landed on a replica already holding the prompt's prefix blocks)
    - ``pathway_fleet_affinity_miss_total{fleet}``    counter
    - ``pathway_fleet_replica_dead{fleet,replica}``          gauge (0/1)
    - ``pathway_fleet_replica_inflight{fleet,replica}``      gauge
    - ``pathway_fleet_replica_queue_depth{fleet,replica}``   gauge
    - ``pathway_fleet_replica_handoffs_total{fleet,replica}``  counter
      (requests this replica handed OFF when it died)
    - ``pathway_fleet_replica_recovered_total{fleet,replica}`` counter
      (requests this replica recovered FOR a dead peer)
    """

    def __init__(self, name: str, replicas: int = 0, live_fn=None,
                 snapshot_fn=None):
        self.name = name
        self._lock = threading.Lock()
        self.replicas = replicas
        self._live_fn = live_fn
        # fleet.stats() — pulled at render time for per-replica gauges;
        # called OUTSIDE self._lock (it takes the fleet lock, and the
        # fleet's hot path takes fleet lock then this lock)
        self._snapshot_fn = snapshot_fn
        self.replica_deaths = 0
        self.recovery_count = 0
        self.recovery_s_sum = 0.0
        self.last_recovery_s = 0.0
        self.affinity_hits = 0
        self.affinity_misses = 0

    def record_replica_death(self, n: int = 1) -> None:
        with self._lock:
            self.replica_deaths += n

    def record_recovery(self, seconds: float) -> None:
        """One stranded request's failure -> first recovered token on a
        surviving peer."""
        with self._lock:
            self.recovery_count += 1
            self.recovery_s_sum += seconds
            self.last_recovery_s = seconds

    def record_route(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.affinity_hits += 1
            else:
                self.affinity_misses += 1

    @property
    def live(self) -> int:
        if self._live_fn is None:
            return 0
        return int(self._live_fn())

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "name": self.name,
                "replicas": self.replicas,
                "replica_deaths": self.replica_deaths,
                "recovery_count": self.recovery_count,
                "recovery_s_sum": self.recovery_s_sum,
                "last_recovery_s": self.last_recovery_s,
                "affinity_hits": self.affinity_hits,
                "affinity_misses": self.affinity_misses,
            }
        snap["live"] = self.live
        snap["per_replica"] = (self._snapshot_fn().get("per_replica", [])
                               if self._snapshot_fn is not None else [])
        return snap


class StateCacheStats:
    """constant-memory cache counters (``pathway_state_*``):
    slot occupancy plus suspend/resume traffic for one
    kvcache/statecache.py StateCache.  Engine-generic counters (TTFT,
    chains, restarts, host gap) stay on the shared
    :class:`KVCacheStats` block — this family carries only what is
    specific to the fixed-size-state backend."""

    def __init__(self, name: str, slots_in_use_fn=None,
                 slots_total: int = 0, state_bytes_per_seq: int = 0):
        self.name = name
        self._slots_in_use_fn = slots_in_use_fn
        self.slots_total = slots_total
        self.state_bytes_per_seq = state_bytes_per_seq
        self.suspends = 0
        self.resumes = 0
        self._lock = threading.Lock()

    @property
    def slots_in_use(self) -> int:
        if self._slots_in_use_fn is None:
            return 0
        return int(self._slots_in_use_fn())

    def record_suspend(self, n: int = 1) -> None:
        with self._lock:
            self.suspends += n

    def record_resume(self, n: int = 1) -> None:
        with self._lock:
            self.resumes += n

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "name": self.name,
                "slots_total": self.slots_total,
                "state_bytes_per_seq": self.state_bytes_per_seq,
                "suspends": self.suspends,
                "resumes": self.resumes,
            }
        snap["slots_in_use"] = self.slots_in_use
        return snap


_registry: dict[str, ServeStats] = {}
_kv_registry: dict[str, KVCacheStats] = {}
_state_registry: dict[str, StateCacheStats] = {}
_fleet_registry: dict[str, FleetStats] = {}
# SessionStore host tiers (kvcache/tiering.py) keyed by store name; the
# store registers itself so pathway_kv_tier_* lines exist with or
# without a fleet in front
_tier_registry: dict[str, object] = {}
_registry_lock = threading.Lock()


def serve_stats(name: str, depth_fn=None) -> ServeStats:
    """Get-or-create the stats block for `name` (stable across restarts of
    the owning scheduler, so counters stay monotonic within a process)."""
    with _registry_lock:
        stats = _registry.get(name)
        if stats is None:
            stats = _registry[name] = ServeStats(name, depth_fn)
        elif depth_fn is not None:
            stats._depth_fn = depth_fn
        return stats


def kv_stats(name: str, blocks_in_use_fn=None, blocks_total: int | None = None,
             shards: int | None = None, shard_hbm_bytes: int | None = None
             ) -> KVCacheStats:
    """Get-or-create the KV-cache stats block for `name` (same contract as
    :func:`serve_stats`: counters stay monotonic across pool restarts)."""
    with _registry_lock:
        stats = _kv_registry.get(name)
        if stats is None:
            stats = _kv_registry[name] = KVCacheStats(
                name, blocks_in_use_fn, blocks_total or 0,
                shards or 1, shard_hbm_bytes or 0,
            )
        else:
            if blocks_in_use_fn is not None:
                stats._blocks_in_use_fn = blocks_in_use_fn
            if blocks_total is not None:
                stats.blocks_total = blocks_total
            if shards is not None:
                stats.shards = shards
            if shard_hbm_bytes is not None:
                stats.shard_hbm_bytes = shard_hbm_bytes
        return stats


def state_stats(name: str, slots_in_use_fn=None,
                slots_total: int | None = None,
                state_bytes_per_seq: int | None = None) -> StateCacheStats:
    """Get-or-create the state-cache stats block for `name` (same
    contract as :func:`kv_stats`: counters stay monotonic across cache
    rebuilds — a restarted engine's fresh StateCache re-attaches)."""
    with _registry_lock:
        stats = _state_registry.get(name)
        if stats is None:
            stats = _state_registry[name] = StateCacheStats(
                name, slots_in_use_fn, slots_total or 0,
                state_bytes_per_seq or 0,
            )
        else:
            if slots_in_use_fn is not None:
                stats._slots_in_use_fn = slots_in_use_fn
            if slots_total is not None:
                stats.slots_total = slots_total
            if state_bytes_per_seq is not None:
                stats.state_bytes_per_seq = state_bytes_per_seq
        return stats


def fleet_stats(name: str, replicas: int | None = None, live_fn=None,
                store=None, snapshot_fn=None) -> FleetStats:
    """Get-or-create the stats block for replica fleet `name` (same
    contract as :func:`serve_stats`: counters stay monotonic across
    fleet rebuilds).  A ``store`` (the fleet's shared SessionStore) is
    forwarded to :func:`register_session_store` so its
    ``pathway_kv_tier_*`` lines render too."""
    with _registry_lock:
        stats = _fleet_registry.get(name)
        if stats is None:
            stats = _fleet_registry[name] = FleetStats(
                name, replicas or 0, live_fn, snapshot_fn,
            )
        else:
            if replicas is not None:
                stats.replicas = replicas
            if live_fn is not None:
                stats._live_fn = live_fn
            if snapshot_fn is not None:
                stats._snapshot_fn = snapshot_fn
    if store is not None:
        register_session_store(store)
    return stats


def register_session_store(store) -> None:
    """Surface a kvcache/tiering.py SessionStore on /metrics + OTLP
    (idempotent by store name; the store calls this from its ctor)."""
    with _registry_lock:
        _tier_registry[store.name] = store


def all_stats() -> list[ServeStats]:
    with _registry_lock:
        return list(_registry.values())


def all_kv_stats() -> list[KVCacheStats]:
    with _registry_lock:
        return list(_kv_registry.values())


def all_state_stats() -> list[StateCacheStats]:
    with _registry_lock:
        return list(_state_registry.values())


def all_fleet_stats() -> list[FleetStats]:
    with _registry_lock:
        return list(_fleet_registry.values())


def all_session_stores() -> list:
    with _registry_lock:
        return list(_tier_registry.values())


def reset_registry() -> None:
    """Test hook: drop all registered stats blocks."""
    with _registry_lock:
        _registry.clear()
        _kv_registry.clear()
        _state_registry.clear()
        _fleet_registry.clear()
        _tier_registry.clear()


def _render_xla_lines() -> list[str]:
    """The device-program lines (``pathway_xla_*``) of the cost
    observatory — recorded values only, a scrape never probes."""
    from ..obs import profiler

    return profiler.render_prometheus_lines()


def render_prometheus_lines() -> list[str]:
    """Prometheus text-format lines, appended to MetricsServer.render()."""
    stats = all_stats()
    if not stats:
        return (_render_kv_lines() + _render_state_lines()
                + _render_fleet_lines() + _render_tier_lines()
                + _render_xla_lines())
    lines = [
        "# TYPE pathway_serve_queue_depth gauge",
        "# TYPE pathway_serve_admitted_total counter",
        "# TYPE pathway_serve_completed_total counter",
        "# TYPE pathway_serve_shed_total counter",
        "# TYPE pathway_serve_degraded_total counter",
        "# TYPE pathway_serve_deadline_miss_total counter",
        "# TYPE pathway_serve_batches_total counter",
        "# TYPE pathway_serve_batched_requests_total counter",
        "# TYPE pathway_serve_batch_occupancy_avg gauge",
        "# TYPE pathway_serve_time_in_queue_seconds_total counter",
    ]
    for s in stats:
        snap = s.snapshot()
        lbl = f'scheduler="{s.name}"'
        lines.append(f"pathway_serve_queue_depth{{{lbl}}} {snap['queue_depth']}")
        lines.append(f"pathway_serve_admitted_total{{{lbl}}} {snap['admitted']}")
        lines.append(f"pathway_serve_completed_total{{{lbl}}} {snap['completed']}")
        for reason in _SHED_REASONS:
            lines.append(
                f"pathway_serve_shed_total{{{lbl},reason=\"{reason}\"}} "
                f"{snap['shed'].get(reason, 0)}"
            )
        lines.append(f"pathway_serve_degraded_total{{{lbl}}} {snap['degraded']}")
        lines.append(
            f"pathway_serve_deadline_miss_total{{{lbl}}} {snap['deadline_miss']}"
        )
        lines.append(f"pathway_serve_batches_total{{{lbl}}} {snap['batches']}")
        lines.append(
            f"pathway_serve_batched_requests_total{{{lbl}}} "
            f"{snap['batched_requests']}"
        )
        lines.append(
            f"pathway_serve_batch_occupancy_avg{{{lbl}}} "
            f"{snap['batch_occupancy_avg']:.3f}"
        )
        lines.append(
            f"pathway_serve_time_in_queue_seconds_total{{{lbl}}} "
            f"{snap['time_in_queue_s']:.6f}"
        )
    lines.extend(_render_kv_lines())
    lines.extend(_render_state_lines())
    lines.extend(_render_fleet_lines())
    lines.extend(_render_tier_lines())
    lines.extend(_render_xla_lines())
    return lines


def _render_state_lines() -> list[str]:
    """constant-memory cache lines (``pathway_state_*``)."""
    stats = all_state_stats()
    if not stats:
        return []
    lines = [
        "# TYPE pathway_state_slots_in_use gauge",
        "# TYPE pathway_state_slots_total gauge",
        "# TYPE pathway_state_bytes_per_seq gauge",
        "# TYPE pathway_state_suspends_total counter",
        "# TYPE pathway_state_resumes_total counter",
    ]
    for s in stats:
        snap = s.snapshot()
        lbl = f'cache="{s.name}"'
        lines.append(
            f"pathway_state_slots_in_use{{{lbl}}} {snap['slots_in_use']}"
        )
        lines.append(
            f"pathway_state_slots_total{{{lbl}}} {snap['slots_total']}"
        )
        lines.append(
            f"pathway_state_bytes_per_seq{{{lbl}}} "
            f"{snap['state_bytes_per_seq']}"
        )
        lines.append(
            f"pathway_state_suspends_total{{{lbl}}} {snap['suspends']}"
        )
        lines.append(
            f"pathway_state_resumes_total{{{lbl}}} {snap['resumes']}"
        )
    return lines


def _render_fleet_lines() -> list[str]:
    """replica-fleet lines (``pathway_fleet_*``)."""
    stats = all_fleet_stats()
    if not stats:
        return []
    lines = [
        "# TYPE pathway_fleet_replicas gauge",
        "# TYPE pathway_fleet_live_replicas gauge",
        "# TYPE pathway_fleet_replica_deaths_total counter",
        "# TYPE pathway_fleet_recoveries_total counter",
        "# TYPE pathway_fleet_recovery_seconds_total counter",
        "# TYPE pathway_fleet_last_recovery_seconds gauge",
        "# TYPE pathway_fleet_affinity_hit_total counter",
        "# TYPE pathway_fleet_affinity_miss_total counter",
        "# TYPE pathway_fleet_replica_dead gauge",
        "# TYPE pathway_fleet_replica_inflight gauge",
        "# TYPE pathway_fleet_replica_queue_depth gauge",
        "# TYPE pathway_fleet_replica_handoffs_total counter",
        "# TYPE pathway_fleet_replica_recovered_total counter",
    ]
    for s in stats:
        snap = s.snapshot()
        lbl = f'fleet="{s.name}"'
        lines.append(f"pathway_fleet_replicas{{{lbl}}} {snap['replicas']}")
        lines.append(f"pathway_fleet_live_replicas{{{lbl}}} {snap['live']}")
        lines.append(
            f"pathway_fleet_replica_deaths_total{{{lbl}}} "
            f"{snap['replica_deaths']}"
        )
        lines.append(
            f"pathway_fleet_recoveries_total{{{lbl}}} "
            f"{snap['recovery_count']}"
        )
        lines.append(
            f"pathway_fleet_recovery_seconds_total{{{lbl}}} "
            f"{snap['recovery_s_sum']:.6f}"
        )
        lines.append(
            f"pathway_fleet_last_recovery_seconds{{{lbl}}} "
            f"{snap['last_recovery_s']:.6f}"
        )
        lines.append(
            f"pathway_fleet_affinity_hit_total{{{lbl}}} "
            f"{snap['affinity_hits']}"
        )
        lines.append(
            f"pathway_fleet_affinity_miss_total{{{lbl}}} "
            f"{snap['affinity_misses']}"
        )
        for rep in snap["per_replica"]:
            rlbl = f'{lbl},replica="{rep["replica"]}"'
            lines.append(
                f"pathway_fleet_replica_dead{{{rlbl}}} "
                f"{1 if rep['dead'] else 0}"
            )
            lines.append(
                f"pathway_fleet_replica_inflight{{{rlbl}}} {rep['inflight']}"
            )
            lines.append(
                f"pathway_fleet_replica_queue_depth{{{rlbl}}} "
                f"{rep['queue_depth']}"
            )
            lines.append(
                f"pathway_fleet_replica_handoffs_total{{{rlbl}}} "
                f"{rep['handoffs_out']}"
            )
            lines.append(
                f"pathway_fleet_replica_recovered_total{{{rlbl}}} "
                f"{rep['recovered_in']}"
            )
    return lines


def _render_tier_lines() -> list[str]:
    """host session-tier lines (``pathway_kv_tier_*``)."""
    stores = all_session_stores()
    if not stores:
        return []
    lines = [
        "# TYPE pathway_kv_tier_suspended_sessions gauge",
        "# TYPE pathway_kv_tier_host_bytes gauge",
        "# TYPE pathway_kv_tier_host_budget_bytes gauge",
        "# TYPE pathway_kv_tier_suspends_total counter",
        "# TYPE pathway_kv_tier_resumes_total counter",
        "# TYPE pathway_kv_tier_misses_total counter",
        "# TYPE pathway_kv_tier_evictions_total counter",
        "# TYPE pathway_kv_tier_resumed_tokens_total counter",
        "# TYPE pathway_kv_tier_resume_ms_p99 gauge",
    ]
    for store in stores:
        snap = store.stats()
        lbl = f'store="{store.name}"'
        lines.append(
            f"pathway_kv_tier_suspended_sessions{{{lbl}}} "
            f"{snap['suspended_sessions']}"
        )
        lines.append(
            f"pathway_kv_tier_host_bytes{{{lbl}}} {snap['host_bytes']}"
        )
        lines.append(
            f"pathway_kv_tier_host_budget_bytes{{{lbl}}} "
            f"{snap['host_budget_bytes'] or 0}"
        )
        lines.append(
            f"pathway_kv_tier_suspends_total{{{lbl}}} {snap['suspends']}"
        )
        lines.append(
            f"pathway_kv_tier_resumes_total{{{lbl}}} {snap['resumes']}"
        )
        lines.append(
            f"pathway_kv_tier_misses_total{{{lbl}}} {snap['misses']}"
        )
        lines.append(
            f"pathway_kv_tier_evictions_total{{{lbl}}} {snap['evictions']}"
        )
        lines.append(
            f"pathway_kv_tier_resumed_tokens_total{{{lbl}}} "
            f"{snap['resumed_tokens']}"
        )
        lines.append(
            f"pathway_kv_tier_resume_ms_p99{{{lbl}}} "
            f"{snap['resume_ms_p99']:.3f}"
        )
    return lines


def _render_kv_lines() -> list[str]:
    """Paged KV-cache pool occupancy / prefix-sharing / preemption lines."""
    stats = all_kv_stats()
    if not stats:
        return []
    lines = [
        "# TYPE pathway_kv_blocks_in_use gauge",
        "# TYPE pathway_kv_blocks_total gauge",
        "# TYPE pathway_kv_prefix_hit_total counter",
        "# TYPE pathway_kv_prefix_miss_total counter",
        "# TYPE pathway_kv_preemptions_total counter",
        "# TYPE pathway_kv_cow_copies_total counter",
        "# TYPE pathway_kv_prefix_evictions_total counter",
        "# TYPE pathway_kv_prefill_chunks_total counter",
        "# TYPE pathway_kv_mixed_steps_total counter",
        "# TYPE pathway_kv_mixed_step_occupancy_avg gauge",
        "# TYPE pathway_kv_shard_hbm_bytes gauge",
        "# TYPE pathway_kv_shard_blocks_in_use gauge",
        "# TYPE pathway_kv_ttft_seconds histogram",
        "# TYPE pathway_kv_chain_steps histogram",
        "# TYPE pathway_kv_chain_slots_total counter",
        "# TYPE pathway_kv_chain_emitted_total counter",
        "# TYPE pathway_kv_chain_occupancy gauge",
        "# TYPE pathway_kv_host_gap_seconds_total counter",
        "# TYPE pathway_kv_spec_proposed_total counter",
        "# TYPE pathway_kv_spec_accepted_total counter",
        "# TYPE pathway_kv_spec_rejected_total counter",
        "# TYPE pathway_kv_spec_emitted_total counter",
        "# TYPE pathway_kv_spec_rounds_total counter",
        "# TYPE pathway_kv_spec_accept_rate gauge",
        "# TYPE pathway_kv_engine_restarts_total counter",
        "# TYPE pathway_kv_engine_restart_seconds_total counter",
        "# TYPE pathway_kv_engine_recovery_seconds_total counter",
        "# TYPE pathway_kv_engine_degraded_total counter",
    ]
    for s in stats:
        snap = s.snapshot()
        lbl = f'pool="{s.name}"'
        lines.append(f"pathway_kv_blocks_in_use{{{lbl}}} {snap['blocks_in_use']}")
        lines.append(f"pathway_kv_blocks_total{{{lbl}}} {snap['blocks_total']}")
        lines.append(f"pathway_kv_prefix_hit_total{{{lbl}}} {snap['prefix_hits']}")
        lines.append(
            f"pathway_kv_prefix_miss_total{{{lbl}}} {snap['prefix_misses']}"
        )
        lines.append(
            f"pathway_kv_preemptions_total{{{lbl}}} {snap['preemptions']}"
        )
        lines.append(
            f"pathway_kv_cow_copies_total{{{lbl}}} {snap['cow_copies']}"
        )
        lines.append(
            f"pathway_kv_prefix_evictions_total{{{lbl}}} "
            f"{snap['prefix_evictions']}"
        )
        lines.append(
            f"pathway_kv_prefill_chunks_total{{{lbl}}} "
            f"{snap['prefill_chunks']}"
        )
        lines.append(
            f"pathway_kv_mixed_steps_total{{{lbl}}} {snap['mixed_steps']}"
        )
        lines.append(
            f"pathway_kv_mixed_step_occupancy_avg{{{lbl}}} "
            f"{snap['mixed_step_occupancy_avg']:.3f}"
        )
        # per-shard pool HBM + occupancy (tp=1 pools export one shard 0
        # line, so dashboards need no special single-device case)
        for shard in range(max(snap.get("shards", 1), 1)):
            slbl = f'{lbl},shard="{shard}"'
            lines.append(
                f"pathway_kv_shard_hbm_bytes{{{slbl}}} "
                f"{snap.get('shard_hbm_bytes', 0)}"
            )
            lines.append(
                f"pathway_kv_shard_blocks_in_use{{{slbl}}} "
                f"{snap['blocks_in_use']}"
            )
        # Prometheus histogram convention: cumulative le buckets + +Inf,
        # then _sum and _count
        cum = 0
        for ub, n in zip(TTFT_BUCKETS, snap["ttft_buckets"]):
            cum += n
            lines.append(
                f'pathway_kv_ttft_seconds_bucket{{{lbl},le="{ub}"}} {cum}'
            )
        lines.append(
            f'pathway_kv_ttft_seconds_bucket{{{lbl},le="+Inf"}} '
            f"{snap['ttft_count']}"
        )
        lines.append(
            f"pathway_kv_ttft_seconds_sum{{{lbl}}} {snap['ttft_sum']:.6f}"
        )
        lines.append(
            f"pathway_kv_ttft_seconds_count{{{lbl}}} {snap['ttft_count']}"
        )
        # chained-decode K histogram + occupancy + host gap
        cum = 0
        for ub, n in zip(CHAIN_BUCKETS, snap["chain_buckets"]):
            cum += n
            lines.append(
                f'pathway_kv_chain_steps_bucket{{{lbl},le="{ub}"}} {cum}'
            )
        lines.append(
            f'pathway_kv_chain_steps_bucket{{{lbl},le="+Inf"}} '
            f"{snap['chain_count']}"
        )
        lines.append(
            f"pathway_kv_chain_steps_sum{{{lbl}}} {snap['chain_steps_sum']}"
        )
        lines.append(
            f"pathway_kv_chain_steps_count{{{lbl}}} {snap['chain_count']}"
        )
        lines.append(
            f"pathway_kv_chain_slots_total{{{lbl}}} {snap['chain_slots']}"
        )
        lines.append(
            f"pathway_kv_chain_emitted_total{{{lbl}}} "
            f"{snap['chain_emitted']}"
        )
        lines.append(
            f"pathway_kv_chain_occupancy{{{lbl}}} "
            f"{snap['chain_occupancy']:.3f}"
        )
        lines.append(
            f"pathway_kv_host_gap_seconds_total{{{lbl}}} "
            f"{snap['host_gap_s']:.6f}"
        )
        # speculative decoding: draft proposal/acceptance flow
        lines.append(
            f"pathway_kv_spec_proposed_total{{{lbl}}} "
            f"{snap['spec_proposed']}"
        )
        lines.append(
            f"pathway_kv_spec_accepted_total{{{lbl}}} "
            f"{snap['spec_accepted']}"
        )
        lines.append(
            f"pathway_kv_spec_rejected_total{{{lbl}}} "
            f"{snap['spec_rejected']}"
        )
        lines.append(
            f"pathway_kv_spec_emitted_total{{{lbl}}} {snap['spec_emitted']}"
        )
        lines.append(
            f"pathway_kv_spec_rounds_total{{{lbl}}} {snap['spec_rounds']}"
        )
        lines.append(
            f"pathway_kv_spec_accept_rate{{{lbl}}} "
            f"{snap['spec_accept_rate']:.3f}"
        )
        lines.append(
            f"pathway_kv_engine_restarts_total{{{lbl}}} "
            f"{snap['engine_restarts']}"
        )
        # restart_seconds = pool REBUILD cost; recovery_seconds = the
        # failure -> first-recovered-token MTTR (includes the recompute
        # prefill of every survivor) — distinct on purpose, dashboards
        # dividing by restarts_total get the mean of what the name says
        lines.append(
            f"pathway_kv_engine_restart_seconds_total{{{lbl}}} "
            f"{snap['engine_restart_rebuild_s']:.6f}"
        )
        lines.append(
            f"pathway_kv_engine_recovery_seconds_total{{{lbl}}} "
            f"{snap['engine_recovery_s_sum']:.6f}"
        )
        lines.append(
            f"pathway_kv_engine_degraded_total{{{lbl}}} "
            f"{snap['engine_degraded']}"
        )
    return lines


def otlp_points(now_ns: str) -> list[dict]:
    """Serve counters as OTLP sum data points (merged into the engine's
    otlp_export_metrics push)."""
    points = []
    for s in all_stats():
        snap = s.snapshot()
        for key in ("admitted", "completed", "degraded", "batches",
                    "batched_requests", "deadline_miss"):
            points.append({
                "asInt": str(snap[key]),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "scheduler", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": key}},
                ],
            })
        for reason, val in snap["shed"].items():
            points.append({
                "asInt": str(val),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "scheduler", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": "shed"}},
                    {"key": "reason", "value": {"stringValue": reason}},
                ],
            })
    for s in all_kv_stats():
        snap = s.snapshot()
        for key in ("prefix_hits", "prefix_misses", "preemptions",
                    "cow_copies", "prefix_evictions", "blocks_in_use",
                    "prefill_chunks", "mixed_steps", "mixed_step_rows",
                    "ttft_count", "chain_count", "chain_slots",
                    "chain_emitted", "spec_proposed", "spec_accepted",
                    "spec_rejected", "spec_emitted", "spec_rounds",
                    "engine_restarts", "engine_degraded"):
            points.append({
                "asInt": str(snap[key]),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "pool", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": key}},
                ],
            })
        for dkey in ("ttft_sum", "host_gap_s", "spec_accept_rate",
                     "engine_recovery_s_sum", "engine_restart_rebuild_s"):
            points.append({
                "asDouble": snap[dkey],
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "pool", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": dkey}},
                ],
            })
        for shard in range(max(snap.get("shards", 1), 1)):
            shard_attr = {"key": "shard", "value": {"stringValue": str(shard)}}
            for key, val in (
                ("shard_hbm_bytes", snap.get("shard_hbm_bytes", 0)),
                ("shard_blocks_in_use", snap["blocks_in_use"]),
            ):
                points.append({
                    "asInt": str(val),
                    "timeUnixNano": now_ns,
                    "attributes": [
                        {"key": "pool", "value": {"stringValue": s.name}},
                        {"key": "counter", "value": {"stringValue": key}},
                        shard_attr,
                    ],
                })
    for s in all_state_stats():
        snap = s.snapshot()
        for key in ("slots_in_use", "slots_total", "state_bytes_per_seq",
                    "suspends", "resumes"):
            points.append({
                "asInt": str(snap[key]),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "cache", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": key}},
                ],
            })
    for s in all_fleet_stats():
        snap = s.snapshot()
        for key in ("replicas", "live", "replica_deaths", "recovery_count",
                    "affinity_hits", "affinity_misses"):
            points.append({
                "asInt": str(snap[key]),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "fleet", "value": {"stringValue": s.name}},
                    {"key": "counter", "value": {"stringValue": key}},
                ],
            })
        points.append({
            "asDouble": snap["recovery_s_sum"],
            "timeUnixNano": now_ns,
            "attributes": [
                {"key": "fleet", "value": {"stringValue": s.name}},
                {"key": "counter",
                 "value": {"stringValue": "recovery_s_sum"}},
            ],
        })
    for store in all_session_stores():
        snap = store.stats()
        for key in ("suspended_sessions", "host_bytes", "suspends",
                    "resumes", "misses", "evictions", "resumed_tokens"):
            points.append({
                "asInt": str(snap[key]),
                "timeUnixNano": now_ns,
                "attributes": [
                    {"key": "store", "value": {"stringValue": store.name}},
                    {"key": "counter", "value": {"stringValue": key}},
                ],
            })
        points.append({
            "asDouble": snap["resume_ms_p99"],
            "timeUnixNano": now_ns,
            "attributes": [
                {"key": "store", "value": {"stringValue": store.name}},
                {"key": "counter",
                 "value": {"stringValue": "resume_ms_p99"}},
            ],
        })
    return points
