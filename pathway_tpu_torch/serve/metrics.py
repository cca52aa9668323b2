"""Backpressure counters of the serving path.

The port's copy of the counter half of ``pathway_tpu/serve/metrics.py``:
one :class:`ServeStats` per scheduler or admission controller, one
:class:`FleetStats` per replica fleet, and process-wide registries of
them and of the session stores (``kvcache/tiering.py``), each with a
``snapshot()``.  The Prometheus and OTLP rendering of these counters is
not ported.
"""

from __future__ import annotations

import threading
from collections import Counter


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

    # -- reading -----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        if self._depth_fn is None:
            return 0
        return int(self._depth_fn())

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


class FleetStats:
    """Thread-safe counter block for one replica fleet (serve/fleet.py):
    replica deaths, failover recoveries (failure -> first recovered
    token on a peer) and affinity routing hits and misses."""

    def __init__(self, name: str, replicas: int = 0, live_fn=None,
                 snapshot_fn=None):
        self.name = name
        self._lock = threading.Lock()
        self.replicas = replicas
        self._live_fn = live_fn
        # fleet.stats(): called OUTSIDE self._lock (it takes the fleet
        # lock, and the fleet's hot path takes fleet lock then this lock)
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


_registry: dict[str, ServeStats] = {}
_fleet_registry: dict[str, FleetStats] = {}
# SessionStore host tiers (kvcache/tiering.py) keyed by store name; the
# store registers itself from its constructor
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


def fleet_stats(name: str, replicas: int | None = None, live_fn=None,
                store=None, snapshot_fn=None) -> FleetStats:
    """Get-or-create the stats block for replica fleet `name` (same
    contract as :func:`serve_stats`).  A ``store`` (the fleet's shared
    SessionStore) is registered through :func:`register_session_store`."""
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
    """Record a kvcache/tiering.py SessionStore by name (idempotent; the
    store calls this from its constructor)."""
    with _registry_lock:
        _tier_registry[store.name] = store


def all_stats() -> list[ServeStats]:
    with _registry_lock:
        return list(_registry.values())


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
        _fleet_registry.clear()
        _tier_registry.clear()


__all__ = [
    "FleetStats", "ServeStats", "all_fleet_stats", "all_session_stores",
    "all_stats", "fleet_stats", "register_session_store", "reset_registry",
    "serve_stats",
]
