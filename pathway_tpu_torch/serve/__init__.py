"""pathway_tpu_torch.serve — the serving front: a continuous-batching
request scheduler, admission control with its counters, and the replica
fleet over the paged decode engine (the port of ``pathway_tpu.serve``).

- :class:`RequestScheduler` — priority classes, per-request deadlines,
  continuous batch formation: concurrent calls coalesce into padded,
  bucketed batches so one device call serves many callers.
- :class:`AdmissionController` — bounded queues with a block / shed
  (429 + Retry-After) / degrade overflow policy and a token-bucket rate
  limiter per priority class.
- :class:`ReplicaFleet` — R engines behind prefix-affine routing, with
  failover between replicas and a shared session tier.
- :mod:`pathway_tpu_torch.serve.metrics` — queue depth, batch occupancy,
  time-in-queue, shed and fleet counters, rendered as Prometheus lines
  (``render_prometheus_lines``) and OTLP points (``otlp_points``).
"""

from __future__ import annotations

from .admission import (
    AdmissionController,
    AdmissionPolicy,
    DeadlineExceededError,
    EngineFailedError,
    Priority,
    QueueFullError,
    RateLimitedError,
    SchedulerClosedError,
    ShedError,
    TokenBucket,
)
from .fleet import ReplicaFleet
from .metrics import (FleetStats, ServeStats, fleet_stats,
                      render_prometheus_lines, serve_stats)
from .scheduler import RequestScheduler, shared_scheduler

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "DeadlineExceededError",
    "EngineFailedError",
    "FleetStats",
    "Priority",
    "QueueFullError",
    "RateLimitedError",
    "ReplicaFleet",
    "RequestScheduler",
    "SchedulerClosedError",
    "ServeStats",
    "ShedError",
    "TokenBucket",
    "fleet_stats",
    "render_prometheus_lines",
    "serve_stats",
    "shared_scheduler",
]
