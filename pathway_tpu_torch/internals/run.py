"""pw.run() — execute every registered output sink.

The port of ``pathway_tpu/internals/run.py`` (reference:
python/pathway/internals/run.py:13): batch graphs execute to completion;
graphs with live sources run the streaming poll loop until
``timeout_s``, ``idle_stop_s`` or their sources finish.  Sources in an
input synchronization group are gated before lowering
(``io/_synchronization.py``).  The data plane runs on ``device``
(default ``"cuda"``; it raises without a card unless ``device="cpu"``).

Several workers: ``PATHWAY_THREADS`` > 1 or ``PATHWAY_PROCESSES`` > 1
(the ``spawn`` supervisor of ``cli.py`` sets both, with
``PATHWAY_PROCESS_ID`` and ``PATHWAY_FIRST_PORT``) run the graph through
``parallel/cluster.py``'s ``ClusterRunner``: one lowered graph per shard,
every shard on ``device``.  Above 8 workers without the
``unlimited-workers`` entitlement the threads are reduced, with a
warning, as the JAX package does.

``persistence_config`` (``pw.persistence.Config``) journals the inputs
and, when asked, snapshots the operators, and a restart replays them
(``persistence.attach_persistence``, wired after the runner is built; in
a cluster each process journals the events it owns).

Telemetry: the run is traced as the spans ``pathway.graph_build`` and
``pathway.run`` (``engine/telemetry.py``'s ``global_tracer``, exported
when the run ends to ``PATHWAY_TRACE_FILE`` and, with
``PATHWAY_MONITORING_SERVER`` set, as OTLP to that endpoint together with
the operators' counters); ``with_http_server=True`` serves ``/metrics``
on port 20000 (``METRICS_PORT``) from process 0 of a cluster, and a
taken port raises; ``PATHWAY_DETAILED_METRICS_DIR`` records the web
dashboard's database; a ``monitoring_level`` other than ``None`` or
``MonitoringLevel.NONE`` starts the terminal dashboard (a streaming run
on a terminal) or the progress reporter.  A failed OTLP metrics export
is logged as a warning and the run's result stands.  A keyword option
that ``pw.run`` does not know raises.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any

from ..engine.runner import GraphRunner, has_live_sources
from . import parse_graph as pg
from .monitoring import MonitoringLevel

#: workers allowed without the ``unlimited-workers`` entitlement
#: (reference: MAX_WORKERS, dataflow/config.rs:11-15)
MAX_WORKERS = 8

_log = logging.getLogger("pathway_tpu_torch")


def _worker_counts() -> tuple[int, int]:
    """``(threads, processes)`` of this run, threads reduced to the
    worker cap without the entitlement."""
    from .config import pathway_config

    n_shards = max(1, pathway_config.threads)
    n_procs = max(1, pathway_config.processes)
    if n_shards * n_procs <= MAX_WORKERS:
        return n_shards, n_procs
    from .licensing import LicenseError, check_entitlements

    try:
        check_entitlements("unlimited-workers")
        return n_shards, n_procs
    except LicenseError:
        pass
    new_shards = max(1, MAX_WORKERS // n_procs)
    if n_procs > MAX_WORKERS:
        # a process cannot shrink the cluster it was spawned into: the
        # supervisor (cli.spawn) clamps processes
        _log.warning(
            "%d processes exceeds the %d-worker cap and cannot be reduced "
            "from inside a worker; the spawn supervisor clamps process "
            "counts — 'unlimited-workers' entitlement required for this "
            "size", n_procs, MAX_WORKERS)
    if new_shards != n_shards:
        _log.warning(
            "%d workers exceeds the maximum allowed (%d) without the "
            "'unlimited-workers' entitlement; reducing threads %d -> %d",
            n_shards * n_procs, MAX_WORKERS, n_shards, new_shards)
    return new_shards, n_procs


def _graph_of(scheduler) -> dict:
    return {
        "nodes": [{"id": op.id, "name": op.name}
                  for op in scheduler.operators],
        "edges": [[up.id, op.id] for op in scheduler.operators
                  for up in op.inputs],
    }


def run(
    *,
    debug: bool = False,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    default_logging: bool = True,
    persistence_config: Any = None,
    runtime_typechecking: bool = False,
    terminate_on_error: bool = True,
    autocommit_duration_ms: int = 50,
    timeout_s: float | None = None,
    idle_stop_s: float | None = None,
    device="cuda",
    **kwargs: Any,
) -> None:
    if kwargs:
        raise TypeError(f"pw.run() got unknown options {sorted(kwargs)}")
    sinks = list(pg.G.outputs)
    if not sinks:
        return
    from ..io._synchronization import apply_synchronization_groups

    apply_synchronization_groups()
    from ..engine.telemetry import global_error_log, global_tracer
    from .config import pathway_config

    global_error_log.clear()
    n_shards, n_procs = _worker_counts()
    streaming = has_live_sources(sinks)

    # with an OTLP endpoint configured, the flight recorder's flusher
    # ships the request and data-plane spans to it for the run's
    # lifetime (a no-op otherwise)
    from .. import obs

    obs.maybe_start_flusher_from_env()

    with global_tracer.span("pathway.graph_build", sinks=len(sinks)):
        if n_shards > 1 or n_procs > 1:
            from ..parallel.cluster import ClusterRunner

            runner: Any = ClusterRunner(
                sinks, n_local_shards=n_shards,
                pid=pathway_config.process_id, nprocs=n_procs,
                first_port=pathway_config.first_port, device=device,
            )
            if terminate_on_error:
                from ..engine import operators as _o

                for lg in runner.graphs.values():
                    for op in lg.scheduler.operators:
                        if isinstance(op, _o.OutputOperator):
                            op.terminate_on_error = True
        else:
            runner = GraphRunner(sinks, terminate_on_error=terminate_on_error,
                                 device=device)
        # the counters of the first owned shard (of the only one in a
        # single-worker run)
        scheduler = runner.lg.scheduler
        if persistence_config is not None:
            from ..persistence import attach_persistence

            attach_persistence(runner, persistence_config)

    fabric = getattr(runner, "fabric", None)
    metrics = reporter = dashboard = recorder = None
    try:
        if with_http_server and pathway_config.process_id == 0:
            # process 0 alone serves /metrics, on METRICS_PORT (read
            # here, so a caller can move it)
            from ..engine import telemetry

            metrics = telemetry.MetricsServer(scheduler,
                                              port=telemetry.METRICS_PORT)
            metrics.fabric = fabric
            metrics.start()
        metrics_dir = os.environ.get("PATHWAY_DETAILED_METRICS_DIR")
        if metrics_dir:
            from ..web_dashboard.db import MetricsRecorder

            recorder = MetricsRecorder(
                scheduler, metrics_dir, worker_id=pathway_config.process_id,
                graph=_graph_of(scheduler))
            recorder.start()
        if monitoring_level not in (None, MonitoringLevel.NONE):
            if streaming and sys.stderr.isatty():
                from .monitoring import MonitoringDashboard

                dashboard = MonitoringDashboard(
                    scheduler,
                    monitoring_level
                    if isinstance(monitoring_level, MonitoringLevel)
                    else MonitoringLevel.IN_OUT,
                )
                dashboard.start()
            else:
                from ..engine.telemetry import ProgressReporter

                reporter = ProgressReporter(scheduler)
                reporter.start()
        with global_tracer.span("pathway.run", streaming=streaming,
                                shards=n_shards, procs=n_procs):
            if streaming:
                runner.run_streaming(
                    autocommit_ms=autocommit_duration_ms,
                    timeout_s=timeout_s,
                    idle_stop_s=idle_stop_s,
                )
            else:
                runner.run_batch()
    except SystemExit:
        raise  # a rescale request: the peers exit with the same code
    except BaseException as exc:
        # a cluster whose start failed here (a taken metrics port) poisons
        # its peers, which would otherwise wait out their deadlines; the
        # runner's own failures already did (its abort runs once)
        abort = getattr(runner, "_abort", None)
        if abort is not None:
            abort(exc)
        raise
    finally:
        global_tracer.export()
        endpoint = os.environ.get("PATHWAY_MONITORING_SERVER")
        if endpoint:
            from ..engine.telemetry import otlp_export_metrics

            try:
                otlp_export_metrics(endpoint, scheduler, fabric=fabric)
            except Exception:
                _log.warning("OTLP metrics export to %s failed", endpoint,
                             exc_info=True)
        for part in (dashboard, reporter, metrics, recorder):
            if part is not None:
                part.stop()
    if global_error_log.entries:
        first = global_error_log.entries[0]
        _log.warning(
            "%d expression error(s) during run; first: %s (%s)",
            len(global_error_log.entries), first["message"], first["operator"],
        )


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
