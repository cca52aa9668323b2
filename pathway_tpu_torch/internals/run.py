"""pw.run() — execute every registered output sink.

The port of ``pathway_tpu/internals/run.py`` (reference:
python/pathway/internals/run.py:13) for one process: batch graphs
execute to completion; graphs with live sources run the streaming poll
loop until ``timeout_s``, ``idle_stop_s`` or their sources finish.  The
data plane runs on ``device`` (default ``"cuda"``; it raises without a
card unless ``device="cpu"``).

Monitoring, persistence, the HTTP metrics server and several threads or
processes (``PATHWAY_THREADS`` / ``PATHWAY_PROCESSES``) are not ported:
asking for one of them raises, naming it.
"""

from __future__ import annotations

import logging
import os
from typing import Any

from ..engine.runner import GraphRunner, has_live_sources
from . import parse_graph as pg


def _refuse_unported(monitoring_level: Any, with_http_server: bool,
                     persistence_config: Any, kwargs: dict) -> None:
    asked = []
    if monitoring_level is not None:
        asked.append(f"monitoring_level={monitoring_level!r} (monitoring)")
    if with_http_server:
        asked.append("with_http_server=True (the HTTP metrics server)")
    if persistence_config is not None:
        asked.append("persistence_config (persistence)")
    for var in ("PATHWAY_THREADS", "PATHWAY_PROCESSES"):
        if int(os.environ.get(var, "1")) > 1:
            asked.append(f"{var}={os.environ[var]} (several workers)")
    if kwargs:
        asked.append(f"options {sorted(kwargs)}")
    if asked:
        raise NotImplementedError(
            "pw.run of this package runs one process without monitoring, "
            "persistence or the HTTP server; not supported: "
            + "; ".join(asked)
        )


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
    _refuse_unported(monitoring_level, with_http_server, persistence_config,
                     kwargs)
    sinks = list(pg.G.outputs)
    if not sinks:
        return
    from ..engine.telemetry import global_error_log

    global_error_log.clear()
    runner = GraphRunner(sinks, terminate_on_error=terminate_on_error,
                         device=device)
    if has_live_sources(sinks):
        runner.run_streaming(
            autocommit_ms=autocommit_duration_ms,
            timeout_s=timeout_s,
            idle_stop_s=idle_stop_s,
        )
    else:
        runner.run_batch()
    if global_error_log.entries:
        first = global_error_log.entries[0]
        logging.getLogger("pathway_tpu_torch").warning(
            "%d expression error(s) during run; first: %s (%s)",
            len(global_error_log.entries), first["message"], first["operator"],
        )


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
