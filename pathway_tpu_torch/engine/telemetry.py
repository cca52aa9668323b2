"""The engine's error log: provenance of every ``Error`` value an
expression produced (the part of ``pathway_tpu/engine/telemetry.py``
this package has; its metrics server and OTLP export are not ported).
"""

from __future__ import annotations

import threading
import time


class ErrorLog:
    """Collects Value::Error provenance (reference: ``Graph::error_log``;
    ``pw.global_error_log``)."""

    def __init__(self) -> None:
        self.entries: list[dict] = []
        self._lock = threading.Lock()
        self.limit = 10_000

    def record(self, message: str, operator: str = "", trace: str = "") -> None:
        if not trace:
            # default provenance: the user stack frame that created the
            # operator currently executing (set by the scheduler)
            from .graph import current_op_trace

            t = current_op_trace()
            trace = str(t) if t is not None else ""
        with self._lock:
            if len(self.entries) < self.limit:
                self.entries.append(
                    {"message": message, "operator": operator, "trace": trace,
                     "ts": time.time()}
                )

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()


global_error_log = ErrorLog()
