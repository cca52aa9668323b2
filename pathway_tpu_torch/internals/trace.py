"""User stack-frame capture for error attribution.

Reference: python/pathway/internals/trace.py — operators remember where in
user code they were created so engine errors point at the right line.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass


@dataclass(frozen=True)
class Trace:
    filename: str
    line_number: int
    line: str

    def __str__(self) -> str:
        return f"{self.filename}:{self.line_number} :: {self.line}"


class EngineErrorWithTrace(RuntimeError):
    """An engine-side failure attributed to the user code that built the
    failing operator (reference: EngineErrorWithTrace,
    python/pathway/internals/trace.py + graph_runner/__init__.py:228)."""

    def __init__(self, message: str, operator: str = "",
                 trace: "Trace | None" = None):
        self.operator = operator
        self.trace = trace
        loc = f"\n  operator: {operator}" if operator else ""
        if trace is not None:
            loc += f"\n  defined at {trace}"
        super().__init__(f"{message}{loc}")


def capture_trace() -> Trace | None:
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if "/pathway_tpu_torch/" in fn or fn.startswith("<"):
            continue
        return Trace(fn, frame.lineno or 0, frame.line or "")
    return None
