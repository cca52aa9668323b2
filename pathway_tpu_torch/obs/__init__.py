"""pathway_tpu_torch.obs — the port of ``pathway_tpu.obs``: request-scoped
tracing and the always-on flight recorder (``obs/tracer.py``), and the
device cost observatory: per-program profiles on CUDA events
(``obs/profiler.py``), the HBM ledger with pre-flight fit checks and the
auto-config (``obs/memory.py``), the persistent cost store
(``obs/costdb.py``) and the planner (``obs/planner.py``).  It imports
``torch`` and nothing of JAX or ``pathway_tpu``."""

from . import costdb, memory, planner, profiler  # noqa: F401
from .tracer import (  # noqa: F401
    FlightRecorder,
    Span,
    chrome_trace_dump,
    context_from_trace_header,
    current_context,
    disabled,
    event,
    export_otlp,
    maybe_start_flusher_from_env,
    new_trace_id,
    record_span,
    recorder,
    reset_current,
    sanitize_trace_id,
    set_current,
    shutdown,
    span,
    start_flusher,
    start_span,
    use_context,
)

__all__ = [
    "costdb", "memory", "planner", "profiler",
    "FlightRecorder", "Span", "chrome_trace_dump",
    "context_from_trace_header", "current_context", "disabled", "event",
    "export_otlp", "maybe_start_flusher_from_env", "new_trace_id",
    "record_span", "recorder", "reset_current", "sanitize_trace_id",
    "set_current", "shutdown", "span", "start_flusher", "start_span",
    "use_context",
]
