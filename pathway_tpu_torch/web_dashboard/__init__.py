"""Web dashboard over detailed run metrics.

The port of ``pathway_tpu/web_dashboard`` (reference:
python/pathway/web_dashboard/) — run a pipeline with
``PATHWAY_DETAILED_METRICS_DIR`` set (the engine records ``metrics_*.db``),
then serve the dashboard with ``python -m pathway_tpu_torch dashboard``.
"""

from .dashboard import DashboardServer
from .db import MetricsRecorder

__all__ = ["DashboardServer", "MetricsRecorder"]
