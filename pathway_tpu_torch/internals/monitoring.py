"""``pw.MonitoringLevel`` (the enum of ``pathway_tpu/internals/monitoring.py``;
reference: python/pathway/internals/monitoring.py).

Only the enum is ported: ``pw.run`` accepts ``None`` and
``MonitoringLevel.NONE`` and raises for any other level, since the
dashboard and progress reporter are not ported yet.
"""

from __future__ import annotations

import enum


class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


__all__ = ["MonitoringLevel"]
