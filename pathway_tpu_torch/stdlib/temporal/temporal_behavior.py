"""Temporal behaviors (reference: stdlib/temporal/temporal_behavior.py:21-101).

The port of ``pathway_tpu/stdlib/temporal/temporal_behavior.py``.

Behaviors control when windows emit (delay), when late data is dropped
(cutoff) and whether closed windows are retracted (keep_results).  They lower
to the engine's buffer/freeze/forget operators (engine time_ops).
"""

from __future__ import annotations

import dataclasses
from typing import Any


class Behavior:
    pass


@dataclasses.dataclass
class CommonBehavior(Behavior):
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclasses.dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)
