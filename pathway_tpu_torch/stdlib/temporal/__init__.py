"""Temporal stdlib (the port of ``pathway_tpu/stdlib/temporal``):
windows, temporal joins, behaviors, the incremental sort and the
as-of-now join.

Reference: python/pathway/stdlib/temporal/ — _window.py:39-873,
interval_join, window_join, asof_join, temporal_behavior.py.  Window
assignment lowers to a rowwise select, a flatten and a groupby over
plain columns, and the temporal joins to the engine's join, so their
reducers and join keys reach the data plane's device programs.
"""

from ._window import Window, intervals_over, session, sliding, tumbling, windowby
from ._window_join import (
    WindowJoinResult,
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from ._interval_join import (
    IntervalJoinResult,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
)
from ._asof_join import (
    AsofJoinResult,
    asof_join,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
)
from ._asof_now_join import (
    AsofNowJoinResult,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
)
from .temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
    exactly_once_behavior,
)
from ._sort import sort
from .time_utils import add_update_timestamp_utc, inactivity_detection, utc_now

__all__ = [
    "windowby", "tumbling", "sliding", "session", "intervals_over", "Window",
    "window_join", "window_join_inner", "window_join_left", "window_join_right",
    "window_join_outer", "interval", "interval_join", "interval_join_inner",
    "interval_join_left", "interval_join_right", "interval_join_outer",
    "asof_join", "asof_join_left", "asof_join_right", "asof_join_outer",
    "asof_now_join", "asof_now_join_inner", "asof_now_join_left",
    "common_behavior", "exactly_once_behavior", "Behavior", "CommonBehavior",
    "ExactlyOnceBehavior", "sort", "inactivity_detection", "utc_now",
    "add_update_timestamp_utc",
    "AsofJoinResult", "AsofNowJoinResult", "IntervalJoinResult",
    "WindowJoinResult",
]
