"""`.dt` expression namespace (reference: internals/expressions/date_time.py, 1,651 LoC).

DateTimeNaive / DateTimeUtc are plain `datetime.datetime` (tz-naive / tz-aware);
Duration is `datetime.timedelta`.
"""

from __future__ import annotations

import datetime

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, wrap


def _m(name, fn, *args, dtype=dt.ANY):
    return MethodCallExpression(name, fn, *args, dtype=dtype)


_EPOCH_NAIVE = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)

# reference unit spellings (date_time.py:1119-1140)
_DURATION_UNITS = {
    "W": 7 * 86400.0,
    **{u: 86400.0 for u in ("D", "day", "days")},
    **{u: 3600.0 for u in ("h", "hr", "hour", "hours")},
    **{u: 60.0 for u in ("m", "min", "minute", "minutes")},
    **{u: 1.0 for u in ("s", "sec", "second", "seconds")},
    **{u: 1e-3 for u in ("ms", "millisecond", "milliseconds", "millis", "milli")},
    **{u: 1e-6 for u in ("us", "microsecond", "microseconds", "micros", "micro")},
    **{u: 1e-9 for u in ("ns", "nano", "nanos", "nanosecond", "nanoseconds")},
}


def _epoch_for(v: datetime.datetime) -> datetime.datetime:
    return _EPOCH_UTC if v.tzinfo is not None else _EPOCH_NAIVE


class DateTimeNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    # extraction -----------------------------------------------------------
    def year(self):
        return _m("dt.year", lambda v: v.year, self._e, dtype=dt.INT)

    def month(self):
        return _m("dt.month", lambda v: v.month, self._e, dtype=dt.INT)

    def day(self):
        return _m("dt.day", lambda v: v.day, self._e, dtype=dt.INT)

    def hour(self):
        return _m("dt.hour", lambda v: v.hour, self._e, dtype=dt.INT)

    def minute(self):
        return _m("dt.minute", lambda v: v.minute, self._e, dtype=dt.INT)

    def second(self):
        return _m("dt.second", lambda v: v.second, self._e, dtype=dt.INT)

    def microsecond(self):
        return _m("dt.microsecond", lambda v: v.microsecond, self._e, dtype=dt.INT)

    def millisecond(self):
        return _m("dt.millisecond", lambda v: v.microsecond // 1000, self._e, dtype=dt.INT)

    def nanosecond(self):
        return _m("dt.nanosecond", lambda v: v.microsecond * 1000, self._e, dtype=dt.INT)

    def weekday(self):
        return _m("dt.weekday", lambda v: v.weekday(), self._e, dtype=dt.INT)

    def days(self):
        return _m("dt.days", lambda v: v.days, self._e, dtype=dt.INT)

    def hours(self):
        return _m("dt.hours", lambda v: int(v.total_seconds() // 3600), self._e, dtype=dt.INT)

    def minutes(self):
        return _m("dt.minutes", lambda v: int(v.total_seconds() // 60), self._e, dtype=dt.INT)

    def seconds(self):
        return _m("dt.seconds", lambda v: int(v.total_seconds()), self._e, dtype=dt.INT)

    def milliseconds(self):
        return _m("dt.milliseconds", lambda v: int(v.total_seconds() * 1000), self._e, dtype=dt.INT)

    def microseconds(self):
        return _m("dt.microseconds", lambda v: int(v.total_seconds() * 1e6), self._e, dtype=dt.INT)

    def nanoseconds(self):
        return _m("dt.nanoseconds", lambda v: int(v.total_seconds() * 1e9), self._e, dtype=dt.INT)

    # conversion -----------------------------------------------------------
    def timestamp(self, unit: str = "s"):
        div = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]

        def fn(v):
            return (v - _epoch_for(v)).total_seconds() / div

        return _m("dt.timestamp", fn, self._e, dtype=dt.FLOAT)

    def strftime(self, fmt):
        return _m("dt.strftime", lambda v, f: v.strftime(f), self._e, wrap(fmt), dtype=dt.STR)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        def fn(v, f):
            out = datetime.datetime.strptime(v, f)
            return out

        return _m("dt.strptime", fn, self._e, wrap(fmt), dtype=dt.DATE_TIME_NAIVE)

    def to_naive_in_timezone(self, timezone: str):
        from zoneinfo import ZoneInfo

        return _m(
            "dt.to_naive_in_timezone",
            lambda v, tz: v.astimezone(ZoneInfo(tz)).replace(tzinfo=None),
            self._e, wrap(timezone), dtype=dt.DATE_TIME_NAIVE,
        )

    def to_utc(self, from_timezone: str):
        from zoneinfo import ZoneInfo

        return _m(
            "dt.to_utc",
            lambda v, tz: v.replace(tzinfo=ZoneInfo(tz)).astimezone(datetime.timezone.utc),
            self._e, wrap(from_timezone), dtype=dt.DATE_TIME_UTC,
        )

    def utc_now(self):  # pragma: no cover - convenience
        return _m("dt.utc_now", lambda _: datetime.datetime.now(datetime.timezone.utc), self._e)

    def from_timestamp(self, unit: str = "s", tz=None):
        mult = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]

        def fn(v):
            secs = v * mult
            if tz is not None:
                return datetime.datetime.fromtimestamp(secs, datetime.timezone.utc)
            return _EPOCH_NAIVE + datetime.timedelta(seconds=secs)

        return _m("dt.from_timestamp", fn, self._e,
                  dtype=dt.DATE_TIME_UTC if tz is not None else dt.DATE_TIME_NAIVE)

    def weeks(self):
        return _m(
            "dt.weeks", lambda v: int(v.total_seconds() // (7 * 86400)),
            self._e, dtype=dt.INT,
        )

    def to_duration(self, unit="s"):
        """Integer -> Duration (reference: date_time.py:1119)."""
        def fn(v, u):
            mult = _DURATION_UNITS.get(u)
            if mult is None:
                raise ValueError(f"unknown duration unit {u!r}")
            return datetime.timedelta(seconds=v * mult)

        return _m("dt.to_duration", fn, self._e, wrap(unit), dtype=dt.DURATION)

    def utc_from_timestamp(self, unit: str = "s"):
        """int/float timestamp -> DateTimeUtc (reference: date_time.py:1563)."""
        mult = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]

        def fn(v):
            return datetime.datetime.fromtimestamp(v * mult, datetime.timezone.utc)

        return _m("dt.utc_from_timestamp", fn, self._e, dtype=dt.DATE_TIME_UTC)

    # timezone-aware arithmetic (reference: date_time.py:840-980 — composed
    # exactly as the reference composes them, so DST transitions match)
    def add_duration_in_timezone(self, duration, timezone):
        return (self.to_utc(timezone) + wrap(duration)).dt.to_naive_in_timezone(
            timezone
        )

    def subtract_duration_in_timezone(self, duration, timezone):
        return (self.to_utc(timezone) - wrap(duration)).dt.to_naive_in_timezone(
            timezone
        )

    def subtract_date_time_in_timezone(self, date_time, timezone):
        other = wrap(date_time)
        return self.to_utc(timezone) - other.dt.to_utc(timezone)

    def round(self, duration):
        def fn(v, d):
            epoch = _epoch_for(v)
            total = (v - epoch).total_seconds()
            step = d.total_seconds() if isinstance(d, datetime.timedelta) else float(d)
            rounded = round(total / step) * step
            return epoch + datetime.timedelta(seconds=rounded)

        return _m("dt.round", fn, self._e, wrap(duration))

    def floor(self, duration):
        def fn(v, d):
            epoch = _epoch_for(v)
            total = (v - epoch).total_seconds()
            step = d.total_seconds() if isinstance(d, datetime.timedelta) else float(d)
            floored = (total // step) * step
            return epoch + datetime.timedelta(seconds=floored)

        return _m("dt.floor", fn, self._e, wrap(duration))
