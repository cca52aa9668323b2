"""Monitoring levels + live console dashboard (the port of
``pathway_tpu/internals/monitoring.py``; reference:
internals/monitoring.py:56-249 — a rich-TUI layout with a per-connector
message table, a per-operator latency table, and a logs panel).

The dashboard here renders with raw ANSI (the rich library is not in this
image): a background thread redraws once a second while the run loop
executes.  Columns mirror the reference dashboard:

- connectors: messages in the last minibatch / in the last minute / since
  start, plus "finished" once a source closes
- operators: busy ms per second (where wall time goes), commit-frontier
  lag, rows in/out and retained state entries
- logs: the most recent warning/error lines (captured via a logging
  handler), plus poisoned-value errors from the global error log

On a non-tty it degrades to periodic plain-text summaries.  ``pw.run``
starts the dashboard for a streaming run whose standard error is a
terminal and a ``ProgressReporter`` (``engine/telemetry.py``) otherwise,
for any ``monitoring_level`` but ``None`` or ``MonitoringLevel.NONE``.
"""

from __future__ import annotations

import collections
import enum
import logging
import sys
import threading
import time


class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


class StatsMonitor:
    def __init__(self, scheduler):
        self.scheduler = scheduler

    def snapshot(self) -> dict:
        ops = {}
        for op in self.scheduler.operators:
            ops[f"{op.name}#{op.id}"] = {
                "rows_in": op.rows_in,
                "rows_out": op.rows_out,
            }
        return {
            "frontier": self.scheduler.frontier,
            "operators": ops,
        }


_CLEAR = "\x1b[2J\x1b[H"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RED = "\x1b[31m"
_RESET = "\x1b[0m"


class _LogBuffer(logging.Handler):
    """Captures recent warning+ log lines for the dashboard's logs panel
    (reference: StatsMonitor's RichHandler + LogsOutput)."""

    def __init__(self, limit: int = 6):
        super().__init__(level=logging.WARNING)
        self.lines: collections.deque[str] = collections.deque(maxlen=limit)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.lines.append(
                f"{record.levelname[:4]} {record.getMessage()}"[:110]
            )
        except Exception:
            pass


class MonitoringDashboard:
    """Live terminal dashboard fed by engine operator counters."""

    def __init__(self, scheduler, level: MonitoringLevel,
                 interval_s: float = 1.0, file=None):
        self.scheduler = scheduler
        self.level = level
        self.interval_s = interval_s
        self.file = file or sys.stderr
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # op.id -> (rows_in, rows_out, busy_s) at previous frame
        self._prev: dict[int, tuple[int, int, float]] = {}
        self._prev_t = time.monotonic()
        self._started = time.monotonic()
        self._last_frontier = -1
        self._frontier_at = time.monotonic()
        # per-connector sliding history: op.id -> deque[(ts, rows_out)]
        self._history: dict[int, collections.deque] = {}
        self._last_minibatch: dict[int, int] = {}
        self._logbuf = _LogBuffer()

    def start(self) -> None:
        # handler attaches here, not in __init__: a constructed-but-never-
        # started dashboard must not leak a root-logger handler
        logging.getLogger().addHandler(self._logbuf)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pw-dashboard"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        logging.getLogger().removeHandler(self._logbuf)
        # leave a final plain summary behind
        try:
            self.file.write(self._render(final=True) + "\n")
            self.file.flush()
        except Exception:
            pass

    def _loop(self) -> None:
        tty = getattr(self.file, "isatty", lambda: False)()
        while not self._stop.wait(self.interval_s):
            try:
                frame = self._render()
                if tty:
                    self.file.write(_CLEAR + frame + "\n")
                else:
                    self.file.write(frame + "\n")
                self.file.flush()
            except Exception:
                return

    # -- stats -------------------------------------------------------------
    def _connector_rows(self, now: float):
        """(name, last_minibatch, last_minute, since_start, finished)."""
        rows = []
        for op in self.scheduler.operators:
            if op.inputs:
                continue  # not a source
            hist = self._history.get(op.id)
            if hist is None:
                # baseline at dashboard start with 0 rows: rows delivered
                # before the first frame still count toward the minute window
                hist = self._history[op.id] = collections.deque(
                    [(self._started, 0)]
                )
            prev_total = hist[-1][1]
            if op.rows_out != prev_total:
                self._last_minibatch[op.id] = op.rows_out - prev_total
            hist.append((now, op.rows_out))
            while len(hist) > 1 and hist[0][0] < now - 60.0:
                hist.popleft()
            last_minute = op.rows_out - hist[0][1]
            finished = bool(getattr(op, "finished", False))
            rows.append((
                f"{op.name}#{op.id}",
                self._last_minibatch.get(op.id, 0),
                last_minute,
                op.rows_out,
                finished,
            ))
        return rows

    def _operator_rows(self, now: float):
        dt_s = max(now - self._prev_t, 1e-9)
        out = []
        ops = self.scheduler.operators
        if self.level != MonitoringLevel.ALL:
            ops = [
                op for op in ops
                if not op.downstream or not op.inputs  # sources + sinks
            ]
        for op in ops:
            pin, pout, pbusy = self._prev.get(op.id, (0, 0, 0.0))
            rate_in = (op.rows_in - pin) / dt_s
            rate_out = (op.rows_out - pout) / dt_s
            busy_ms = (op.busy_s - pbusy) / dt_s * 1e3  # busy ms per second
            out.append((
                f"{op.name}#{op.id}", op.rows_in, op.rows_out,
                rate_in, rate_out, busy_ms, op.state_size(),
            ))
            self._prev[op.id] = (op.rows_in, op.rows_out, op.busy_s)
        self._prev_t = now
        return out

    # -- rendering ---------------------------------------------------------
    def _render(self, final: bool = False) -> str:
        frontier = self.scheduler.frontier
        now = time.monotonic()
        if frontier != self._last_frontier:
            self._last_frontier = frontier
            self._frontier_at = now
        lag = now - self._frontier_at
        lines = [
            f"{_BOLD}pathway-tpu progress dashboard{_RESET}  "
            f"uptime {now - self._started:6.1f}s   "
            f"frontier {frontier}   commit lag {lag * 1000:6.0f}ms",
            "",
            f"{_BOLD}connectors{_RESET}",
            f"{_DIM}{'connector':<28}{'last minibatch':>16}"
            f"{'last minute':>14}{'since start':>14}{_RESET}",
        ]
        for name, mini, minute, total, finished in self._connector_rows(now):
            mini_s = "finished" if finished else str(mini)
            lines.append(
                f"{name:<28}{mini_s:>16}{minute:>14}{total:>14}"
            )
        lines += [
            "",
            f"{_BOLD}operators{_RESET}",
            f"{_DIM}{'operator':<28}{'rows in':>11}{'rows out':>11}"
            f"{'in/s':>9}{'out/s':>9}{'busy ms/s':>11}{'state':>9}{_RESET}",
        ]
        for name, rin, rout, rate_in, rate_out, busy_ms, state in (
            self._operator_rows(now)
        ):
            lines.append(
                f"{name:<28}{rin:>11}{rout:>11}{rate_in:>9.0f}"
                f"{rate_out:>9.0f}{busy_ms:>11.1f}{state:>9}"
            )
        log_lines = list(self._logbuf.lines)
        from ..engine.telemetry import global_error_log

        for e in global_error_log.entries[-3:]:
            loc = f" at {e['trace']}" if e.get("trace") else ""
            log_lines.append(f"ERR  {e['message']}{loc}"[:110])
        if log_lines:
            lines += ["", f"{_BOLD}logs{_RESET}"]
            lines += [f"{_RED}{ln}{_RESET}" for ln in log_lines[-6:]]
        if final:
            lines.append(f"{_DIM}(run finished){_RESET}")
        return "\n".join(lines)
