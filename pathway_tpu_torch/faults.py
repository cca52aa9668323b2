"""Fault-injection registry of the port: the engine, the journal and the
cluster's fabric.

The port's own copy of ``pathway_tpu/faults.py``: named fault points
call :func:`fire`, and a fault installed at that point (:func:`install`,
or the ``PW_FAULT`` environment variable) acts there.  Failure handling
that only real failures exercise is failure handling that does not work.

Fault points (the JAX package's names):

=============================  ==========================================
``engine.dispatch.step``       before a decode step's dispatch
``engine.dispatch.mixed``      before a ragged mixed step's dispatch
``engine.dispatch.chain``      before a chained decode's dispatch
``engine.dispatch.prefill``    before a whole-bucket prefill's dispatch
``engine.dispatch.verify``     before a speculative verify dispatch
``engine.draft``               before the speculative draft; ``drop``
                               skips drafting for the round
``engine.sync``                inside the device->host pull of the ids
                               (on the watchdog's thread when one is on);
                               ``hang`` models a wedged device program
``persistence.append``         a journal record is about to be written;
                               ``kill`` here dies mid-ingest, ``raise``
                               models a failing backend
``persistence.commit``         the journal record landed; ``kill`` here
                               dies after the commit, before its effects
                               reach any sink
``fabric.send.data``           one logical data frame about to be written
                               (``parallel/comm.py``'s sender thread);
                               ``delay``, ``drop``, ``close``, ``kill``
``fabric.send.ctl``            one control frame (marks, ctl, eot,
                               heartbeats); the same actions
``fabric.mark``                a counted mark is about to be posted
                               (``parallel/cluster.py``); ``kill`` here
                               dies mid-exchange
=============================  ==========================================

``PW_FAULT`` holds ``;``-separated specs
``point:action[:nth[:arg_ms[:pid]]]`` (``nth`` default 1), read at the
first :func:`fire` or :func:`install` after the process starts or
:func:`clear` runs, so a test can arm a fault inside a child process:
``PW_FAULT="persistence.commit:kill:2"`` kills the process right after
its second journal append, ``"fabric.send.data:drop:3:0:1"`` drops the
third data frame of the worker with ``PATHWAY_PROCESS_ID`` 1.  A spec
that does not parse raises.  With ``PW_FAULT_STAMP_DIR`` set, a spec
writes a stamp there when it first fires and never fires while the stamp
exists, so a supervisor's restart of the same program with the same
environment is not killed again; the stamp is also the proof that the
fault fired.

Actions: ``raise`` raises :class:`InjectedFault`; ``delay`` and ``hang``
sleep ``arg_ms`` milliseconds; ``drop`` and ``close`` are returned to the
caller, which interprets them (the fabric drops the frame, or severs the
connection); ``kill`` dumps the flight recorder (a dying process leaves
its evidence, as a crash handler would) and ends the process with
:data:`KILL_EXIT_CODE`.  ``nth`` is the 1-based hit at which a fault
fires (0: every hit).  Every fired fault lands on the flight recorder as
a ``fault.injected`` event.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

logger = logging.getLogger(__name__)

_ACTIONS = ("raise", "hang", "delay", "drop", "close", "kill")

#: exit code of the ``kill`` action (a SIGKILL'd process's)
KILL_EXIT_CODE = 137


class InjectedFault(RuntimeError):
    """Raised at a fault point armed with the ``raise`` action."""


class FaultSpec:
    __slots__ = ("point", "action", "nth", "arg_ms", "pid", "hits")

    def __init__(self, point: str, action: str, nth: int = 1,
                 arg_ms: float = 0.0, pid: int | None = None):
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; expected one of {_ACTIONS}"
            )
        self.point = point
        self.action = action
        self.nth = int(nth)
        self.arg_ms = float(arg_ms)
        self.pid = pid
        self.hits = 0

    def _stamp_path(self) -> str | None:
        d = os.environ.get("PW_FAULT_STAMP_DIR")
        if not d:
            return None
        # the whole spec names its stamp: two specs that differ only in
        # pid or arg must not share one
        pid = "any" if self.pid is None else self.pid
        safe = (f"{self.point}_{self.action}_{self.nth}"
                f"_{self.arg_ms:g}_{pid}").replace("/", "_")
        return os.path.join(d, f"{safe}.fired")

    def should_fire(self) -> bool:
        """(caller holds the registry lock)  Count this hit; decide.  With
        ``PW_FAULT_STAMP_DIR`` a spec fires once across the incarnations
        of a supervised restart: the first firing writes its stamp, and a
        stamp present means it already fired."""
        self.hits += 1
        if self.nth != 0 and self.hits != self.nth:
            return False
        stamp = self._stamp_path()
        if stamp is not None:
            if os.path.exists(stamp):
                return False
            os.makedirs(os.path.dirname(stamp), exist_ok=True)
            with open(stamp, "w") as f:
                f.write(f"pid={os.getpid()} ts={time.time():.3f}\n")
        return True


def parse_spec(text: str) -> FaultSpec:
    """``point:action[:nth[:arg_ms[:pid]]]``, as ``PW_FAULT`` carries it."""
    parts = text.strip().split(":")
    if len(parts) < 2 or len(parts) > 5:
        raise ValueError(
            f"bad PW_FAULT spec {text!r}: want "
            "point:action[:nth[:arg_ms[:pid]]]")
    nth = int(parts[2]) if len(parts) > 2 and parts[2] else 1
    arg_ms = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
    pid = int(parts[4]) if len(parts) > 4 and parts[4] else None
    return FaultSpec(parts[0], parts[1], nth, arg_ms, pid)


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._env_loaded = False

    def _load_env_locked(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        for part in os.environ.get("PW_FAULT", "").split(";"):
            if part.strip():
                self._specs.append(parse_spec(part))

    def install(self, point: str, action: str, *, nth: int = 1,
                arg_ms: float = 0.0, pid: int | None = None) -> FaultSpec:
        spec = FaultSpec(point, action, nth, arg_ms, pid)
        with self._lock:
            self._load_env_locked()
            self._specs.append(spec)
        return spec

    def clear(self) -> None:
        """Drop every spec; the next call reads ``PW_FAULT`` again."""
        with self._lock:
            self._specs = []
            self._env_loaded = False

    def specs(self) -> list[FaultSpec]:
        with self._lock:
            self._load_env_locked()
            return list(self._specs)

    def fire(self, point: str, **ctx) -> str | None:
        """Advance the counters of every spec at ``point`` and act on
        those that fire: ``raise`` raises, ``delay``/``hang`` sleep,
        ``drop`` and ``close`` are returned for the caller to act on (the
        first of them wins).  Returns None when nothing fired (or the
        sleep's action name after a delay or hang).  A spec with a
        ``pid`` counts only the hits of the worker whose
        ``PATHWAY_PROCESS_ID`` it names.  ``ctx`` (the JAX call's
        keywords, as ``stream=``) goes on the recorder's event."""
        with self._lock:
            self._load_env_locked()
            if not self._specs:
                return None
            my_pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
            # every matching spec counts every hit, so two armed faults
            # at one point both fire at their own hit
            triggered = [s for s in self._specs
                         if s.point == point
                         and (s.pid is None or s.pid == my_pid)
                         and s.should_fire()]
        from . import obs

        result = None
        for spec in triggered:
            obs.event("fault.injected", point=point, action=spec.action,
                      nth=spec.nth, **{k: str(v) for k, v in ctx.items()})
            logger.warning("fault injected: %s -> %s (hit %d)%s", point,
                           spec.action, spec.hits,
                           f" ctx={ctx}" if ctx else "")
            if spec.action == "raise":
                raise InjectedFault(
                    f"injected fault at {point} (hit {spec.hits})"
                )
            if spec.action in ("delay", "hang"):
                time.sleep(max(spec.arg_ms, 0.0) / 1000.0)
            if spec.action == "kill":
                print(f"fault.injected kill at {point} (hit {spec.hits})",
                      file=sys.stderr, flush=True)
                obs.recorder().dump_on_failure(
                    "fault_kill", InjectedFault(point))
                os._exit(KILL_EXIT_CODE)
            if spec.action in ("drop", "close"):
                if result not in ("drop", "close"):
                    result = spec.action
            elif result is None:
                result = spec.action
        return result


_REGISTRY = FaultRegistry()

install = _REGISTRY.install
clear = _REGISTRY.clear
fire = _REGISTRY.fire
specs = _REGISTRY.specs


def active() -> bool:
    """Whether any fault is armed (the fabric's sender checks this once a
    cycle before passing each frame through its fault point)."""
    return bool(_REGISTRY.specs())


__all__ = ["FaultRegistry", "FaultSpec", "InjectedFault", "KILL_EXIT_CODE",
           "active", "clear", "fire", "install", "parse_spec", "specs"]
