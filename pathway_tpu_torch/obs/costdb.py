"""Persistent cost-model store: measured per-program device costs (the
port of ``pathway_tpu/obs/costdb.py``).

A JSON database keyed ``(program, shape bucket, backend fingerprint)``
holding measured dispatch ms / bytes / MFU: what the planner
(``obs/planner.py``), ``speculative="auto"``
(``kvcache/speculative.py``) and ``generate(fused="auto")``'s tier prior
(``models/decoder.py``) read, and what ``profiler.publish_to_costdb``
and the speculation controller write.

Entries are small running aggregates (best/EWMA/count), merged on
``observe``; one daemon writer thread flushes dirty state to disk
atomically every few seconds and drains on ``shutdown()`` (registered
atexit).  Several processes share one file (a cluster's workers): a
flush re-reads and merges the file under an exclusive lock on
``<path>.lock``, so no process's keys are lost; a key two processes both
write keeps the last flush's aggregate.  The file format is the reference's, versioned:

```json
{"version": 1,
 "entries": {
   "<program>|<bucket>|<backend fingerprint>": {
     "program": "pw.chained_decode", "bucket": "tree(21)+bf16[...]",
     "fingerprint": "cuda:NVIDIA-H100-80GB-HBM3:torch2.6.0",
     "n": 12, "ms_best": 38.2, "ms_avg": 41.0, "ms_last": 40.1,
     "flops": 1.2e9, "bytes": 3.4e8, "mfu": 0.021,
     "extra": {"dispatches": 64}, "updated": 1770000000.0}}}
```

The fingerprint is ``<backend>:<device name, spaces as ->:torch<version>``
(``cpu:cpu:torch<version>`` without a card), and the default path is
``~/.cache/pathway_tpu_torch/costdb.json`` (``PW_COSTDB_PATH`` wins).  A
missing file is an empty store; a file that does not parse raises,
where the reference starts empty.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

_EWMA = 0.3  # weight of the newest observation in ms_avg


def _read_entries(path: str) -> dict:
    """The entries of the store file at ``path``; ``{}`` when the file
    does not exist.  A file that exists but is not a store raises."""
    try:
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
    except FileNotFoundError:
        return {}
    if not (isinstance(raw, dict) and isinstance(raw.get("entries"), dict)):
        raise ValueError(f"cost store {path!r} holds no 'entries' map")
    return dict(raw["entries"])


def backend_fingerprint() -> str:
    """Identifies what the measurements were taken ON: backend, device
    name and torch version — a cost measured on one machine must not
    steer planning on another.  The card when one is present, else the
    CPU."""
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).replace(" ", "-")
        return f"cuda:{name}:torch{torch.__version__}"
    return f"cpu:cpu:torch{torch.__version__}"


def default_path() -> str:
    env = os.environ.get("PW_COSTDB_PATH")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "pathway_tpu_torch", "costdb.json")


class CostDB:
    """The persistent (program, bucket, backend) -> measured-cost map."""

    def __init__(self, path: str | None = None,
                 flush_interval_s: float = 5.0):
        self.path = path or default_path()
        self.flush_interval_s = flush_interval_s
        self.fingerprint = backend_fingerprint()
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._dirty = False
        self._writer: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        self._entries = _read_entries(self.path)

    def flush(self) -> bool:
        """Atomic write of the current state; returns False (logged) on a
        write failure (a read-only filesystem must never take serving
        down).  The
        on-disk entries are re-read and merged first so concurrent
        processes sharing the file append to — rather than erase — each
        other's keys (same-key conflicts resolve to this process's
        fresher observation; best-effort, no file lock)."""
        with self._lock:
            if not self._dirty:
                return True
            ours = dict(self._entries)
            self._dirty = False
        tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # the read-merge-replace under one exclusive lock: two
            # processes flushing at once would each merge the file as it
            # was, and the second replace would drop the first's keys
            with open(f"{self.path}.lock", "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                merged = _read_entries(self.path)
                merged.update(ours)
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump({"version": 1, "entries": merged}, fh,
                              default=str)
                os.replace(tmp, self.path)
            return True
        except OSError:
            logger.warning("cost store: cannot write %s; retrying on the "
                           "next flush", self.path, exc_info=True)
            with self._lock:
                self._dirty = True  # retry on the next tick
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def _writer_loop(self) -> None:
        while not self._stop_evt.wait(self.flush_interval_s):
            self.flush()
        self.flush()  # final drain

    def _ensure_writer(self) -> None:
        # under the lock: two first-observers racing here must not each
        # spawn a writer (duplicate flush loops for the process lifetime)
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return
            if self._stop_evt.is_set():
                return  # shut down: no resurrection, caller flushes
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="pw-costdb-writer",
            )
            self._writer.start()

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop the writer (final flush included).  Idempotent."""
        self._stop_evt.set()
        w = self._writer
        if w is not None and w.is_alive():
            w.join(timeout=timeout_s)
        self._writer = None
        self.flush()

    @property
    def writer_alive(self) -> bool:
        return self._writer is not None and self._writer.is_alive()

    # -- the map -----------------------------------------------------------
    def key(self, program: str, bucket: str) -> str:
        return f"{program}|{bucket}|{self.fingerprint}"

    def observe(self, program: str, bucket: str, *, ms: float | None = None,
                flops: float | None = None, bytes: float | None = None,
                mfu: float | None = None, extra: dict | None = None) -> dict:
        """Merge one measurement into the store (running best/EWMA) and
        schedule a flush."""
        k = self.key(program, bucket)
        with self._lock:
            e = self._entries.get(k)
            if e is None:
                e = self._entries[k] = {
                    "program": program, "bucket": bucket,
                    "fingerprint": self.fingerprint, "n": 0,
                }
            e["n"] = int(e.get("n", 0)) + 1
            if ms is not None:
                ms = float(ms)
                e["ms_last"] = round(ms, 4)
                e["ms_best"] = round(
                    min(float(e.get("ms_best", ms)), ms), 4
                )
                prev = e.get("ms_avg")
                e["ms_avg"] = round(
                    ms if prev is None
                    else (1 - _EWMA) * float(prev) + _EWMA * ms, 4
                )
            for name, val in (("flops", flops), ("bytes", bytes),
                              ("mfu", mfu)):
                if val is not None:
                    e[name] = val
            if extra:
                e.setdefault("extra", {}).update(extra)
            e["updated"] = round(time.time(), 1)
            self._dirty = True
            out = dict(e)
        self._ensure_writer()
        return out

    def get(self, program: str, bucket: str) -> dict | None:
        """The entry for (program, bucket) under THIS backend
        fingerprint, or None — cross-backend entries are invisible by
        construction."""
        with self._lock:
            e = self._entries.get(self.key(program, bucket))
            return dict(e) if e else None

    def entries(self, program: str | None = None) -> list[dict]:
        with self._lock:
            out = [dict(e) for e in self._entries.values()]
        if program is not None:
            out = [e for e in out if e.get("program") == program]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_default: CostDB | None = None
_default_lock = threading.Lock()


def default_db() -> CostDB:
    """The process-wide store at :func:`default_path` (override with
    ``PW_COSTDB_PATH``)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CostDB()
        return _default


def shutdown(timeout_s: float = 5.0) -> None:
    """Stop the default store's writer thread (final flush included).
    Idempotent; registered atexit, so a process never exits with the
    thread running."""
    global _default
    with _default_lock:
        db = _default
        _default = None
    if db is not None:
        db.shutdown(timeout_s)


import atexit  # noqa: E402  (registration belongs with shutdown)

atexit.register(shutdown)
