"""Operator-state snapshots: O(state) restart instead of O(history) replay.

The port of ``pathway_tpu/persistence/snapshots.py`` (reference:
src/persistence/operator_snapshot.rs:21-372 + src/engine/dataflow/persist.rs
+ the metadata commit tracker, tracker.rs:51-275).  A snapshot is one
atomic metadata record per worker process:

    { shape, frontier, ops: {(shard, pos): pickled-state},
      names: {(shard, pos): operator class}, offsets: {input_idx: offsets},
      journal_seqs: {stream: last seq folded} }

written at commit frontiers every ``snapshot_interval_ms``.  On restart:

  1. restore each stateful operator's state by (shard, topo-position) — the
     lowering is deterministic, so positions are a stable identity;
  2. replay ONLY the journal tail (records appended after the snapshot);
  3. seek connector offsets; trim the journal to the tail;
  4. trim file-sink output back to the snapshot frontier (the tail replay
     re-emits anything after it exactly once).

Where the JAX module swallows an error, this one decides:

- a snapshot that cannot be taken (an operator's state does not pickle, the
  backend fails) fails the run: the caller asked for snapshots;
- a snapshot that cannot be used — unreadable, of another cluster shape,
  or of a graph whose operators differ — is ignored with a warning and the
  full journal replays, which is correct only while no restart has trimmed
  the journal under a snapshot (``TRIMMED_KEY``); after a trim it raises,
  since the trimmed records live only in that snapshot;
- an operator whose ``restore_state`` raises fails the run (earlier
  operators are already restored, so a full replay would apply their
  events twice);
- a sink whose trim fails fails the run (appending to an untrimmed file
  would write the tail's rows twice).
"""

from __future__ import annotations

import logging
import pickle
import time as _time

logger = logging.getLogger(__name__)

_META_KEY = "opsnapshot"
#: metadata key set once a restart has trimmed folded records off the
#: journal: from then on a snapshot is the only copy of those records
TRIMMED_KEY = "journal_trimmed"


def _ops_by_identity(runner):
    """[(identity, op)] — identity = (shard, topo_pos) on the cluster
    runner, (0, topo_pos) on the single GraphRunner."""
    out = []
    if hasattr(runner, "graphs"):  # ClusterRunner
        for s, g in runner.graphs.items():
            for pos, op in enumerate(g.scheduler.topo_order()):
                out.append(((s, pos), op))
    else:
        for pos, op in enumerate(runner.lg.scheduler.topo_order()):
            out.append(((0, pos), op))
    return out


def _runner_shape(runner) -> tuple[int, int]:
    return (
        getattr(runner, "nprocs", 1),
        getattr(runner, "threads", 1),
    )


def _meta_key(runner) -> str:
    pid = getattr(runner, "pid", 0)
    return f"{_META_KEY}_p{pid}"


class SnapshotManager:
    def __init__(self, runner, backend, interval_ms: int,
                 stream_names: dict[int, str]):
        self.runner = runner
        self.backend = backend
        self.interval_s = max(interval_ms, 250) / 1000.0
        self.stream_names = stream_names  # input_idx -> journal stream
        # stream -> last journal seq written; shared with the journaling
        # wrappers, so a snapshot's watermarks survive journal trimming
        self.journal_seqs: dict[str, int] = {}
        self._last = _time.monotonic()

    # -- write side ---------------------------------------------------------
    def due(self) -> bool:
        """Interval check for the coordinator of a cluster snapshot wave."""
        now = _time.monotonic()
        if now - self._last < self.interval_s:
            return False
        self._last = now
        return True

    def maybe_snapshot(self) -> None:
        if self.due():
            self.snapshot()

    def snapshot(self) -> None:
        """Write one snapshot; raises (naming the operator) if a state
        does not pickle, or what the backend raises."""
        runner = self.runner
        ops_state: dict = {}
        names: dict = {}
        for ident, op in _ops_by_identity(runner):
            st = op.snapshot_state()
            if st is None:
                continue
            try:
                ops_state[ident] = pickle.dumps(
                    st, protocol=pickle.HIGHEST_PROTOCOL)
            except (pickle.PicklingError, TypeError, AttributeError) as exc:
                raise RuntimeError(
                    f"operator snapshot: the state of {op.name} "
                    f"({type(op).__name__}) cannot be pickled: {exc}"
                ) from exc
            names[ident] = type(op).__name__
        offsets = {}
        for idx, (_op, source) in enumerate(runner.lg.input_ops):
            if hasattr(source, "get_offsets"):
                offsets[idx] = source.get_offsets()
        frontier = (
            runner.frontier
            if hasattr(runner, "frontier")
            else runner.lg.scheduler.frontier
        )
        payload = {
            "shape": _runner_shape(runner),
            "frontier": frontier,
            "ops": ops_state,
            "names": names,
            "offsets": offsets,
            "journal_seqs": dict(self.journal_seqs),
        }
        self.backend.put_metadata(
            _meta_key(runner),
            pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL),
        )


def _unusable(backend, why: str, *args) -> None:
    """A snapshot that cannot be used: full journal replay while the
    journal is whole (returns None to the caller), else raise."""
    msg = why % args
    if backend.get_metadata(TRIMMED_KEY):
        raise RuntimeError(
            f"{msg}, and a restart has trimmed the journal under an earlier "
            "snapshot: the trimmed records exist only in that snapshot, so "
            "the journal cannot replay the inputs whole")
    logger.warning("%s; the whole journal replays instead", msg)


def try_restore(runner, backend, stream_names: dict[int, str]) -> dict | None:
    """Load + apply the latest snapshot.  Returns {"frontier", "offsets",
    "journal_seqs"} on success (attach then replays only journal tails),
    or None (attach uses the full-replay path).

    Cluster mode reads EVERY process's snapshot: they were written as one
    coordinated wave at the same frontier, so their fold watermarks merge
    into a consistent cut; any frontier mismatch (a crash mid-wave) rejects
    the whole set."""
    raw = backend.get_metadata(_meta_key(runner))
    if not raw:
        return None
    try:
        snap = pickle.loads(raw)
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
            AttributeError, ImportError) as exc:
        return _unusable(backend, "unreadable operator snapshot (%s)", exc)
    if snap.get("shape") != _runner_shape(runner):
        return _unusable(
            backend, "cluster shape changed %s -> %s: operator snapshot "
            "ignored", snap.get("shape"), _runner_shape(runner))
    merged_seqs = dict(snap.get("journal_seqs", {}))
    nprocs = getattr(runner, "nprocs", 1)
    if nprocs > 1:
        my_pid = getattr(runner, "pid", 0)
        for peer in range(nprocs):
            if peer == my_pid:
                continue
            praw = backend.get_metadata(f"{_META_KEY}_p{peer}")
            if not praw:
                return _unusable(backend, "peer %d snapshot missing", peer)
            try:
                psnap = pickle.loads(praw)
            except (pickle.UnpicklingError, EOFError, ValueError) as exc:
                return _unusable(backend, "peer %d snapshot unreadable (%s)",
                                 peer, exc)
            if psnap.get("frontier") != snap.get("frontier") or (
                psnap.get("shape") != snap.get("shape")
            ):
                return _unusable(
                    backend, "snapshot wave inconsistent (peer %d frontier "
                    "%s != %s)", peer, psnap.get("frontier"),
                    snap.get("frontier"))
            merged_seqs.update(psnap.get("journal_seqs", {}))
    # every identity must name the same operator class in this graph
    # before any state is touched: a changed graph restores nothing
    by_ident = dict(_ops_by_identity(runner))
    names = snap.get("names", {})
    for ident in snap["ops"]:
        op = by_ident.get(ident)
        want = names.get(ident)
        if op is None or type(op).__name__ != want:
            return _unusable(
                backend, "operator snapshot of another graph (%s at %s, "
                "this graph has %s)", want, ident,
                type(op).__name__ if op is not None else "nothing")
    for ident, blob in snap["ops"].items():
        by_ident[ident].restore_state(pickle.loads(blob))
    frontier = snap["frontier"]
    # restore the logical clock so new times stay beyond restored state
    if hasattr(runner, "frontier"):
        runner.frontier = max(runner.frontier, frontier)
    else:
        runner.lg.scheduler.frontier = max(
            runner.lg.scheduler.frontier, frontier
        )
    # exactly-once sink output: drop entries the tail replay will re-emit
    if getattr(runner, "pid", 0) == 0:
        for w in runner.lg.writers:
            if hasattr(w, "resume"):
                w.resume(frontier)
    return {
        "frontier": frontier,
        "offsets": snap.get("offsets", {}),
        "journal_seqs": merged_seqs,
    }
