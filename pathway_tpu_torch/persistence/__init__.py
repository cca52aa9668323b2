"""Persistence API: checkpoint input streams and operator state, resume
after a restart with exactly-once output.

The port of ``pathway_tpu/persistence/__init__.py`` (reference:
python/pathway/persistence/__init__.py:13-116 + src/persistence/):
input-event journaling with offset frontiers (connector resume),
operator snapshots (``snapshots.py``, restored ahead of journal replay),
``CachedObjectStorage`` for vanished origins, the seven modes of
``PersistenceMode`` and deterministic-rerun prefix skipping for opt-in
from-scratch sources, over the filesystem, in-memory and object-store
backends (``Backend.s3`` / ``Backend.azure``: one object a journal
record, ``{stream}/{seq:012d}``, through ``io.s3``'s client seam, the
JAX package's layout).  The journal is pure Python and pickle:
nothing of it runs on the card, but a restart replays the journal
through the data plane on the run's device, so an index on the card is
rebuilt there.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import pickle
import re
import time as _time
from collections import Counter
from typing import Any

from .. import faults
from ..engine.types import _hashable_row

logger = logging.getLogger(__name__)


class PersistenceMode(enum.Enum):
    """Reference: src/connectors/mod.rs:140-148."""

    REALTIME_REPLAY = "realtime_replay"
    SPEEDRUN_REPLAY = "speedrun_replay"
    BATCH = "batch"
    PERSISTING = "persisting"
    SELECTIVE_PERSISTING = "selective_persisting"
    UDF_CACHING = "udf_caching"
    OPERATOR_PERSISTING = "operator_persisting"


class Backend:
    @classmethod
    def filesystem(cls, path: str) -> "FilesystemBackend":
        return FilesystemBackend(path)

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None) -> "S3Backend":
        return S3Backend(root_path, bucket_settings)

    @classmethod
    def azure(cls, root_path: str, account_settings: Any = None) -> "AzureBackend":
        return AzureBackend(root_path, account_settings)

    @classmethod
    def mock(cls, events: Any = None) -> "MockBackend":
        return MockBackend()

    # -- journal API -------------------------------------------------------
    def append(self, stream: str, record: bytes) -> None:
        raise NotImplementedError

    def read_all(self, stream: str) -> list[bytes]:
        raise NotImplementedError

    def put_metadata(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get_metadata(self, key: str) -> bytes | None:
        raise NotImplementedError

    def list_streams(self, prefix: str) -> list[str]:
        """Stream names starting with prefix (cluster union replay)."""
        return []


class FilesystemBackend(Backend):
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _stream_path(self, stream: str) -> str:
        safe = stream.replace("/", "_")
        return os.path.join(self.path, f"{safe}.journal")

    def replace_all(self, stream: str, records: list[bytes]) -> None:
        """Atomically rewrite a stream (journal compaction)."""
        p = self._stream_path(stream)
        tmp = f"{p}.tmp"
        with open(tmp, "wb") as f:
            for record in records:
                f.write(len(record).to_bytes(8, "little"))
                f.write(record)
        os.replace(tmp, p)

    def append(self, stream: str, record: bytes) -> None:
        with open(self._stream_path(stream), "ab") as f:
            f.write(len(record).to_bytes(8, "little"))
            f.write(record)

    def read_all(self, stream: str) -> list[bytes]:
        p = self._stream_path(stream)
        if not os.path.exists(p):
            return []
        out = []
        with open(p, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                n = int.from_bytes(header, "little")
                rec = f.read(n)
                if len(rec) < n:
                    break  # torn tail write — ignore
                out.append(rec)
        return out

    def list_streams(self, prefix: str) -> list[str]:
        safe = prefix.replace("/", "_")
        out = []
        for fn in os.listdir(self.path):
            if fn.endswith(".journal") and fn[:-8].startswith(safe):
                out.append(fn[:-8])
        return sorted(out)

    def put_metadata(self, key: str, value: bytes) -> None:
        # atomic replace: cluster processes read this concurrently
        p = os.path.join(self.path, f"{key}.meta")
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, p)

    def get_metadata(self, key: str) -> bytes | None:
        p = os.path.join(self.path, f"{key}.meta")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()


class S3Backend(Backend):
    """Journal/metadata over an object store (reference:
    src/persistence/backends/s3.rs).  Objects have no append, so each
    journal record is its own object `{stream}/{seq:012d}`.  The client
    comes from AwsS3Settings' seam (boto3 or an injected fake).

    `replace_all` is atomic, as the filesystem backend's rename is: a
    stream that has been replaced carries a live range in the object
    `meta/live/{stream}`, `{"first": F, "end": E}`, and only records with
    F <= seq (< E, while E is set) are read.  A replacement freezes the
    range at the stream's end, writes the new records past it, moves the
    range onto them with one put and only then deletes the old records; a
    crash before that put leaves the old records live, one after it the
    new.  The next append deletes the records a crash left outside the
    range.  A stream with no range object reads every record, so journals
    the JAX package wrote replay unchanged."""

    def __init__(self, root_path: str, bucket_settings: Any = None):
        from ..io.s3 import AwsS3Settings, resolve_path

        self.settings = bucket_settings or AwsS3Settings()
        self.bucket, prefix = resolve_path(root_path, self.settings)
        self.prefix = prefix.rstrip("/")
        self._client = None
        self._next_seq: dict[str, int] = {}

    def _c(self):
        if self._client is None:
            self._client = self.settings.make_client()
        return self._client

    def _skey(self, stream: str) -> str:
        safe = stream.replace("/", "_")
        return f"{self.prefix}/streams/{safe}"

    def _list(self, key_prefix: str) -> list[str]:
        from ..io.s3 import list_keys_paginated

        return list_keys_paginated(self._c(), self.bucket, key_prefix)

    def _records(self, stream: str) -> list[tuple[int, str]]:
        """(seq, key) of every record object of the stream, in order."""
        base = self._skey(stream) + "/"
        return [(int(k.rsplit("/", 1)[1]), k) for k in self._list(base)]

    def _live(self, stream: str) -> tuple[int, int | None]:
        raw = self.get_metadata(f"live/{stream.replace('/', '_')}")
        if raw is None:
            return 0, None
        live = json.loads(raw)
        return int(live["first"]), live["end"]

    def _put_live(self, stream: str, first: int, end: int | None) -> None:
        self.put_metadata(f"live/{stream.replace('/', '_')}",
                          json.dumps({"first": first, "end": end}).encode())

    def _delete(self, keys) -> None:
        for key in keys:
            self._c().delete_object(Bucket=self.bucket, Key=key)

    def append(self, stream: str, record: bytes) -> None:
        base = self._skey(stream)
        seq = self._next_seq.get(stream)
        if seq is None:
            first, end = self._live(stream)
            records = self._records(stream)
            # a replacement that crashed leaves records outside the live
            # range: those past a frozen end would become live with the
            # next append, so they go (and the range opens) first
            if end is not None:
                self._delete(k for s, k in records if s >= end)
                self._put_live(stream, first, None)
                records = [(s, k) for s, k in records if s < end]
            self._delete(k for s, k in records if s < first)
            seq = max([first] + [s + 1 for s, _k in records])
        self._next_seq[stream] = seq + 1
        self._c().put_object(
            Bucket=self.bucket, Key=f"{base}/{seq:012d}", Body=record
        )

    def read_all(self, stream: str) -> list[bytes]:
        first, end = self._live(stream)
        out = []
        for seq, key in self._records(stream):
            if seq < first or (end is not None and seq >= end):
                continue
            resp = self._c().get_object(Bucket=self.bucket, Key=key)
            out.append(resp["Body"].read())
        return out

    def replace_all(self, stream: str, records: list[bytes]) -> None:
        base = self._skey(stream)
        first, end = self._live(stream)
        old = self._records(stream)
        start = max([first] + [s + 1 for s, _k in old])
        if end is None:
            end = start
        # freeze the live range: the records written below stay unread
        # until the put that moves the range onto them
        self._put_live(stream, first, end)
        for i, rec in enumerate(records):
            self._c().put_object(
                Bucket=self.bucket, Key=f"{base}/{start + i:012d}", Body=rec
            )
        self._put_live(stream, start, None)
        self._next_seq[stream] = start + len(records)
        self._delete(k for s, k in old)

    def list_streams(self, prefix: str) -> list[str]:
        base = f"{self.prefix}/streams/"
        safe = prefix.replace("/", "_")
        names = set()
        for key in self._list(base + safe):
            rest = key[len(base):]
            names.add(rest.rsplit("/", 1)[0])
        return sorted(names)

    def put_metadata(self, key: str, value: bytes) -> None:
        self._c().put_object(
            Bucket=self.bucket, Key=f"{self.prefix}/meta/{key}", Body=value
        )

    def get_metadata(self, key: str) -> bytes | None:
        try:
            resp = self._c().get_object(
                Bucket=self.bucket, Key=f"{self.prefix}/meta/{key}"
            )
            return resp["Body"].read()
        except Exception as exc:
            if _is_missing_key_error(exc):
                return None
            # transient errors must NOT read as "no metadata" — the
            # journal-format heuristic would mistake an existing journal
            # for v1 and destroy it
            raise


class AzureBackend(S3Backend):
    """Azure Blob persistence (reference: src/persistence/backends/azure.rs)
    — the S3Backend object-per-record layout over an azure-storage-blob
    container client adapted to the same list/get/put/delete verbs.
    `account_settings` may carry `_client` (S3-verb fake) for tests or
    `container_client` (a real azure ContainerClient) wrapped below."""

    def __init__(self, root_path: str, account_settings: Any = None):
        cc = getattr(account_settings, "container_client", None)
        if cc is not None:
            from ..io.s3 import AwsS3Settings

            account_settings = AwsS3Settings(
                bucket_name=getattr(account_settings, "container", "azure"),
                _client=_AzureS3Adapter(cc),
            )
        super().__init__(root_path, account_settings)


class _AzureS3Adapter:
    """azure ContainerClient -> the S3 verbs the backend speaks."""

    def __init__(self, container_client):
        self.cc = container_client

    def list_objects_v2(self, Bucket, Prefix="", **_kw):
        names = [
            {"Key": b.name} for b in self.cc.list_blobs(name_starts_with=Prefix)
        ]
        return {"Contents": names, "IsTruncated": False}

    def get_object(self, Bucket, Key):
        import io as _io3

        data = self.cc.download_blob(Key).readall()
        return {"Body": _io3.BytesIO(data)}

    def put_object(self, Bucket, Key, Body):
        self.cc.upload_blob(Key, Body, overwrite=True)

    def delete_object(self, Bucket, Key):
        try:
            self.cc.delete_blob(Key)
        except Exception as exc:
            # delete is idempotent for MISSING blobs only; a transient
            # failure leaving stale journal objects must surface (replay
            # would otherwise apply ghost records)
            if type(exc).__name__ not in ("ResourceNotFoundError", "KeyError"):
                raise


def _is_missing_key_error(exc: Exception) -> bool:
    if isinstance(exc, KeyError):
        return True  # in-process fakes raise KeyError for absent objects
    code = ""
    resp = getattr(exc, "response", None)
    if isinstance(resp, dict):
        code = str(resp.get("Error", {}).get("Code", ""))
    name = type(exc).__name__
    # azure-core raises ResourceNotFoundError for a blob that is not there
    return code in ("NoSuchKey", "404", "NotFound") or name in (
        "NoSuchKey", "NotFound", "ResourceNotFoundError",
    )


class MockBackend(Backend):
    def __init__(self):
        self.streams: dict[str, list[bytes]] = {}
        self.meta: dict[str, bytes] = {}

    def append(self, stream, record):
        self.streams.setdefault(stream, []).append(record)

    def read_all(self, stream):
        return list(self.streams.get(stream, []))

    def replace_all(self, stream, records):
        self.streams[stream] = list(records)

    def list_streams(self, prefix):
        return sorted(s for s in self.streams if s.startswith(prefix))

    def put_metadata(self, key, value):
        self.meta[key] = value

    def get_metadata(self, key):
        return self.meta.get(key)


@dataclasses.dataclass
class Config:
    backend: Backend | None = None
    snapshot_interval_ms: int = 0
    persistence_mode: str = "persisting"

    @classmethod
    def simple_config(cls, backend: Backend, persistence_mode: str = "persisting",
                      snapshot_interval_ms: int = 0, **kwargs) -> "Config":
        return cls(backend, snapshot_interval_ms=snapshot_interval_ms,
                   persistence_mode=persistence_mode)

    #: full PersistenceMode matrix (reference: src/connectors/mod.rs:140-148)
    #: - persisting (default): journal + replay, distinct times preserved
    #: - speedrun_replay: journal + replay preserving every recorded commit
    #:   time, injected as fast as downstream keeps up (alias of the default
    #:   replay path, named for parity)
    #: - realtime_replay: replay paced by the recorded wall-clock gaps
    #:   between journal records
    #: - batch: replay collapses onto a single logical time
    #: - selective_persisting: only sources created with a persistent_id
    #:   are journaled/replayed
    #: - udf_caching: no input journaling; only UDF caches persist
    #: - operator_persisting: operator snapshots + journal tail
    MODES = (
        "persisting", "speedrun_replay", "realtime_replay", "batch",
        "selective_persisting", "udf_caching", "operator_persisting",
    )

    def __init__(self, backend: Backend | None = None, *, snapshot_interval_ms: int = 0,
                 persistence_mode: str = "persisting", cache_objects: bool = True,
                 **kwargs):
        self.backend = backend
        self.snapshot_interval_ms = snapshot_interval_ms
        mode = persistence_mode
        if hasattr(mode, "value"):  # pw.PersistenceMode enum member
            mode = mode.value
        if mode not in self.MODES:
            raise ValueError(
                f"unknown persistence_mode {persistence_mode!r}; "
                f"expected one of {self.MODES}"
            )
        self.persistence_mode = mode
        # raw-object caching (CachedObjectStorage); on by default like the
        # reference's scanner-backed connectors
        self.cache_objects = cache_objects


# Journal format history: v1 (round 1) keyed primary-key rows off raw
# uncoerced connector values; v2 keys off coerced typed values.  Replaying a
# journal written under a different keying would silently duplicate rows, so
# a mismatched journal must be cleared before re-ingest — but clearing is
# data loss for sources whose upstream history is gone (expired Kafka
# retention), so it requires explicit opt-in and archives instead of deleting.
_JOURNAL_FORMAT_VERSION = 2
_MIGRATION_ENV = "PATHWAY_ALLOW_JOURNAL_MIGRATION"


def _migrate_journal_format(backend, streams, ver, nprocs, pid) -> None:
    """Archive (never delete) old-format journal streams, opt-in only.

    Cluster mode: only pid 0 performs the archive; peers wait for the version
    stamp to flip so concurrent processes never race the rewrite."""
    if os.environ.get(_MIGRATION_ENV, "") != "1":
        # every process raises the actionable message immediately — peers
        # must not sit in the wait loop when pid 0 is guaranteed to refuse
        raise RuntimeError(
            f"persistence journal format v{ver} is incompatible with current "
            f"v{_JOURNAL_FORMAT_VERSION}. Replaying it would corrupt state, "
            f"and discarding it loses any history the sources no longer "
            f"serve. Set {_MIGRATION_ENV}=1 to archive the old journal "
            "(streams are renamed, not deleted) and re-ingest from sources, "
            "or clear the persistence storage manually."
        )
    if nprocs > 1 and pid != 0:
        deadline = _time.monotonic() + 60.0
        while _time.monotonic() < deadline:
            cur = backend.get_metadata("journal_format")
            try:
                if cur and int(cur) == _JOURNAL_FORMAT_VERSION:
                    return
            except ValueError:
                pass
            _time.sleep(0.1)
        raise RuntimeError(
            f"persistence journal format v{ver} needs migration but process "
            "0 did not complete it within 60s"
        )
    if not hasattr(backend, "replace_all"):
        raise RuntimeError(
            f"persistence journal format v{ver} is incompatible with "
            f"current v{_JOURNAL_FORMAT_VERSION} and this backend cannot "
            "rewrite streams; clear the persistence storage manually"
        )
    logger.warning(
        "persistence journal format v%s != current v%s: archiving journal "
        "under 'archived_v%s__*' and re-ingesting from sources",
        ver, _JOURNAL_FORMAT_VERSION, ver,
    )
    for s in streams:
        records = backend.read_all(s)
        if not records:
            continue
        archive = f"archived_v{ver}__{s}"
        # idempotent: a crash between archive-write and source-clear leaves
        # the archive complete, and a retry rewrites (not appends) it
        if not backend.read_all(archive):
            backend.replace_all(archive, records)
        backend.replace_all(s, [])


def attach_persistence(runner, config: Config) -> None:
    """Wire input journaling + replay into a GraphRunner.

    Each input operator gets: (1) replay of journaled events before live
    ones, (2) journaling of every new batch keyed by logical time.
    """
    backend = config.backend
    if backend is None:
        return
    mode = getattr(config, "persistence_mode", "persisting")
    if mode == "udf_caching":
        # only UDF caches persist (reference: PersistenceMode::UdfCaching);
        # udf cache backends are configured on the UDFs themselves
        # (internals/udfs.py) — no input journaling, no snapshots
        return
    lg = runner.lg
    nprocs = getattr(runner, "nprocs", 1)
    pid = getattr(runner, "pid", 0)
    streams: list[str] = []
    for idx, (_op, source) in enumerate(lg.input_ops):
        base = _stream_name(idx, source)
        streams.extend(sorted(set(backend.list_streams(base)) | {base}))
    ver_b = backend.get_metadata("journal_format")
    # the stamp is written by an atomic replace, so one that does not
    # parse is not a torn write: the storage is not this package's
    try:
        ver_parsed = int(ver_b) if ver_b else None
    except ValueError:
        raise RuntimeError(
            f"persistence journal format stamp {ver_b!r} is unreadable; the "
            "storage was not written by this package") from None
    if ver_parsed is not None:
        ver = ver_parsed
    elif any(backend.read_all(s) for s in streams):
        # journals exist but carry no version stamp: they predate the
        # metadata key, which is format v1
        ver = 1
    else:
        ver = _JOURNAL_FORMAT_VERSION
    if ver != _JOURNAL_FORMAT_VERSION:
        _migrate_journal_format(backend, streams, ver, nprocs, pid)
    backend.put_metadata("journal_format", str(_JOURNAL_FORMAT_VERSION).encode())
    # cluster awareness: each worker process journals ONLY the events it owns
    # into its own per-process stream; replay is the UNION of all processes'
    # streams, re-filtered by the CURRENT ownership map — this survives
    # elastic rescaling, where the shard->process assignment changes
    # (reference: per-worker input snapshots redistributed by the metadata
    # tracker, src/persistence/tracker.rs:51-275)
    owns_event = getattr(runner, "owns_event", None)
    # operator snapshots (O(state) restart): enabled with an interval or the
    # explicit mode (reference: PersistenceMode::OperatorPersisting)
    snapshots_on = (
        config.snapshot_interval_ms > 0
        or config.persistence_mode == "operator_persisting"
    ) and mode != "selective_persisting"
    # selective mode cannot take operator snapshots: restored operator state
    # would fold events of NON-persisted sources (which replay from scratch
    # at their original times), double-applying them and violating the
    # restored-frontier invariant for fresh pushes
    snap = None
    if snapshots_on:
        snap = snapmod.try_restore(runner, backend, {})
    journal_seqs: dict[str, int] = {}
    for idx, (op, source) in enumerate(lg.input_ops):
        if mode == "selective_persisting" and not getattr(
            source, "persistent_id", None
        ):
            # only explicitly-named sources persist
            # (reference: PersistenceMode::SelectivePersisting)
            continue
        base_stream = _stream_name(idx, source)
        write_stream = (
            f"{base_stream}__p{pid}" if nprocs > 1 else base_stream
        )
        read_streams = [base_stream]
        if hasattr(backend, "list_streams"):
            read_streams = sorted(
                set(backend.list_streams(base_stream)) | {base_stream}
            )
        # each journal record is (seq, events, offsets_after): seq-numbered
        # so snapshot watermarks survive journal trimming; offsets travel
        # inside records so journal+offsets commit atomically
        replayed: list = []
        replay_records: list = []  # (wall_ts, events) per surviving record
        last_offsets: dict | None = None
        if snap is not None and idx in snap.get("offsets", {}):
            so = snap["offsets"][idx]
            if so:
                last_offsets = dict(so)
        n_records = 0
        folded = snap.get("journal_seqs", {}) if snap is not None else {}
        # per-key counts of events folded into restored operator state: a
        # static source's live events covered by these counts must NOT be
        # re-injected (they are already inside the snapshot)
        fold_counts: Counter = Counter()
        for rs in read_streams:
            fold_seq = folded.get(rs, -1)
            keep_raw: list[bytes] = []
            raw = backend.read_all(rs)
            max_seq = -1
            for i, rec in enumerate(raw):
                seq, events, offsets, wall_ts = _parse_record(rec, i)
                max_seq = max(max_seq, seq)
                if seq <= fold_seq:
                    for e in events:
                        fold_counts[e[1]] += 1
                    continue  # folded into the restored operator state
                n_records += 1
                keep_raw.append(rec)
                replayed.extend(events)
                replay_records.append((wall_ts, events))
                if offsets is not None:
                    if last_offsets is None:
                        last_offsets = dict(offsets)
                    else:
                        for k, v in offsets.items():
                            cur = last_offsets.get(k)
                            # positions keep their largest value; a dict is
                            # a source's state beside them (a synchronization
                            # gate's parked events): the later record's
                            last_offsets[k] = (
                                v if cur is None or isinstance(v, dict)
                                else max(cur, v))
            if rs == write_stream:
                # never regress below the snapshot watermark: a trimmed-empty
                # stream must not reissue already-folded sequence numbers
                journal_seqs[rs] = max(max_seq, fold_seq)
            # trim folded records (safe any time: watermarks are seqs, not
            # positions); only the owning process rewrites its stream
            if (
                snap is not None
                and len(keep_raw) < len(raw)
                and (rs == write_stream or nprocs <= 1)
                and hasattr(backend, "replace_all")
            ):
                # from here on only the snapshot holds the trimmed records:
                # a later restart that cannot use it must not replay the
                # trimmed journal as if it were whole (snapshots.py)
                backend.put_metadata(snapmod.TRIMMED_KEY, b"1")
                backend.replace_all(rs, keep_raw)
        replayed.sort(key=lambda e: e[0])  # merge streams by logical time
        # journal compaction (reference: operator_snapshot.rs background
        # merging): squash the replay into one consolidated record so the
        # journal doesn't grow with history.  Single-process only: cluster
        # startup reads the same streams concurrently, so rewriting them
        # here would race with peers' reads.
        if (
            snap is None
            and nprocs <= 1
            and n_records > 8
            and hasattr(backend, "replace_all")
            # from-scratch sources re-emit their FULL history incl. net-zero
            # insert+retract pairs; compaction nets those out of the journal
            # and would break the prefix-count skip on restart
            and not getattr(source, "replays_from_scratch", False)
        ):
            compacted = _compact_events(replayed)
            seq = journal_seqs.get(base_stream, n_records - 1)
            backend.replace_all(
                base_stream, [pickle.dumps((seq, compacted, last_offsets))]
            )
            replayed = compacted
            replay_records = [(None, compacted)]
        _wrap_source_with_persistence(
            source, backend, write_stream, replayed, last_offsets,
            owns_event=owns_event if nprocs > 1 else None,
            is_replay_injector=(pid == 0 or nprocs <= 1),
            seq_holder=journal_seqs,
            folded_counts=fold_counts,
            min_time=snap["frontier"] if snap is not None else None,
            mode=mode,
            replay_records=replay_records,
        )
        if getattr(source, "supports_object_cache", False) and getattr(
            config, "cache_objects", True
        ):
            # raw-object cache: downloads survive source disappearance
            # (reference: src/persistence/cached_object_storage.rs)
            source.object_cache = CachedObjectStorage(backend)
    if snapshots_on:
        mgr = snapmod.SnapshotManager(
            runner, backend,
            config.snapshot_interval_ms or 3000,
            {},
        )
        mgr.journal_seqs = journal_seqs
        runner._snapshot_mgr = mgr


def _prefix_skip(counts: Counter, events: list) -> list:
    """Drop the first counts[key] occurrences of each key (MUTATES counts):
    the already-journaled/folded prefix of a deterministically re-run
    stream.  Occurrences beyond the prefix are genuinely fresh."""
    fresh = []
    for e in events:
        if counts.get(e[1], 0) > 0:
            counts[e[1]] -= 1
        else:
            fresh.append(e)
    return fresh


def _parse_record(rec: bytes, position: int):
    """(seq, events, offsets, wall_ts) — 3-tuple records (pre wall-clock
    stamp) get wall_ts=None; legacy 2-tuples also get positional seqs."""
    data = pickle.loads(rec)
    if len(data) == 4:
        return data
    if len(data) == 3:
        return (*data, None)
    events, offsets = data
    return position, events, offsets, None


def _stream_name(idx: int, source) -> str:
    """Stable journal-stream identity across restarts: position among the
    graph's input operators + the source's descriptor.  (Operator ids are a
    process-global counter and MUST NOT leak into stream names.)"""
    desc = (
        getattr(source, "persistent_id", None)
        or getattr(source, "path", None)
        or type(source).__name__
    )
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(desc))[-80:]
    return f"input_{idx}_{safe}"


def _compact_events(events: list) -> list:
    """Net out insert/retract pairs per (key, row), keeping the earliest time
    per survivor — the replayed multiset is exactly the original's net."""
    acc: dict = {}
    order: list = []
    for t, key, row, diff in events:
        hk = (key, _hashable_row(row))
        entry = acc.get(hk)
        if entry is None:
            acc[hk] = [t, row, diff]
            order.append(hk)
        else:
            entry[2] += diff
    out = []
    for hk in order:
        t, row, diff = acc[hk]
        if diff != 0:
            out.append((t, hk[0], row, diff))
    return out


_implicit_rerun_warned: set[str] = set()


def _warn_implicit_rerun_default(source) -> None:
    """One-time heads-up: the `deterministic_rerun` default is False, so a
    ConnectorSubject subclass written for a default of True replays
    differently.  A persisted subject that neither implements seek()/get_offsets() nor sets
    deterministic_rerun explicitly now gets duplicate-on-restart instead of
    prefix-skip — visible loss-safety win, but worth one log line."""
    subject = getattr(source, "subject", None)
    if subject is None or not source.is_live():
        return
    if getattr(subject, "seek", None) is not None:
        return
    from ..io.python import ConnectorSubject as _Base

    cls = type(subject)
    explicit = any(
        "deterministic_rerun" in vars(k)
        for k in cls.__mro__
        if k is not _Base and k is not object
    )
    if explicit:
        return
    label = f"{cls.__module__}.{cls.__qualname__}"
    if label in _implicit_rerun_warned:
        return
    _implicit_rerun_warned.add(label)
    logger.warning(
        "persisted subject %s relies on the deterministic_rerun default "
        "(False): restarts re-ingest any events the subject re-emits "
        "(duplicates) instead of skipping the journaled prefix (which "
        "could silently drop fresh events).  Set deterministic_rerun "
        "explicitly or implement seek() to choose.",
        label,
    )


def _wrap_source_with_persistence(source, backend: Backend, stream: str,
                                  replayed: list, last_offsets,
                                  owns_event=None,
                                  is_replay_injector: bool = True,
                                  seq_holder: dict | None = None,
                                  folded_counts=None,
                                  min_time=None,
                                  mode: str = "persisting",
                                  replay_records: list | None = None) -> None:
    """`owns_event` (cluster mode) filters what THIS process journals, so the
    union of all processes' streams is exactly one copy of the input.
    `is_replay_injector` gates live-source replay to a single process —
    live events are injected exclusively (shipped to owners), so exactly one
    process may replay them.  `seq_holder[stream]` tracks the last journal
    sequence number written (operator-snapshot watermarks).

    After an operator-snapshot restore, `folded_counts` carries per-key
    counts of journal events already folded into restored operator state
    (they must not be re-injected), and `min_time` is the restored frontier:
    any surviving replay/fresh event at a time at or below it is re-timed to
    `min_time + 1` so push_input's time > frontier invariant holds."""
    orig_static = source.static_events
    orig_poll = source.poll
    if seq_holder is None:
        seq_holder = {}
    seq_holder.setdefault(stream, -1)
    if mode == "batch" and replayed:
        # batch replay collapses history onto one logical time (reference:
        # PersistenceMode::Batch AdvanceTime-at-start); max keeps the
        # replayed frontier so fresh live events still land after it
        t_new = max(e[0] for e in replayed)
        replayed = [(t_new, k, row, d) for (_t0, k, row, d) in replayed]

    def _append(events, offsets):
        # fault points: `persistence.append` fires BEFORE the
        # journal write (kill here = die mid-ingest, the row was consumed
        # but never journaled); `persistence.commit` fires AFTER it (kill
        # here = die post-commit, journaled but its effects never
        # flushed).  Exactly-once replay must survive both; a `raise` on
        # append models a failing backend.
        faults.fire("persistence.append", stream=stream)
        seq_holder[stream] += 1
        # wall-clock stamp: realtime_replay paces a later restart by the
        # recorded inter-record gaps
        backend.append(
            stream,
            pickle.dumps((seq_holder[stream], events, offsets, _time.time())))
        faults.fire("persistence.commit", stream=stream)

    # restore the reader's offset frontier so already-consumed rows are not
    # re-read (reference: rewind_from_disk_snapshot + frontier_for,
    # src/connectors/mod.rs:319-388); offsets travel inside journal records,
    # so a crash can never separate "journaled" from "offset-advanced"
    if last_offsets is not None and hasattr(source, "seek"):
        source.seek(last_offsets)

    def _journal(events, offsets=None):
        if owns_event is not None:
            events = [e for e in events if owns_event(e)]
        if events or offsets is not None:
            _append(events, offsets)

    def _retime(events):
        # post-snapshot-restore, no event may land at or below the restored
        # frontier (push_input requires time > frontier)
        if min_time is None or min_time < 0:
            return events
        return [
            (t, k, row, d) if t > min_time else (min_time + 1, k, row, d)
            for (t, k, row, d) in events
        ]

    def static_events():
        live = orig_static()
        if not replayed and not folded_counts:
            if live:
                _journal(live)
            return _retime(live)
        # resumed run over a static source that may have grown: per key, the
        # journal already covers the first count_j(k) live events (static
        # sources replay their event log in a stable order), so only events
        # beyond that prefix are fresh.  This re-ingests a legitimately
        # re-added key after an add+retract pair (live count 3 > journaled 2)
        # without re-journaling net-zero pairs on every resume.  Events
        # folded into a restored operator snapshot count toward the journal
        # prefix but are NOT returned — their effect is already in the
        # restored state.
        jcount = Counter(e[1] for e in replayed)
        if folded_counts:
            jcount.update(folded_counts)
        fresh = _prefix_skip(jcount, live)
        if fresh:
            _journal(fresh)
        return _retime(replayed + fresh)

    # live sources that OPTED INTO deterministic_rerun (replay_csv,
    # range_stream; http.read and user subjects explicitly)
    # re-emit the whole stream on restart: skip the first
    # count(key) occurrences of each replayed/folded key, same prefix-count
    # idiom as static sources — otherwise journal replay + the re-run
    # subject double-ingests
    skip_counts = Counter()
    if getattr(source, "replays_from_scratch", False):
        skip_counts = Counter(e[1] for e in replayed)
        if folded_counts:
            skip_counts.update(folded_counts)

    _warn_implicit_rerun_default(source)

    warned = [False]

    def journaling_poll():
        events = orig_poll()
        if events and skip_counts:
            n_before = len(events)
            events = _prefix_skip(skip_counts, events)
            dropped = n_before - len(events)
            if dropped and not warned[0]:
                # visible by design: if the subject is NOT
                # truly deterministic-rerun, these drops are silent data
                # loss — log ONCE per restart (per-batch would bury the
                # signal under routine replay noise)
                warned[0] = True
                logger.warning(
                    "prefix-skip active: dropping up to %d re-emitted "
                    "event(s) for deterministic_rerun source %r this "
                    "restart; if this subject does not re-emit its full "
                    "history on restart, set deterministic_rerun=False "
                    "or implement seek()",
                    sum(skip_counts.values()) + dropped,
                    getattr(source, "name", source),
                )
        if events:
            offsets = source.get_offsets() if hasattr(source, "get_offsets") else None
            # the exclusive reader journals everything it read (no ownership
            # filter: no other process sees these events)
            _append(events, offsets)
        return events

    source.static_events = static_events
    if source.is_live():
        if mode == "realtime_replay" and replayed and is_replay_injector:
            # pace the backfill by the recorded wall-clock gaps between
            # journal records (reference: PersistenceMode::RealtimeReplay);
            # live reads resume once the queue drains
            batches = [(w, _retime(ev)) for (w, ev) in (replay_records or [])
                       if ev]
            batches.sort(key=lambda b: (b[0] is not None, b[0] or 0.0))
            if not batches:
                batches = [(None, _retime(list(replayed)))]
            first_wall = next((w for w, _ in batches if w is not None), None)
            queue = [
                (0.0 if (w is None or first_wall is None)
                 else max(0.0, w - first_wall), ev)
                for w, ev in batches
            ]
            started = []  # monotonic clock anchored at the first poll
            source.replay_backfill_pending = True

            def poll_with_replay():
                if queue:
                    if not started:
                        started.append(_time.monotonic())
                    rel, ev = queue[0]
                    if _time.monotonic() - started[0] >= rel:
                        queue.pop(0)
                        if not queue:
                            source.replay_backfill_pending = False
                        return ev
                    return []
                source.replay_backfill_pending = False
                return journaling_poll()
        else:
            pending: list = []
            if replayed and is_replay_injector:
                if mode == "speedrun_replay" and replay_records:
                    # one poll batch per journal record: each record was one
                    # original poll commit, and the streaming loop stamps
                    # each batch with its own logical time — so every
                    # recorded commit replays as a distinct commit
                    # (reference: SpeedrunReplay forwards AdvanceTime
                    # entries; Persisting collapses them)
                    pending = [
                        _retime(ev) for _w, ev in reversed(replay_records) if ev
                    ]
                else:
                    pending = [_retime(list(replayed))]

            def poll_with_replay():
                if pending:
                    return pending.pop()
                return journaling_poll()

        source.poll = poll_with_replay


# the submodules import Backend from here
from . import snapshots as snapmod  # noqa: E402
from .cached_objects import CachedObjectStorage  # noqa: E402
