"""S3 connector (reference: python/pathway/io/s3/__init__.py +
src/connectors/scanner/ S3 side).

Object listing/reading goes through one client seam
(``AwsS3Settings.make_client``): boto3 when installed, else the client
passed as ``AwsS3Settings(_client=...)``.  The scanner mirrors the
filesystem source: per-object row offsets (exactly-once resume) and
append-only streaming; a JSON line that does not parse is skipped.

The port of ``pathway_tpu/io/s3.py``.  In a cluster each process scans
the objects whose key ``partition_owner`` gives it.
``persistence.Backend.s3`` keeps its journals through the same client.
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json
import time
from typing import Any

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.datasource import DataSource
from ._utils import events_from_dicts, make_input_table, partition_owner


class AwsS3Settings:
    """Reference parity: pw.io.s3.AwsS3Settings."""

    def __init__(self, *, bucket_name: str | None = None,
                 access_key: str | None = None,
                 secret_access_key: str | None = None,
                 region: str | None = None,
                 endpoint: str | None = None,
                 with_path_style: bool = False,
                 session_token: str | None = None,
                 _client: Any = None):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style
        self.session_token = session_token
        self._client = _client  # injected fake for tests

    def make_client(self):
        if self._client is not None:
            return self._client
        try:
            import boto3
            from botocore.config import Config as _BotoConfig
        except ImportError as exc:
            raise ImportError(
                "pw.io.s3 requires boto3 (or an injected client for tests)"
            ) from exc
        cfg = None
        if self.with_path_style:
            # MinIO-style deployments have no wildcard DNS for
            # virtual-hosted addressing
            cfg = _BotoConfig(s3={"addressing_style": "path"})
        return boto3.client(
            "s3",
            aws_access_key_id=self.access_key,
            aws_secret_access_key=self.secret_access_key,
            aws_session_token=self.session_token,
            region_name=self.region,
            endpoint_url=self.endpoint,
            config=cfg,
        )


class DigitalOceanS3Settings(AwsS3Settings):
    """Reference parity (io/s3/__init__.py:23)."""


class WasabiS3Settings(AwsS3Settings):
    """Reference parity (io/s3/__init__.py:58)."""


def _parse_object(body: bytes, fmt: str, colnames) -> list[dict]:
    if fmt == "plaintext":
        return [
            {"data": ln}
            for ln in body.decode("utf-8", "replace").splitlines()
            if ln
        ]
    if fmt == "binary":
        return [{"data": body}]
    if fmt == "json" or fmt == "jsonlines":
        out = []
        for ln in body.decode("utf-8", "replace").splitlines():
            ln = ln.strip()
            if not ln:
                continue
            try:
                out.append(json.loads(ln))
            except Exception:
                continue
        return out
    if fmt == "csv":
        text = body.decode("utf-8", "replace")
        return list(_csv.DictReader(_io.StringIO(text)))
    raise ValueError(f"unsupported s3 format {fmt!r}")


class S3ScannerSource(DataSource):
    """Append-only object scanner with per-object row offsets."""

    append_only = True

    def __init__(self, settings: AwsS3Settings, bucket: str, prefix: str,
                 fmt: str, schema: SchemaMetaclass,
                 poll_interval_s: float = 1.0, live: bool = True):
        self.settings = settings
        self.bucket = bucket
        self.prefix = prefix
        self.format = fmt
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self._live = live
        self._client = None
        self._etags: dict[str, str] = {}
        self._progress: dict[str, int] = {}  # object key -> rows emitted
        self._last_poll = 0.0

    def is_live(self) -> bool:
        return self._live

    # -- persistence offsets ----------------------------------------------
    def get_offsets(self) -> dict:
        return dict(self._progress)

    def seek(self, offsets: dict) -> None:
        self._progress = dict(offsets)
        self._etags = {}

    # -- cluster partitioning ----------------------------------------------
    _partition: tuple[int, int] | None = None

    def set_partition(self, pid: int, nprocs: int) -> None:
        self._partition = (pid, nprocs)

    def _ensure_client(self):
        if self._client is None:
            self._client = self.settings.make_client()
        return self._client

    def _scan(self) -> list:
        client = self._ensure_client()
        events = []
        entries = list_objects_paginated(client, self.bucket, self.prefix)
        if self._partition is not None:
            pid, n = self._partition
            entries = [(k, e) for k, e in entries
                       if partition_owner(k, n) == pid]
        for key, listed_etag in entries:
            # the listing already carries ETags: unchanged objects skip the
            # GetObject round-trip entirely
            if (
                listed_etag is not None
                and self._etags.get(key) == listed_etag
                and key in self._progress
            ):
                continue
            try:
                resp = client.get_object(Bucket=self.bucket, Key=key)
                etag = resp.get("ETag", listed_etag or "")
                if self._etags.get(key) == etag and key in self._progress:
                    continue
                body = resp["Body"].read()
            except Exception:
                if not self._live:
                    # static mode has no next poll: a persistent read
                    # failure must surface, not silently drop rows
                    raise
                continue  # streaming: transient, retried next poll
            self._etags[key] = etag
            dicts = _parse_object(body, self.format, self.schema.column_names())
            start = self._progress.get(key, 0)
            if len(dicts) <= start:
                continue
            events.extend(
                events_from_dicts(
                    dicts, self.schema, seed=f"s3://{self.bucket}/{key}",
                    start_index=start,
                )
            )
            self._progress[key] = len(dicts)
        return events

    def static_events(self) -> list:
        return self._scan()

    def poll(self):
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval_s:
            return []
        self._last_poll = now
        return self._scan()


def _split_path(path: str) -> tuple[str, str]:
    p = path
    if p.startswith("s3://"):
        p = p[5:]
    bucket, _, prefix = p.partition("/")
    return bucket, prefix


def resolve_path(path: str, settings: "AwsS3Settings") -> tuple[str, str]:
    """(bucket, prefix).  With bucket_name in the settings and a relative
    path, the WHOLE path is the in-bucket prefix (reference semantics);
    s3:// URLs carry their own bucket component."""
    if path.startswith("s3://"):
        # an explicit s3:// URL names its own bucket
        return _split_path(path)
    if settings.bucket_name:
        return settings.bucket_name, path
    return _split_path(path)


def list_objects_paginated(client, bucket: str, prefix: str) -> list[tuple[str, str | None]]:
    """Paginated ListObjectsV2 -> sorted [(key, etag)] (shared by the
    scanner and the persistence backend)."""
    out: list[tuple[str, str | None]] = []
    token = None
    while True:
        kw = {"Bucket": bucket, "Prefix": prefix}
        if token:
            kw["ContinuationToken"] = token
        resp = client.list_objects_v2(**kw)
        out.extend(
            (o["Key"], o.get("ETag")) for o in resp.get("Contents", []) or []
        )
        if not resp.get("IsTruncated"):
            break
        token = resp.get("NextContinuationToken")
    return sorted(out)


def list_keys_paginated(client, bucket: str, prefix: str) -> list[str]:
    return [k for k, _e in list_objects_paginated(client, bucket, prefix)]


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "csv",  # noqa: A002
    schema: SchemaMetaclass | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int = 1500,
    name: str | None = None,
    **kwargs,
) -> Table:
    """Reads objects under an S3 prefix (reference: io/s3/__init__.py:95)."""
    settings = aws_s3_settings or AwsS3Settings()
    bucket, prefix = resolve_path(path, settings)
    if schema is None:
        from ..internals import dtype as dt_
        from ..internals.compat import schema_builder
        from ..internals.schema import ColumnDefinition

        kind = dt_.BYTES if format == "binary" else dt_.STR
        schema = schema_builder(
            {"data": ColumnDefinition(dtype=kind)}, name="S3Plain"
        )
    src = S3ScannerSource(
        settings, bucket, prefix, format, schema,
        live=(mode == "streaming"),
    )
    return make_input_table(schema, src, name=name or f"s3:{bucket}/{prefix}", persistent_id=kwargs.get("persistent_id"))


def read_from_digital_ocean(path, do_s3_settings, **kw) -> Table:
    return read(path, aws_s3_settings=do_s3_settings, **kw)


def read_from_wasabi(path, wasabi_s3_settings, **kw) -> Table:
    return read(path, aws_s3_settings=wasabi_s3_settings, **kw)


class _S3Writer:
    """Sink: one object per committed batch (jsonlines payload)."""

    def __init__(self, settings: AwsS3Settings, bucket: str, prefix: str):
        self.settings = settings
        self.bucket = bucket
        self.prefix = prefix.rstrip("/")
        self._client = None
        self._seq = 0

    def write_batch(self, time_, colnames, updates) -> None:
        from ..engine.types import unwrap_row

        if not updates:
            return
        if self._client is None:
            self._client = self.settings.make_client()
        lines = []
        for key, row, diff in updates:
            obj = dict(zip(colnames, unwrap_row(row)))
            obj["time"] = time_
            obj["diff"] = diff
            lines.append(json.dumps(obj, default=str))
        body = ("\n".join(lines) + "\n").encode()
        key = f"{self.prefix}/batch_{time_}_{self._seq:08d}.jsonl"
        self._seq += 1
        self._client.put_object(Bucket=self.bucket, Key=key, Body=body)

    def close(self) -> None:
        pass


def write(table: Table, path: str, *,
          aws_s3_settings: AwsS3Settings | None = None, **kwargs) -> None:
    settings = aws_s3_settings or AwsS3Settings()
    bucket, prefix = resolve_path(path, settings)
    from ._utils import add_output_node

    add_output_node(table, _S3Writer(settings, bucket, prefix))
