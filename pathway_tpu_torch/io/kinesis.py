"""AWS Kinesis connector (reference: src/connectors/data_storage/aws/
kinesis.rs, 654 LoC) — signed REST calls (io/_aws.py), no boto3.

`write` PutRecords each batch as JSON payloads; `read` iterates shards with
GetShardIterator/GetRecords polling (LATEST or TRIM_HORIZON start, sequence
numbers persisted as the resume frontier).

The port of ``pathway_tpu/io/kinesis.py``.  A failed poll is logged
once and retried at the next poll; one shard's failed fetch keeps the
records of the others.
"""

from __future__ import annotations

import base64
import json
import logging
import time

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.compat import schema_builder
from ..internals.datasource import DataSource
from ..internals.schema import ColumnDefinition, SchemaMetaclass
from ..internals.table import Table
from ._aws import AwsCredentials, aws_call
from ._utils import coerce_value, make_input_table, plain_scalar
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.kinesis")
_T = "Kinesis_20131202"


class KinesisSource(DataSource):
    """Shard-iterating poller; offsets = per-shard last sequence number."""

    def __init__(self, creds: AwsCredentials, stream_name: str,
                 schema: SchemaMetaclass | None, fmt: str, mode: str,
                 poll_interval_s: float, start_position: str,
                 endpoint: str | None, _http):
        self.creds = creds
        self.stream_name = stream_name
        self.schema = schema
        self.fmt = fmt
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self.start_position = start_position
        self.endpoint = endpoint
        self._http = _http
        self._iterators: dict[str, str] = {}
        self._seqnos: dict[str, str] = {}
        self._last_poll = 0.0
        self._first = True
        self._err = False

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _call(self, op: str, payload: dict) -> dict:
        return aws_call(self.creds, "kinesis", f"{_T}.{op}", payload,
                        endpoint=self.endpoint, _http=self._http)

    def get_offsets(self) -> dict:
        return dict(self._seqnos)

    def seek(self, offsets: dict) -> None:
        self._seqnos = dict(offsets)
        self._iterators = {}

    def _shard_ids(self) -> list[str]:
        resp = self._call("ListShards", {"StreamName": self.stream_name})
        return [s["ShardId"] for s in resp.get("Shards", [])]

    def _iterator(self, shard: str) -> str:
        it = self._iterators.get(shard)
        if it:
            return it
        seq = self._seqnos.get(shard)
        req: dict = {"StreamName": self.stream_name, "ShardId": shard}
        if seq:
            req["ShardIteratorType"] = "AFTER_SEQUENCE_NUMBER"
            req["StartingSequenceNumber"] = seq
        else:
            req["ShardIteratorType"] = self.start_position
        it = self._call("GetShardIterator", req)["ShardIterator"]
        self._iterators[shard] = it
        return it

    def _rows(self) -> list:
        """Per-shard fetch with per-shard commit: one shard's failure drops
        only that shard's batch (its offsets stay put for a clean retry),
        never the records already fetched from healthy shards."""
        from ..internals.value import ref_scalar

        events = []
        schema = self.schema
        pk_cols = (schema.primary_key_columns() or []) if schema else []
        colnames = schema.column_names() if schema else []
        dtypes = schema.dtypes() if schema else {}
        pk_idx = [colnames.index(c) for c in pk_cols]
        for shard in self._shard_ids():
            try:
                resp = self._call(
                    "GetRecords", {"ShardIterator": self._iterator(shard),
                                   "Limit": 1000}
                )
            except Exception as exc:
                # one shard's failure (expired iterator, throttle) must not
                # drop the records already fetched from healthy shards: its
                # iterator is discarded for a clean rebuild from the
                # committed sequence number, and we move on
                self._iterators.pop(shard, None)
                _log.warning("kinesis shard %s fetch failed: %s", shard, exc)
                continue
            shard_events = []
            last_seq = None
            for rec in resp.get("Records", []):
                payload = base64.b64decode(rec["Data"])
                last_seq = rec["SequenceNumber"]
                if self.fmt == "json" and schema is not None:
                    try:
                        d = json.loads(payload)
                    except ValueError:
                        continue
                    row = tuple(
                        coerce_value(d.get(c), dtypes[c]) for c in colnames
                    )
                    if pk_cols:
                        # key off the COERCED row values (pointer_from
                        # parity — identical to io/kafka.py json keying)
                        key = ref_scalar(*[row[i] for i in pk_idx])
                    else:
                        key = ref_scalar("#kinesis", self.stream_name,
                                         shard, rec["SequenceNumber"])
                else:
                    row = (payload if self.fmt == "raw"
                           else payload.decode("utf-8", "replace"),)
                    key = ref_scalar("#kinesis", self.stream_name, shard,
                                     rec["SequenceNumber"])
                shard_events.append((0, key, row, 1))
            # commit this shard only after its whole batch parsed
            self._iterators[shard] = resp.get("NextShardIterator", "")
            if last_seq is not None:
                self._seqnos[shard] = last_seq
            events.extend(shard_events)
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._rows()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.poll_interval_s:
            return []
        self._first = False
        self._last_poll = now
        try:
            rows = self._rows()
            self._err = False
            return rows
        except Exception as exc:
            if not self._err:
                _log.warning("kinesis poll failed: %s", exc)
                self._err = True
            return []


def read(stream_name: str, *, schema: SchemaMetaclass | None = None,
         format: str = "json",  # noqa: A002
         mode: str = "streaming", access_key: str = "", secret_key: str = "",
         region: str = "us-east-1", session_token: str | None = None,
         start_position: str = "TRIM_HORIZON", endpoint: str | None = None,
         poll_interval_s: float = 0.5, **kwargs) -> Table:
    _check_entitlements("kinesis")
    creds = AwsCredentials(access_key, secret_key, region, session_token)
    src = KinesisSource(
        creds, stream_name, schema, format, mode, poll_interval_s,
        start_position, endpoint, kwargs.pop("_http", None),
    )
    if schema is None:
        schema = schema_builder(
            {"data": ColumnDefinition(
                dtype=dt.BYTES if format == "raw" else dt.STR
            )},
            name="KinesisRecord",
        )
    return make_input_table(schema, src, name=f"kinesis:{stream_name}", persistent_id=kwargs.get("persistent_id"))


class _KinesisWriter:
    def __init__(self, creds: AwsCredentials, stream_name: str,
                 partition_column: str | None, endpoint: str | None, _http):
        self.creds = creds
        self.stream_name = stream_name
        self.partition_column = partition_column
        self.endpoint = endpoint
        self._http = _http

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        records = []
        colnames = list(colnames)
        for key, row, diff in updates:
            d = dict(zip(colnames, (plain_scalar(v) for v in unwrap_row(row))))
            d["time"] = time_
            d["diff"] = diff
            pk = (
                str(d.get(self.partition_column))
                if self.partition_column else str(key)
            )
            records.append({
                "Data": base64.b64encode(
                    json.dumps(d).encode()
                ).decode(),
                "PartitionKey": pk,
            })
        aws_call(
            self.creds, "kinesis", f"{_T}.PutRecords",
            {"StreamName": self.stream_name, "Records": records},
            endpoint=self.endpoint, _http=self._http,
        )

    def close(self) -> None:
        pass


def write(table: Table, stream_name: str, *, access_key: str = "",
          secret_key: str = "", region: str = "us-east-1",
          session_token: str | None = None,
          partition_column: str | None = None,
          endpoint: str | None = None, **kwargs) -> None:
    creds = AwsCredentials(access_key, secret_key, region, session_token)
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_KinesisWriter(creds, stream_name, partition_column,
                              endpoint, kwargs.pop("_http", None)),
    )
