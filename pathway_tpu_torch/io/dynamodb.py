"""AWS DynamoDB sink (reference: src/connectors/data_storage/dynamodb.rs)
— signed REST calls (io/_aws.py), no boto3.

`write` maintains the live snapshot keyed on the partition (and optional
sort) key: diff>0 PutItem, diff<0 DeleteItem.  Values map to the DynamoDB
attribute-value encoding (S/N/BOOL/NULL/B).

The port of ``pathway_tpu/io/dynamodb.py``.
"""

from __future__ import annotations

import base64
from typing import Any, Iterable

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.table import Table
from ._aws import AwsCredentials, aws_call
from ..internals.config import _check_entitlements

_T = "DynamoDB_20120810"


def _attr(v: Any) -> dict:
    if v is None:
        return {"NULL": True}
    if isinstance(v, bool):
        return {"BOOL": v}
    if isinstance(v, (int, float)):
        return {"N": repr(v) if isinstance(v, float) else str(v)}
    if isinstance(v, bytes):
        return {"B": base64.b64encode(v).decode()}
    return {"S": str(v)}


class _DynamoWriter:
    def __init__(self, creds: AwsCredentials, table_name: str,
                 partition_key: str, sort_key: str | None,
                 endpoint: str | None, _http):
        self.creds = creds
        self.table_name = table_name
        self.partition_key = partition_key
        self.sort_key = sort_key
        self.endpoint = endpoint
        self._http = _http

    def _call(self, op: str, payload: dict) -> dict:
        return aws_call(self.creds, "dynamodb", f"{_T}.{op}", payload,
                        endpoint=self.endpoint, _http=self._http)

    def write_batch(self, time_, colnames, updates) -> None:
        colnames = list(colnames)
        # deletes first: a consolidated upsert arrives as (+new, -old) in
        # arbitrary order for the same partition key; put-then-delete would
        # erase the fresh item
        for phase in (-1, 1):
            for _key, row, diff in updates:
                if (diff > 0) != (phase > 0):
                    continue
                vals = unwrap_row(row)
                d = dict(zip(colnames, vals))
                if diff > 0:
                    self._call("PutItem", {
                        "TableName": self.table_name,
                        "Item": {c: _attr(v) for c, v in d.items()},
                    })
                else:
                    key = {self.partition_key: _attr(d[self.partition_key])}
                    if self.sort_key:
                        key[self.sort_key] = _attr(d[self.sort_key])
                    self._call("DeleteItem", {
                        "TableName": self.table_name, "Key": key,
                    })

    def close(self) -> None:
        pass


def write(table: Table, table_name: str, partition_key: Any,
          sort_key: Any | None = None, *, access_key: str = "",
          secret_key: str = "", region: str = "us-east-1",
          session_token: str | None = None, endpoint: str | None = None,
          **kwargs) -> None:
    """Reference: pw.io.dynamodb.write."""
    _check_entitlements("dynamodb")
    creds = AwsCredentials(access_key, secret_key, region, session_token)
    pk = getattr(partition_key, "_name", partition_key)
    sk = getattr(sort_key, "_name", sort_key) if sort_key is not None else None
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_DynamoWriter(creds, table_name, pk, sk, endpoint,
                             kwargs.pop("_http", None)),
    )
