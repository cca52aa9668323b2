"""NATS connector speaking the wire protocol natively (reference:
src/connectors/data_storage/nats.rs).

The NATS client protocol is line-oriented text (INFO/CONNECT/PUB/SUB/MSG/
PING/PONG — https://docs.nats.io/reference/reference-protocols/nats-protocol)
so no client library is needed: `read` SUBs a subject and streams MSG
payloads as rows; `write` PUBs each row as JSON.  Payload format "json"
parses into schema columns; "plaintext"/"raw" delivers one `data` column.

The port of ``pathway_tpu/io/nats.py``: the same frames on the wire.
"""

from __future__ import annotations

import json
import socket

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import SubjectDataSource
from ..internals.schema import ColumnDefinition, SchemaMetaclass
from ..internals.table import Table
from ..internals.compat import schema_builder
from ._utils import coerce_value, make_input_table, plain_scalar


class _NatsConn:
    """Minimal protocol client over one TCP socket."""

    def __init__(self, uri: str, connect_timeout_s: float = 10.0):
        # nats://host:port
        hostport = uri.split("://", 1)[-1]
        host, _, port = hostport.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or 4222)), timeout=connect_timeout_s
        )
        self._buf = b""
        info = self._read_line()  # INFO {...}
        if not info.startswith(b"INFO"):
            raise ConnectionError(f"not a NATS server: {info[:40]!r}")
        self._send(
            b'CONNECT {"verbose":false,"pedantic":false,'
            b'"name":"pathway-tpu","lang":"python","version":"1"}\r\n'
        )

    def _send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("NATS connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("NATS connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def publish(self, subject: str, payload: bytes) -> None:
        self._send(
            f"PUB {subject} {len(payload)}\r\n".encode() + payload + b"\r\n"
        )

    def subscribe(self, subject: str, sid: int = 1) -> None:
        self._send(f"SUB {subject} {sid}\r\n".encode())

    def next_msg(self):
        """Returns (subject, payload) or None on PING (answered inline)."""
        line = self._read_line()
        if line.startswith(b"PING"):
            self._send(b"PONG\r\n")
            return None
        if line.startswith(b"MSG"):
            parts = line.decode().split(" ")
            nbytes = int(parts[-1])
            payload = self._read_exact(nbytes)
            self._read_exact(2)  # trailing \r\n
            return parts[1], payload
        return None  # +OK / -ERR / INFO updates

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _NatsSubject:
    def __init__(self, uri: str, topic: str, fmt: str,
                 schema: SchemaMetaclass | None):
        self.uri = uri
        self.topic = topic
        self.fmt = fmt
        self.schema = schema
        self._stop = False

    def _run(self, handle) -> None:
        conn = _NatsConn(self.uri)
        conn.subscribe(self.topic)
        conn.sock.settimeout(0.3)
        try:
            while not self._stop:
                try:
                    msg = conn.next_msg()
                except socket.timeout:
                    continue
                except ConnectionError:
                    break
                if msg is None:
                    continue
                _subject, payload = msg
                if self.fmt == "json" and self.schema is not None:
                    try:
                        d = json.loads(payload)
                    except ValueError:
                        continue
                    dtypes = self.schema.dtypes()
                    row = tuple(
                        coerce_value(d.get(c), dtypes[c])
                        for c in self.schema.column_names()
                    )
                else:
                    row = (payload if self.fmt == "raw"
                           else payload.decode("utf-8", "replace"),)
                handle.push(row, 1, None)
        finally:
            conn.close()
            handle.close()

    def on_stop(self) -> None:
        self._stop = True


def read(uri: str, *, topic: str, schema: SchemaMetaclass | None = None,
         format: str = "json",  # noqa: A002
         **kwargs) -> Table:
    if format == "json" and schema is None:
        raise ValueError("pw.io.nats.read with format='json' needs a schema")
    subject = _NatsSubject(uri, topic, format, schema)
    if schema is None:
        schema = schema_builder(
            {"data": ColumnDefinition(
                dtype=dt.BYTES if format == "raw" else dt.STR
            )},
            name="NatsRecord",
        )
    colnames = schema.column_names()
    source = SubjectDataSource(subject, colnames, None, append_only=True)
    return make_input_table(schema, source, name=f"nats:{topic}", persistent_id=kwargs.get("persistent_id"))


class _NatsWriter:
    def __init__(self, uri: str, topic: str):
        self.uri = uri
        self.topic = topic
        self._conn: _NatsConn | None = None

    def write_batch(self, time_, colnames, updates) -> None:
        if self._conn is None:
            self._conn = _NatsConn(self.uri)
        for _key, row, diff in updates:
            d = dict(zip(colnames, (plain_scalar(v) for v in unwrap_row(row))))
            d["diff"] = diff
            d["time"] = time_
            self._conn.publish(self.topic, json.dumps(d).encode())

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


def write(table: Table, uri: str, *, topic: str, **kwargs) -> None:
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_NatsWriter(uri, topic),
    )
