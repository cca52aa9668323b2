"""MQTT connector speaking MQTT 3.1.1 natively (reference:
src/connectors/data_storage/mqtt.rs).

The 3.1.1 control-packet format (OASIS spec) is small enough to implement
directly: CONNECT/CONNACK, PUBLISH (QoS 0), SUBSCRIBE/SUBACK, PINGREQ.
`read` subscribes a topic filter and streams PUBLISH payloads as rows;
`write` publishes each row as JSON.

The port of ``pathway_tpu/io/mqtt.py``: the same packets on the wire.
"""

from __future__ import annotations

import json
import socket

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.compat import schema_builder
from ..internals.datasource import SubjectDataSource
from ..internals.schema import ColumnDefinition, SchemaMetaclass
from ..internals.table import Table
from ._utils import coerce_value, make_input_table, plain_scalar


def _encode_len(n: int) -> bytes:
    """MQTT variable-length remaining-length encoding."""
    out = b""
    while True:
        b = n % 128
        n //= 128
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _utf8(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big") + b


class _MqttConn:
    def __init__(self, uri: str, client_id: str = "pathway-tpu",
                 connect_timeout_s: float = 10.0):
        hostport = uri.split("://", 1)[-1]
        host, _, port = hostport.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or 1883)), timeout=connect_timeout_s
        )
        self._buf = b""
        var = (
            _utf8("MQTT") + bytes([4])       # protocol level 3.1.1
            + bytes([0x02])                  # clean session
            + (60).to_bytes(2, "big")        # keepalive
            + _utf8(client_id)
        )
        self.sock.sendall(bytes([0x10]) + _encode_len(len(var)) + var)
        ptype, payload = self._read_packet()
        if ptype != 0x20 or payload[1] != 0:
            raise ConnectionError(f"MQTT CONNACK refused: {payload!r}")

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("MQTT connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_packet(self) -> tuple[int, bytes]:
        head = self._read_exact(1)[0]
        # remaining length varint
        mul, n = 1, 0
        while True:
            b = self._read_exact(1)[0]
            n += (b & 0x7F) * mul
            if not b & 0x80:
                break
            mul *= 128
        return head & 0xF0, self._read_exact(n)

    def publish(self, topic: str, payload: bytes) -> None:
        var = _utf8(topic) + payload  # QoS 0: no packet id
        self.sock.sendall(bytes([0x30]) + _encode_len(len(var)) + var)

    def subscribe(self, topic_filter: str) -> None:
        var = (1).to_bytes(2, "big") + _utf8(topic_filter) + bytes([0])
        self.sock.sendall(bytes([0x82]) + _encode_len(len(var)) + var)
        ptype, _payload = self._read_packet()
        if ptype != 0x90:
            raise ConnectionError("MQTT SUBACK missing")

    def next_publish(self):
        """Returns (topic, payload) of the next PUBLISH packet."""
        while True:
            ptype, payload = self._read_packet()
            if ptype == 0x30:
                tlen = int.from_bytes(payload[:2], "big")
                topic = payload[2 : 2 + tlen].decode()
                return topic, payload[2 + tlen :]
            if ptype == 0xC0:  # PINGREQ from broker (unusual) -> PINGRESP
                self.sock.sendall(bytes([0xD0, 0]))

    def close(self) -> None:
        try:
            self.sock.sendall(bytes([0xE0, 0]))  # DISCONNECT
            self.sock.close()
        except OSError:
            pass


class _MqttSubject:
    def __init__(self, uri: str, topic: str, fmt: str,
                 schema: SchemaMetaclass | None):
        self.uri = uri
        self.topic = topic
        self.fmt = fmt
        self.schema = schema
        self._stop = False

    def _run(self, handle) -> None:
        conn = _MqttConn(self.uri)
        conn.subscribe(self.topic)
        conn.sock.settimeout(0.3)
        try:
            while not self._stop:
                try:
                    topic, payload = conn.next_publish()
                except socket.timeout:
                    continue
                except ConnectionError:
                    break
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
        raise ValueError("pw.io.mqtt.read with format='json' needs a schema")
    subject = _MqttSubject(uri, topic, format, schema)
    if schema is None:
        schema = schema_builder(
            {"data": ColumnDefinition(
                dtype=dt.BYTES if format == "raw" else dt.STR
            )},
            name="MqttRecord",
        )
    source = SubjectDataSource(
        subject, schema.column_names(), None, append_only=True
    )
    return make_input_table(schema, source, name=f"mqtt:{topic}", persistent_id=kwargs.get("persistent_id"))


class _MqttWriter:
    def __init__(self, uri: str, topic: str):
        self.uri = uri
        self.topic = topic
        self._conn: _MqttConn | None = None

    def write_batch(self, time_, colnames, updates) -> None:
        if self._conn is None:
            self._conn = _MqttConn(self.uri, client_id="pathway-tpu-w")
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
        writer=_MqttWriter(uri, topic),
    )
