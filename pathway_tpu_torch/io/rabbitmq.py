"""RabbitMQ connector speaking AMQP 0.9.1 natively (reference:
src/connectors/data_storage/rabbitmq).

The 0.9.1 frame format is implemented directly (no pika): protocol header,
Connection.Start/Tune/Open, Channel.Open, Queue.Declare, Basic.Publish
(method + content header + body frames) and Basic.Consume/Deliver.
`read` consumes a queue into rows; `write` publishes each row as JSON.

The port of ``pathway_tpu/io/rabbitmq.py``: the same frames on the
wire.
"""

from __future__ import annotations

import json
import socket
import struct

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.compat import schema_builder
from ..internals.datasource import SubjectDataSource
from ..internals.schema import ColumnDefinition, SchemaMetaclass
from ..internals.table import Table
from ._utils import coerce_value, make_input_table, plain_scalar
from ..internals.config import _check_entitlements

_FRAME_METHOD, _FRAME_HEADER, _FRAME_BODY, _FRAME_HEARTBEAT = 1, 2, 3, 8
_FRAME_END = 0xCE


def _short_str(s: str) -> bytes:
    b = s.encode()
    return bytes([len(b)]) + b


def _long_str(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def _table(d: dict) -> bytes:
    out = b""
    for k, v in d.items():
        out += _short_str(k)
        if isinstance(v, str):
            out += b"S" + _long_str(v.encode())
        elif isinstance(v, bool):
            out += b"t" + bytes([1 if v else 0])
        elif isinstance(v, int):
            out += b"I" + struct.pack(">i", v)
    return struct.pack(">I", len(out)) + out


class _AmqpConn:
    def __init__(self, uri: str, connect_timeout_s: float = 10.0):
        # amqp://[user:pass@]host[:port][/vhost]
        rest = uri.split("://", 1)[-1]
        auth, _, hostpart = rest.rpartition("@")
        user, _, password = (auth or "guest:guest").partition(":")
        hostport, _, vhost = hostpart.partition("/")
        host, _, port = hostport.partition(":")
        self.vhost = vhost or "/"
        self.sock = socket.create_connection(
            (host, int(port or 5672)), timeout=connect_timeout_s
        )
        self._buf = b""
        self.sock.sendall(b"AMQP\x00\x00\x09\x01")
        # Connection.Start -> Start-Ok (PLAIN auth)
        cls, mid, _payload = self._expect_method(10, 10)
        sasl = b"\x00" + user.encode() + b"\x00" + (password or "guest").encode()
        self._send_method(0, 10, 11, _table({"product": "pathway-tpu"})
                          + _short_str("PLAIN") + _long_str(sasl)
                          + _short_str("en_US"))
        # Connection.Tune -> Tune-Ok -> Open
        cls, mid, payload = self._expect_method(10, 30)
        channel_max, frame_max, heartbeat = struct.unpack_from(">HIH", payload)
        self.frame_max = frame_max or 131072
        self._send_method(0, 10, 31,
                          struct.pack(">HIH", channel_max or 1,
                                      self.frame_max, 0))
        self._send_method(0, 10, 40, _short_str(self.vhost) + b"\x00\x00")
        self._expect_method(10, 41)  # Open-Ok
        # Channel.Open
        self._send_method(1, 20, 10, b"\x00")
        self._expect_method(20, 11)

    # -- framing -----------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("AMQP connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_frame(self) -> tuple[int, int, bytes]:
        """Atomic with respect to socket timeouts: a timeout mid-frame
        restores the consumed bytes, so the next call re-parses from the
        frame boundary instead of desyncing the stream."""
        consumed = b""
        try:
            head = self._read_exact(7)
            consumed += head
            ftype, channel, size = struct.unpack(">BHI", head)
            payload = self._read_exact(size)
            consumed += payload
            end = self._read_exact(1)[0]
        except socket.timeout:
            self._buf = consumed + self._buf
            raise
        if end != _FRAME_END:
            raise ConnectionError("AMQP framing error")
        if ftype == _FRAME_HEARTBEAT:
            self.sock.sendall(
                struct.pack(">BHI", _FRAME_HEARTBEAT, 0, 0)
                + bytes([_FRAME_END])
            )
        return ftype, channel, payload

    def _send_frame(self, ftype: int, channel: int, payload: bytes) -> None:
        self.sock.sendall(
            struct.pack(">BHI", ftype, channel, len(payload)) + payload
            + bytes([_FRAME_END])
        )

    def _send_method(self, channel: int, cls: int, mid: int,
                     args: bytes) -> None:
        self._send_frame(_FRAME_METHOD, channel,
                         struct.pack(">HH", cls, mid) + args)

    def _expect_method(self, cls: int, mid: int) -> tuple[int, int, bytes]:
        while True:
            ftype, _ch, payload = self.read_frame()
            if ftype != _FRAME_METHOD:
                continue
            c, m = struct.unpack_from(">HH", payload)
            if (c, m) == (cls, mid):
                return c, m, payload[4:]
            if c == 10 and m == 50 or c == 20 and m == 40:  # Close
                raise ConnectionError(f"AMQP close: {payload[4:40]!r}")

    # -- operations --------------------------------------------------------
    def queue_declare(self, queue: str) -> None:
        args = (b"\x00\x00" + _short_str(queue)
                + bytes([0b00000010])  # durable
                + struct.pack(">I", 0))
        self._send_method(1, 50, 10, args)
        self._expect_method(50, 11)

    def publish(self, routing_key: str, body: bytes,
                exchange: str = "") -> None:
        self._send_method(
            1, 60, 40,
            b"\x00\x00" + _short_str(exchange) + _short_str(routing_key)
            + b"\x00",
        )
        header = (struct.pack(">HHQ", 60, 0, len(body))
                  + struct.pack(">H", 0))  # no properties
        self._send_frame(_FRAME_HEADER, 1, header)
        # content splits at the Tune-negotiated frame_max (minus the 8-byte
        # frame envelope) — one oversized frame is a protocol error
        chunk = max(self.frame_max - 8, 1)
        for i in range(0, len(body), chunk):
            self._send_frame(_FRAME_BODY, 1, body[i : i + chunk])

    def consume(self, queue: str) -> None:
        args = (b"\x00\x00" + _short_str(queue) + _short_str("pwtag")
                + bytes([0b00000010])  # no-ack
                + struct.pack(">I", 0))
        self._send_method(1, 60, 20, args)
        self._expect_method(60, 21)

    def next_delivery(self) -> bytes | None:
        """Body of the next Basic.Deliver, or None for non-delivery."""
        ftype, _ch, payload = self.read_frame()
        if ftype != _FRAME_METHOD:
            return None
        c, m = struct.unpack_from(">HH", payload)
        if (c, m) != (60, 60):  # Basic.Deliver
            return None
        # the content header + body frames follow the Deliver immediately;
        # block generously for them (a short poll timeout here would drop
        # the message after its method frame was consumed)
        prev_timeout = self.sock.gettimeout()
        self.sock.settimeout(30.0)
        try:
            ftype, _ch, hpayload = self.read_frame()
            (size,) = struct.unpack_from(">Q", hpayload, 4)
            body = b""
            while len(body) < size:
                ftype, _ch, bpayload = self.read_frame()
                if ftype == _FRAME_BODY:
                    body += bpayload
        finally:
            self.sock.settimeout(prev_timeout)
        return body

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _RabbitSubject:
    def __init__(self, uri: str, queue: str, fmt: str,
                 schema: SchemaMetaclass | None):
        self.uri = uri
        self.queue = queue
        self.fmt = fmt
        self.schema = schema
        self._stop = False

    def _run(self, handle) -> None:
        conn = _AmqpConn(self.uri)
        conn.queue_declare(self.queue)
        conn.consume(self.queue)
        conn.sock.settimeout(0.3)
        try:
            while not self._stop:
                try:
                    body = conn.next_delivery()
                except socket.timeout:
                    continue
                except ConnectionError:
                    break
                if body is None:
                    continue
                if self.fmt == "json" and self.schema is not None:
                    try:
                        d = json.loads(body)
                    except ValueError:
                        continue
                    dtypes = self.schema.dtypes()
                    row = tuple(
                        coerce_value(d.get(c), dtypes[c])
                        for c in self.schema.column_names()
                    )
                else:
                    row = (body if self.fmt == "raw"
                           else body.decode("utf-8", "replace"),)
                handle.push(row, 1, None)
        finally:
            conn.close()
            handle.close()

    def on_stop(self) -> None:
        self._stop = True


def read(uri: str, *, queue_name: str, schema: SchemaMetaclass | None = None,
         format: str = "json",  # noqa: A002
         **kwargs) -> Table:
    _check_entitlements("rabbitmq")
    if format == "json" and schema is None:
        raise ValueError(
            "pw.io.rabbitmq.read with format='json' needs a schema"
        )
    subject = _RabbitSubject(uri, queue_name, format, schema)
    if schema is None:
        schema = schema_builder(
            {"data": ColumnDefinition(
                dtype=dt.BYTES if format == "raw" else dt.STR
            )},
            name="RabbitRecord",
        )
    source = SubjectDataSource(
        subject, schema.column_names(), None, append_only=True
    )
    return make_input_table(schema, source, name=f"rabbitmq:{queue_name}", persistent_id=kwargs.get("persistent_id"))


class _RabbitWriter:
    def __init__(self, uri: str, routing_key: str, exchange: str):
        self.uri = uri
        self.routing_key = routing_key
        self.exchange = exchange
        self._conn: _AmqpConn | None = None

    def write_batch(self, time_, colnames, updates) -> None:
        if self._conn is None:
            self._conn = _AmqpConn(self.uri)
            if not self.exchange:
                self._conn.queue_declare(self.routing_key)
        for _key, row, diff in updates:
            d = dict(zip(colnames,
                         (plain_scalar(v) for v in unwrap_row(row))))
            d["diff"] = diff
            d["time"] = time_
            self._conn.publish(self.routing_key, json.dumps(d).encode(),
                               self.exchange)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


def write(table: Table, uri: str, *, routing_key: str,
          exchange_name: str = "", **kwargs) -> None:
    _check_entitlements("rabbitmq")
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_RabbitWriter(uri, routing_key, exchange_name),
    )
