"""Kafka connector: the port of ``pathway_tpu/io/kafka.py`` (reference:
io/kafka + src/connectors/data_storage/kafka.rs).

Uses confluent_kafka or kafka-python when installed; ``rdkafka_settings``
may instead carry ``_consumer`` / ``_producer``, any object with the
kafka-python ``poll(timeout_ms)`` / ``assign`` / ``seek`` / ``send`` /
``flush`` surface.  Message formats: json, bson, avro (Confluent wire
format through the schema registry), plaintext, raw and debezium.  A
malformed message is skipped (``KafkaSource.n_skipped`` counts them).

The source's offsets (``get_offsets`` / ``seek``) travel in the
persistence journal.  Three failures the JAX package hides are raised
here: a failed seek of journalled offsets (a restart would re-read or
skip messages), a failed offset read of a consumed message, and a
failed ``close``.
"""

from __future__ import annotations

import collections
import json

from ..internals import dtype as dt
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass, schema_from_columns, ColumnDefinition
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table
from ..internals import parse_graph as pg


# kafka-python's TopicPartition is this namedtuple; an injected consumer
# gets it where kafka-python is not installed
_TopicPartition = collections.namedtuple("TopicPartition",
                                         ["topic", "partition"])


def _get_consumer(rdkafka_settings: dict, topic: str):
    injected = rdkafka_settings.get("_consumer")
    if injected is not None:
        # test seam (same standard as postgres/mysql/clickhouse): any object
        # with the kafka-python poll(timeout_ms)->{tp: [records]} surface
        return ("kafka-python", injected)
    try:
        from confluent_kafka import Consumer  # type: ignore
    except ImportError:
        try:
            from kafka import KafkaConsumer  # type: ignore

            servers = rdkafka_settings.get("bootstrap.servers", "localhost:9092")
            return ("kafka-python", KafkaConsumer(
                topic,
                bootstrap_servers=servers.split(","),
                group_id=rdkafka_settings.get("group.id"),
                auto_offset_reset=rdkafka_settings.get("auto.offset.reset", "earliest"),
            ))
        except ImportError as exc:
            raise ImportError(
                "kafka connector needs confluent_kafka or kafka-python installed"
            ) from exc
    c = Consumer(rdkafka_settings)
    c.subscribe([topic])
    return ("confluent", c)


class KafkaSource(DataSource):
    append_only = True

    def __init__(self, rdkafka_settings: dict, topic: str, format: str,  # noqa: A002
                 schema: SchemaMetaclass, schema_registry=None):
        self.settings = rdkafka_settings
        self.topic = topic
        self.format = format
        self.schema = schema
        self._registry = None
        if schema_registry is not None:
            from ._schema_registry import SchemaRegistryClient

            self._registry = SchemaRegistryClient(schema_registry)
        self._consumer = None
        self._kind = None
        self._n = 0
        # partition -> next offset to consume (the reference's
        # OffsetAntichain; persisted inside journal records so a restart
        # seeks past consumed messages instead of trusting the consumer
        # group's committed offsets, src/connectors/mod.rs:319-388)
        self._offsets: dict[int, int] = {}
        self._seek_to: dict | None = None
        self.n_skipped = 0  # messages that gave no row

    def is_live(self) -> bool:
        return True

    # -- offset frontier (persistence) -------------------------------------
    def get_offsets(self) -> dict:
        return {"__n": self._n, **{f"p{p}": o for p, o in self._offsets.items()}}

    def seek(self, offsets: dict) -> None:
        self._seek_to = dict(offsets)
        self._n = int(offsets.get("__n", 0))
        self._offsets = {
            int(k[1:]): int(v) for k, v in offsets.items() if k.startswith("p")
        }

    def start(self) -> None:
        self._kind, self._consumer = _get_consumer(self.settings, self.topic)
        if self._seek_to is None or not self._offsets:
            return
        # a failed seek raises: falling back to the group's committed
        # positions would re-read or skip messages after a restart
        if self._kind == "confluent":
            from confluent_kafka import TopicPartition

            self._consumer.assign(
                [
                    TopicPartition(self.topic, p, o)
                    for p, o in self._offsets.items()
                ]
            )
            return
        try:
            from kafka import TopicPartition
        except ImportError:
            TopicPartition = _TopicPartition
        parts = [TopicPartition(self.topic, p) for p in self._offsets]
        self._consumer.assign(parts)
        for tp in parts:
            self._consumer.seek(tp, self._offsets[tp.partition])

    def poll(self):
        events = []
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns() or []
        pk_idx = [colnames.index(c) for c in pk]
        msgs: list[bytes] = []
        if self._kind == "confluent":
            while True:
                m = self._consumer.poll(0)
                if m is None:
                    break
                if m.error():
                    continue
                msgs.append(m.value())
                self._offsets[m.partition()] = m.offset() + 1
        else:
            polled = self._consumer.poll(timeout_ms=0)
            for tp, batch in polled.items():
                for r in batch:
                    msgs.append(r.value)
                    self._offsets[getattr(tp, "partition", 0)] = r.offset + 1
        for raw in msgs:
            if self.format == "debezium":
                deltas = parse_debezium(raw, colnames, dtypes, pk)
                if not deltas:
                    self.n_skipped += 1
                events.extend((0, k, r, d) for k, r, d in deltas)
                self._n += 1
                continue
            if self.format in ("json", "bson", "avro"):
                try:
                    if self.format == "bson":
                        from ._bson import decode_document

                        d, _ = decode_document(raw)
                    elif self.format == "avro":
                        from ._schema_registry import decode_avro_message

                        d = decode_avro_message(raw, self._registry)
                    else:
                        d = json.loads(raw)
                except ConnectionError:
                    raise  # registry down is an error, not a bad message
                except Exception:
                    self.n_skipped += 1
                    continue
                row = tuple(coerce_value(d.get(c), dtypes[c]) for c in colnames)
                # keys hash the COERCED pk values (pointer_from parity),
                # read back from the already-coerced row
                key = (
                    ref_scalar(*[row[i] for i in pk_idx])
                    if pk
                    else ref_scalar(self.topic, self._n)
                )
            else:  # plaintext / raw
                v = raw.decode("utf-8", "replace") if self.format == "plaintext" else raw
                row = tuple(
                    coerce_value(v if c == "data" else None, dtypes[c]) for c in colnames
                )
                key = ref_scalar(self.topic, self._n)
            self._n += 1
            events.append((0, key, row, 1))
        return events

    def stop(self):
        if self._consumer is not None:
            consumer, self._consumer = self._consumer, None
            consumer.close()


def parse_debezium(raw: bytes, colnames, dtypes, pk) -> list:
    """Debezium CDC envelope -> Z-set deltas (reference:
    src/connectors/data_format/debezium.rs).

    op c/r -> +after; d -> -before; u -> -before, +after.  A message
    that is not JSON or not an envelope (a tombstone, ``b"null"``) gives
    no delta: the source skips it and counts it.
    """
    try:
        msg = json.loads(raw)
    except Exception:
        return []
    if not isinstance(msg, dict):
        return []  # tombstone (b"null") or non-envelope payload
    payload = msg.get("payload", msg)
    if not isinstance(payload, dict):
        return []
    op = payload.get("op", "c")
    out = []

    pk_idx = [colnames.index(c) for c in pk]

    def ev(record, diff):
        if record is None:
            return
        row = tuple(coerce_value(record.get(c), dtypes[c]) for c in colnames)
        key = (
            ref_scalar(*[row[i] for i in pk_idx])
            if pk
            else ref_scalar("dbz", tuple(sorted(record.items(), key=lambda kv: kv[0])))
        )
        out.append((key, row, diff))

    if op in ("c", "r"):
        ev(payload.get("after"), 1)
    elif op == "d":
        ev(payload.get("before"), -1)
    elif op == "u":
        ev(payload.get("before"), -1)
        ev(payload.get("after"), 1)
    return out


def read(
    rdkafka_settings: dict,
    topic: str | None = None,
    *,
    schema: SchemaMetaclass | None = None,
    format: str = "json",  # noqa: A002
    autocommit_duration_ms: int = 1500,
    topic_names: list[str] | None = None,
    schema_registry_settings=None,
    **kwargs,
) -> Table:
    if topic is None and topic_names:
        topic = topic_names[0]
    if format == "avro" and schema_registry_settings is None:
        raise ValueError(
            "pw.io.kafka.read format='avro' requires schema_registry_settings"
        )
    if schema is None:
        schema = schema_from_columns(
            {"data": ColumnDefinition(dtype=dt.STR if format == "plaintext" else dt.BYTES)},
            name="KafkaSchema",
        )
    source = KafkaSource(rdkafka_settings, topic, format, schema,
                         schema_registry=schema_registry_settings)
    return make_input_table(schema, source, name=f"kafka:{topic}", persistent_id=kwargs.get("persistent_id"))


class KafkaWriter:
    def __init__(self, rdkafka_settings: dict, topic: str, format: str,  # noqa: A002
                 schema_registry=None, table_schema=None):
        self.topic = topic
        self.format = format
        self._registry = None
        self._avro_schema = None
        self._avro_id = None
        if format == "avro":
            from ._schema_registry import SchemaRegistryClient

            if schema_registry is None:
                raise ValueError(
                    "pw.io.kafka.write format='avro' requires "
                    "schema_registry_settings"
                )
            self._registry = SchemaRegistryClient(schema_registry)
            self._table_schema = table_schema
        injected = rdkafka_settings.get("_producer")
        if injected is not None:  # test seam (kafka-python send/flush API)
            self._producer = injected
            self._kind = "kafka-python"
            return
        try:
            from confluent_kafka import Producer  # type: ignore

            self._producer = Producer(rdkafka_settings)
            self._kind = "confluent"
        except ImportError:
            from kafka import KafkaProducer  # type: ignore

            servers = rdkafka_settings.get("bootstrap.servers", "localhost:9092")
            self._producer = KafkaProducer(bootstrap_servers=servers.split(","))
            self._kind = "kafka-python"

    def write_batch(self, time: int, colnames: list[str], updates: list) -> None:
        from ..engine.types import unwrap_row
        from ._utils import _jsonable

        if self.format == "avro" and self._avro_schema is None:
            from ._schema_registry import avro_schema_for

            self._avro_schema = avro_schema_for(self._table_schema)
            self._avro_schema["fields"] += [
                {"name": "time", "type": "long"},
                {"name": "diff", "type": "long"},
            ]
            self._avro_id = self._registry.register(
                f"{self.topic}-value", self._avro_schema)
        for key, row, diff in updates:
            if self.format == "avro":
                from ._schema_registry import encode_avro_message

                # raw engine values: bytes must reach the codec unmangled
                # (coercion to the registered schema happens inside)
                obj = dict(zip(colnames, unwrap_row(row)))
                obj["time"] = time
                obj["diff"] = diff
                payload = encode_avro_message(
                    obj, self._avro_schema, self._avro_id)
            else:
                obj = dict(zip(colnames,
                               [_jsonable(v) for v in unwrap_row(row)]))
                obj["time"] = time
                obj["diff"] = diff
                payload = json.dumps(obj, default=str).encode()
            if self._kind == "confluent":
                self._producer.produce(self.topic, payload)
            else:
                self._producer.send(self.topic, payload)
        self._producer.flush()

    def close(self):
        pass


def write(table: Table, rdkafka_settings: dict, topic_name: str, *,
          format: str = "json",  # noqa: A002
          schema_registry_settings=None, **kwargs) -> None:
    writer = KafkaWriter(rdkafka_settings, topic_name, format,
                         schema_registry=schema_registry_settings,
                         table_schema=table.schema)
    pg.new_output_node("output", [table], colnames=table.column_names(), writer=writer)
