"""The port's Kafka connector held to the JAX package's: the json, bson,
avro (through the schema registry), plaintext, raw and debezium formats
read the same rows under the same keys from the same messages; the
writers send the same bytes; the offsets survive ``get_offsets`` /
``seek`` (``tests/test_snapshots.py:137``) and keys hash the coerced
primary key (``:186``).  Where the JAX package hides a failure the port
raises: a failed seek of journalled offsets (``kafka.py:107``), a failed
offset read (``:127``) and a failed close (``:181``).  Messages are drawn
from a seed with numpy; consumers are ``chip_smoke.KafkaLog``'s, with
the kafka-python surface of the ``_consumer`` seam.
"""

import json
import sys
import types

import numpy as np
import pytest

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.internals.value import ref_scalar as jref
from pathway_tpu.io import _schema_registry as jreg
from pathway_tpu.io import kafka as jkafka
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.value import ref_scalar as tref
from pathway_tpu_torch.io import _schema_registry as treg
from pathway_tpu_torch.io import kafka as tkafka

from .test_torch_io_codecs import _FakeRegistry

PKGS = {"jax": (jpw, jpg, jkafka, jreg), "torch": (tpw, tpg, tkafka, treg)}


def _schema(pw, pk: bool = True):
    if pk:
        class S(pw.Schema):
            name: str = pw.column_definition(primary_key=True)
            age: int
    else:
        class S(pw.Schema):
            name: str
            age: int
    return S


def _people(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"name": f"p{int(i)}", "age": int(a)} for i, a in zip(
        rng.permutation(n), rng.integers(0, 100, n))]


def _rows(pkg: str, build, **run_kw) -> list:
    """``build(pw)``'s table in ``pkg`` through ``pw.run`` (the port's on
    the CPU): its updates as (key, row, is_addition), in order."""
    pw, pg = PKGS[pkg][:2]
    pg.G.clear()
    out = []
    try:
        t = build(pw)
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                        out.append((key, tuple(row.values()), is_addition)))
        kw = dict(timeout_s=10.0, idle_stop_s=0.5, autocommit_duration_ms=20,
                  monitoring_level=pw.MonitoringLevel.NONE, **run_kw)
        if pkg == "torch":
            kw["device"] = "cpu"
        pw.run(**kw)
    finally:
        pg.G.clear()
    return out


def _log(payloads, topic="t") -> chip_smoke.KafkaLog:
    log = chip_smoke.KafkaLog()
    for p in payloads:
        log.append(topic, p)
    return log


def _both(payloads, schema_pk=True, **read_kw):
    """The same messages read by both packages: (torch rows, jax rows)."""
    out = {}
    for pkg in ("torch", "jax"):
        log = _log(payloads)

        def build(pw):
            return pw.io.kafka.read({"_consumer": log.consumer("t")}, "t",
                                    schema=_schema(pw, schema_pk), **read_kw)

        out[pkg] = _rows(pkg, build)
    return out["torch"], out["jax"]


def test_bson_codec_roundtrip_and_kafka_format():
    from pathway_tpu_torch.io._bson import encode_document

    msgs = [encode_document(d) for d in _people(0, 12)]
    msgs.insert(5, b"not-bson")  # malformed payloads are skipped
    got, want = _both(msgs, format="bson")
    assert got == want and len(got) == 12
    assert {r[1] for r in got} == {(d["name"], d["age"])
                                   for d in _people(0, 12)}


def test_json_format_matches():
    people = _people(1, 20)
    msgs = [json.dumps(d).encode() for d in people] + [b"{broken"]
    got, want = _both(msgs, format="json")
    assert got == want and len(got) == 20


@pytest.mark.parametrize("fmt", ["json", "plaintext", "raw"])
def test_a_schema_without_a_primary_key_keys_by_topic_and_offset(fmt):
    """The JAX package's read of a schema without a primary key fails at
    its first poll, whatever the format (its key code iterates
    ``primary_key_columns()``, None for such a schema; the plaintext and
    raw formats' default schema is one); the port keys each row by
    (topic, message number)."""
    msgs = [json.dumps(d).encode() for d in _people(2, 5)]

    def build(pw, log):
        schema = _schema(pw, False) if fmt == "json" else None
        return pw.io.kafka.read({"_consumer": log.consumer("t")}, "t",
                                schema=schema, format=fmt)

    got = _rows("torch", lambda pw: build(pw, _log(msgs)))
    assert [k for k, _r, _a in got] == [tref("t", i) for i in range(5)]
    if fmt == "raw":
        assert [r for _k, r, _a in got] == [(m,) for m in msgs]
    with pytest.raises(TypeError):
        _rows("jax", lambda pw: build(pw, _log(msgs)))


def test_kafka_avro_read():
    msgs = None
    out = {}
    for pkg in ("torch", "jax"):
        pw, _pg, _k, reg = PKGS[pkg]
        fake = _FakeRegistry()
        schema = reg.avro_schema_for(_schema(pw))
        fake.schemas[42] = schema
        msgs = [reg.encode_avro_message(d, schema, 42)
                for d in _people(3, 10)] + [b"\x01garbage"]
        log = _log(msgs)
        settings = reg.SchemaRegistrySettings("http://registry:8081",
                                              _http=fake)
        out[pkg] = _rows(pkg, lambda pw: pw.io.kafka.read(
            {"_consumer": log.consumer("t")}, "t", schema=_schema(pw),
            format="avro", schema_registry_settings=settings))
        # the schema was fetched from the registry exactly once
        gets = [u for m, u, _h in fake.requests if m == "GET"]
        assert len(gets) == 1 and gets[0].endswith("/schemas/ids/42")
    assert out["torch"] == out["jax"] and len(out["torch"]) == 10


def test_unknown_schema_id_skips_message_not_pipeline():
    """A message with an unresolvable schema id is a bad message (skipped
    and, in the port, counted), not a dead registry."""
    out = {}
    for pkg in ("torch", "jax"):
        pw, _pg, kafka, reg = PKGS[pkg]
        fake = _FakeRegistry()
        schema = reg.avro_schema_for(_schema(pw))
        fake.schemas[42] = schema
        msgs = [reg.encode_avro_message({"name": "alice", "age": 30},
                                        schema, 42),
                b"\x00\x00\x00\x03\xe7garbage",  # schema id 999
                reg.encode_avro_message({"name": "bob", "age": 41},
                                        schema, 42)]
        src = kafka.KafkaSource(
            {"_consumer": _log(msgs).consumer("t")}, "t", "avro",
            _schema(pw), schema_registry=reg.SchemaRegistrySettings(
                "http://r", _http=fake))
        src.start()
        out[pkg] = (src.poll(), src.get_offsets())
    assert out["torch"] == out["jax"]
    events, offsets = out["torch"]
    assert [e[2] for e in events] == [("alice", 30), ("bob", 41)]
    assert offsets == {"__n": 2, "p0": 3}  # the skipped one is consumed


def test_a_dead_registry_fails_the_run_in_both():
    out = {}
    for pkg in ("torch", "jax"):
        pw, _pg, kafka, reg = PKGS[pkg]

        def down(*_a):
            raise ConnectionError("schema registry unreachable")

        schema = reg.avro_schema_for(_schema(pw))
        src = kafka.KafkaSource(
            {"_consumer": _log([reg.encode_avro_message(
                {"name": "a", "age": 1}, schema, 1)]).consumer("t")},
            "t", "avro", _schema(pw),
            schema_registry=reg.SchemaRegistrySettings("http://r",
                                                       _http=down))
        src.start()
        with pytest.raises(ConnectionError):
            src.poll()
        out[pkg] = src.get_offsets()
    assert out["torch"] == out["jax"]


def _written(pkg: str, table_md: str, **write_kw) -> tuple[list, object]:
    pw, pg, _k, reg = PKGS[pkg]
    fake = _FakeRegistry()
    sent = []

    class Producer:
        def send(self, topic, payload):
            sent.append((topic, payload))

        def flush(self):
            pass

    pg.G.clear()
    try:
        t = pw.debug.table_from_markdown(table_md)
        if write_kw.get("format") == "avro":
            write_kw["schema_registry_settings"] = reg.SchemaRegistrySettings(
                "http://registry:8081", _http=fake)
        pw.io.kafka.write(t, {"_producer": Producer()}, "people", **write_kw)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kw)
    finally:
        pg.G.clear()
    return sent, fake


PEOPLE_MD = """
name | age
alice | 30
bob | 41
carol | 7
"""


@pytest.mark.parametrize("fmt", ["json", "avro"])
def test_kafka_write_sends_the_same_bytes(fmt):
    got, fake = _written("torch", PEOPLE_MD, format=fmt)
    want, jfake = _written("jax", PEOPLE_MD, format=fmt)
    assert sorted(got) == sorted(want) and len(got) == 3
    if fmt == "avro":
        assert fake.schemas == jfake.schemas
        # registered under the TopicNameStrategy subject
        assert [u for m, u, _h in fake.requests] == [
            "http://registry:8081/subjects/people-value/versions"]
        from pathway_tpu_torch.io._avro import decode_value

        sid, body = treg.decode_confluent(got[0][1])
        value, _ = decode_value(fake.schemas[sid], body, 0, {})
        assert value["diff"] == 1 and value["name"] in {"alice", "bob",
                                                         "carol"}


def test_avro_requires_registry():
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg][:2]
        pg.G.clear()
        with pytest.raises(ValueError, match="schema_registry_settings"):
            pw.io.kafka.read({}, "t", schema=_schema(pw), format="avro")
        t = pw.debug.table_from_markdown("a\n1")
        with pytest.raises(ValueError, match="schema_registry_settings"):
            pw.io.kafka.write(t, {"_producer": object()}, "t", format="avro")
        pg.G.clear()


def test_avro_write_bytes_and_any_columns():
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg, _k, reg = PKGS[pkg]
        fake = _FakeRegistry()
        sent = []

        class Producer:
            def send(self, topic, payload):
                sent.append(payload)

            def flush(self):
                pass

        pg.G.clear()
        t = pw.debug.table_from_markdown("name\nalice")
        t = t.select(name=pw.this.name,
                     blob=pw.apply_with_type(lambda s: s.encode(), bytes,
                                             pw.this.name),
                     anyv=pw.apply(lambda s: 5, pw.this.name))
        pw.io.kafka.write(t, {"_producer": Producer()}, "blobs",
                          format="avro", schema_registry_settings=(
                              reg.SchemaRegistrySettings("http://r",
                                                         _http=fake)))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kw)
        pg.G.clear()
        sid, body = reg.decode_confluent(sent[0])
        out[pkg] = (sent, fake.schemas[sid], body)
    assert out["torch"] == out["jax"]
    from pathway_tpu_torch.io._avro import decode_value

    value, _ = decode_value(out["torch"][1], out["torch"][2], 0, {})
    assert value["blob"] == b"alice" and value["anyv"] == "5"


def _debezium_msgs(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        before = {"name": f"p{i % 4}", "age": int(rng.integers(0, 99))}
        after = {"name": f"p{i % 4}", "age": int(rng.integers(0, 99))}
        op = "crud"[i % 4]
        env = {"op": op, "before": before if op in "ud" else None,
               "after": after if op in "cru" else None}
        out.append(json.dumps({"payload": env} if i % 2 else env).encode())
    return out + [b"null", b"{bad", b"[1, 2]", json.dumps(
        {"payload": 3}).encode()]


def test_parse_debezium_and_its_skips_match():
    msgs = _debezium_msgs(4)
    for pk in (["name"], []):
        for raw in msgs:
            got = tkafka.parse_debezium(raw, ["name", "age"], _schema(
                tpw).dtypes(), pk)
            want = jkafka.parse_debezium(raw, ["name", "age"], _schema(
                jpw).dtypes(), pk)
            assert got == want
    got, want = _both(msgs, format="debezium")
    assert got == want
    src = tkafka.KafkaSource({"_consumer": _log(msgs).consumer("t")}, "t",
                             "debezium", _schema(tpw))
    src.start()
    src.poll()
    assert src.n_skipped == 4 and src.get_offsets()["__n"] == len(msgs)


def test_kafka_offset_seek_roundtrip(monkeypatch):
    """``test_snapshots.py:137`` in both packages: offsets survive
    ``get_offsets`` / ``seek`` and a confluent consumer is assigned them."""
    class TopicPartition:
        def __init__(self, topic, partition, offset):
            self.topic, self.partition, self.offset = topic, partition, offset

    fake = types.ModuleType("confluent_kafka")
    fake.TopicPartition = TopicPartition
    monkeypatch.setitem(sys.modules, "confluent_kafka", fake)
    for pkg in ("torch", "jax"):
        pw, _pg, kafka, _reg = PKGS[pkg]

        class S(pw.Schema):
            data: str

        src = kafka.KafkaSource({}, "t", "plaintext", S)
        src._offsets = {0: 17, 2: 5}
        src._n = 22
        src2 = kafka.KafkaSource({}, "t", "plaintext", S)
        src2.seek(src.get_offsets())
        assert (src2._n, src2._offsets) == (22, {0: 17, 2: 5})
        assigned = {}

        class Consumer:
            def assign(self, parts):
                assigned["parts"] = [(p.topic, p.partition, p.offset)
                                     for p in parts]

            def poll(self, _t):
                return None

        monkeypatch.setattr(kafka, "_get_consumer",
                            lambda s, t: ("confluent", Consumer()))
        src2.start()
        assert sorted(assigned["parts"]) == [("t", 0, 17), ("t", 2, 5)]


class _Msg:
    def __init__(self, val, partition=0, offset=0):
        self._v, self._p, self._o = val, partition, offset

    def error(self):
        return None

    def value(self):
        return self._v

    def partition(self):
        if isinstance(self._p, Exception):
            raise self._p
        return self._p

    def offset(self):
        return self._o


def test_kafka_pk_keys_coerced():
    """``test_snapshots.py:186``: json rows with int primary keys key off
    the coerced values, in both packages alike."""
    out = {}
    for pkg, ref in (("torch", tref), ("jax", jref)):
        pw, _pg, kafka, _reg = PKGS[pkg]

        class S(pw.Schema):
            id: int = pw.column_definition(primary_key=True)
            v: str

        src = kafka.KafkaSource({}, "t", "json", S)
        src._kind = "confluent"
        msgs = [_Msg(json.dumps({"id": "7", "v": "x"}).encode())]
        src._consumer = types.SimpleNamespace(
            poll=lambda _t: msgs.pop() if msgs else None)
        events = src.poll()
        assert len(events) == 1 and events[0][1] == ref(7)
        out[pkg] = events
    assert out["torch"] == out["jax"]


def test_a_failed_seek_raises_where_the_jax_package_falls_back():
    """``kafka.py:107``: assigning the journalled offsets fails.  The JAX
    package goes on from the group's committed positions; the port
    raises."""
    class Broken(chip_smoke.LogConsumer):
        def assign(self, parts):
            raise RuntimeError("partition 0 is not assigned to this member")

    for pkg in ("torch", "jax"):
        pw, _pg, kafka, _reg = PKGS[pkg]
        src = kafka.KafkaSource(
            {"_consumer": Broken(_log([b"x"]), "t", (0,))}, "t", "plaintext",
            _schema(pw))
        src.seek({"__n": 1, "p0": 1})
        if pkg == "torch":
            with pytest.raises(RuntimeError, match="not assigned"):
                src.start()
        else:
            src.start()  # quietly unsought


def test_a_restart_reads_no_journalled_message_again(tmp_path):
    """A run journals its Kafka offsets; a second run over the same
    storage and topic log replays the journal and seeks past it.  The
    port's second run reads no message again; the JAX package's seek of
    an injected kafka-python consumer needs ``kafka.TopicPartition``,
    fails to import it where kafka-python is not installed, falls back
    quietly and reads every message again: its restart ingests the
    journalled rows twice."""
    msgs = [json.dumps(d).encode() for d in _people(5, 8)]
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg][:2]
        log = _log(msgs[:5])
        store = tmp_path / pkg
        consumers = []

        def build(pw, log=log, consumers=consumers):
            consumers.append(log.consumer("t"))
            return pw.io.kafka.read({"_consumer": consumers[-1]}, "t",
                                    schema=_schema(pw))

        def cfg(pw=pw, store=store):
            return pw.persistence.Config(
                pw.persistence.Backend.filesystem(str(store)))

        first = _rows(pkg, build, persistence_config=cfg())
        for m in msgs[5:]:
            log.append("t", m)
        second = _rows(pkg, build, persistence_config=cfg())
        out[pkg] = (first, second, consumers[1].sought,
                    consumers[1].returned[0])
    first, second, sought, returned = out["torch"]
    assert len(first) == 5 and len(second) == 8  # 5 replayed + 3 new
    assert sought == {0: 5} and returned == [5, 6, 7]
    jfirst, jsecond, jsought, jreturned = out["jax"]
    assert len(jfirst) == 5 and jsought == {} and jreturned == list(range(8))
    assert len(jsecond) > 8  # the journalled rows ingested twice


def test_a_failed_offset_read_raises_where_the_jax_package_swallows_it():
    """``kafka.py:127``: a consumed message whose partition cannot be
    read.  The JAX package drops its offset and goes on (a restart would
    read it again); the port raises."""
    for pkg in ("torch", "jax"):
        pw, _pg, kafka, _reg = PKGS[pkg]
        src = kafka.KafkaSource({}, "t", "plaintext", _schema(pw))
        src._kind = "confluent"
        msgs = [_Msg(b"hello", partition=RuntimeError("no partition"))]
        src._consumer = types.SimpleNamespace(
            poll=lambda _t: msgs.pop() if msgs else None)
        if pkg == "torch":
            with pytest.raises(RuntimeError, match="no partition"):
                src.poll()
        else:
            assert len(src.poll()) == 1
            assert src.get_offsets() == {"__n": 1}  # no offset kept


def test_a_failed_close_raises_where_the_jax_package_swallows_it():
    """``kafka.py:181``: closing the consumer fails (its final offset
    commit did not land).  The JAX package's ``stop`` is silent; the
    port's raises."""
    class Unclosable(chip_smoke.LogConsumer):
        def close(self):
            raise RuntimeError("commit failed on close")

    for pkg in ("torch", "jax"):
        pw, _pg, kafka, _reg = PKGS[pkg]
        src = kafka.KafkaSource(
            {"_consumer": Unclosable(_log([]), "t", (0,))}, "t",
            "plaintext", _schema(pw))
        src.start()
        if pkg == "torch":
            with pytest.raises(RuntimeError, match="commit failed"):
                src.stop()
            src.stop()  # closed once: a second stop does nothing
        else:
            src.stop()


def test_the_aliases_read_through_kafka():
    msgs = [json.dumps({"payload": {"op": "c", "after": d}}).encode()
            for d in _people(6, 4)]
    out = {}
    for pkg in ("torch", "jax"):
        log = _log(msgs)
        out[pkg] = _rows(pkg, lambda pw: pw.io.debezium.read(
            {"_consumer": log.consumer("t")}, "t", schema=_schema(pw)))
    assert out["torch"] == out["jax"] and len(out["torch"]) == 4
    assert tpw.io.redpanda is tpw.io.kafka
