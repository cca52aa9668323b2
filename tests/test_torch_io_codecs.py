"""The port's wire codecs held byte for byte to the JAX package's: Avro
containers and values, BSON, the Confluent framing, SigV4, and the
schema registry client (``tests/test_schema_registry.py``'s settings and
caching, over the ``_http`` seam and over real HTTP on 127.0.0.1, where
a transport error moves on to the next URL and an answered error is a
bad message).  Inputs are drawn from a seed with numpy.
"""

import datetime
import json
import socket

import numpy as np
import pytest

import chip_smoke
from pathway_tpu.io import _avro as javro
from pathway_tpu.io import _aws as jaws
from pathway_tpu.io import _bson as jbson
from pathway_tpu.io import _schema_registry as jreg
from pathway_tpu_torch.io import _avro as tavro
from pathway_tpu_torch.io import _aws as taws
from pathway_tpu_torch.io import _bson as tbson
from pathway_tpu_torch.io import _schema_registry as treg

SCHEMA = {
    "type": "record", "name": "r", "fields": [
        {"name": "s", "type": "string"},
        {"name": "n", "type": ["null", "long"]},
        {"name": "f", "type": "double"},
        {"name": "b", "type": "boolean"},
        {"name": "arr", "type": {"type": "array", "items": "long"}},
        {"name": "m", "type": {"type": "map", "values": "string"}},
        {"name": "raw", "type": "bytes"},
        {"name": "e", "type": {"type": "enum", "name": "E",
                               "symbols": ["x", "y", "z"]}},
        {"name": "fx", "type": {"type": "fixed", "name": "F", "size": 3}},
    ],
}


def _records(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        out.append({
            "s": "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, k)),
            "n": None if rng.random() < 0.3 else int(
                rng.integers(-(1 << 62), 1 << 62)),
            "f": float(rng.normal()),
            "b": bool(rng.random() < 0.5),
            "arr": [int(x) for x in rng.integers(-1000, 1000, k)],
            "m": {f"k{i}": str(int(x)) for i, x in enumerate(
                rng.integers(0, 99, k))},
            "raw": bytes(rng.integers(0, 256, k, dtype=np.uint8)),
            "e": "xyz"[int(rng.integers(0, 3))],
            "fx": bytes(rng.integers(0, 256, 3, dtype=np.uint8)),
        })
    return out


def test_avro_container_roundtrip():
    recs = [
        {"s": "x", "n": None, "f": 1.5, "b": True, "arr": [1, -2, 3],
         "m": {"a": "b"}, "raw": b"\x00\x01", "e": "y", "fx": b"abc"},
        {"s": "", "n": -42, "f": -0.25, "b": False, "arr": [],
         "m": {}, "raw": b"", "e": "x", "fx": b"\x00\x00\x00"},
    ] + _records(0, 40)
    blob = tavro.write_container(SCHEMA, recs, {"writer": "port"})
    assert blob == javro.write_container(SCHEMA, recs, {"writer": "port"})
    for reader in (tavro, javro):
        meta, back = reader.read_container(blob)
        assert back == recs
        assert json.loads(meta["avro.schema"].decode()) == SCHEMA
    assert tavro.write_container(SCHEMA, []) == javro.write_container(
        SCHEMA, [])
    with pytest.raises(ValueError, match="not an avro container"):
        tavro.read_container(b"nope")


def test_avro_values_and_zigzag_match():
    rng = np.random.default_rng(1)
    for n in [0, -1, 1, 63, -64, 64, 1 << 40, -(1 << 62)] + [
            int(x) for x in rng.integers(-(1 << 62), 1 << 62, 200)]:
        enc = tavro._zigzag_encode(n)
        assert enc == javro._zigzag_encode(n)
        assert tavro._zigzag_decode(enc, 0) == (n, len(enc))
    for rec in _records(2, 20):
        enc = tavro.encode_value(SCHEMA, rec, {})
        assert enc == javro.encode_value(SCHEMA, rec, {})
        assert tavro.decode_value(SCHEMA, enc, 0, {}) == (rec, len(enc))
    with pytest.raises(ValueError, match="no union branch"):
        tavro.encode_value(["null", "long"], "x", {})


def _bson_docs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{
        "s": "txt" * int(rng.integers(0, 3)), "i": int(rng.integers(-99, 99)),
        "big": int(rng.integers(1 << 40, 1 << 50)), "f": float(rng.normal()),
        "b": bool(rng.random() < 0.5), "n": None,
        "bin": bytes(rng.integers(0, 256, 3, dtype=np.uint8)),
        "arr": [1, "two", float(rng.random())], "nested": {"x": i},
        "ts": datetime.datetime(2026, 1, 1 + i, tzinfo=datetime.timezone.utc),
    } for i in range(10)]


def test_bson_codec_matches_byte_for_byte():
    assert tbson.encode_document({"hello": "world"}) == (
        b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00")
    docs = _bson_docs(3)
    blob = b"".join(tbson.encode_document(d) for d in docs)
    assert blob == b"".join(jbson.encode_document(d) for d in docs)
    assert tbson.decode_stream(blob) == docs == jbson.decode_stream(blob)
    back, end = tbson.decode_document(tbson.encode_document(docs[0]))
    assert back == docs[0] and end == len(tbson.encode_document(docs[0]))


def test_sigv4_known_vector():
    """AWS's published SigV4 test credentials: the port signs exactly as
    the JAX package does (test_aws_sharepoint_bq.py's vector)."""
    args = ("service", "example.amazonaws.com", "Svc.Op", b"{}")
    creds = ("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
             "us-east-1")
    got = taws.sign_request(taws.AwsCredentials(*creds), *args,
                            amz_date="20150830T123600Z")
    want = jaws.sign_request(jaws.AwsCredentials(*creds), *args,
                             amz_date="20150830T123600Z")
    assert got == want
    auth = got["authorization"]
    assert auth.startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/"
        "service/aws4_request")
    assert "SignedHeaders=content-type;host;x-amz-date;x-amz-target" in auth
    assert len(auth.split("Signature=")[1]) == 64
    token = taws.sign_request(taws.AwsCredentials(*creds, "tok"), *args,
                              amz_date="20150830T123600Z")
    assert token == jaws.sign_request(jaws.AwsCredentials(*creds, "tok"),
                                      *args, amz_date="20150830T123600Z")
    assert "x-amz-security-token" in token["authorization"]


def test_aws_call_is_verified_by_an_independent_signer():
    """``aws_call`` over real HTTP to a 127.0.0.1 endpoint that recomputes
    the signature from the request: both packages' calls pass, a wrong
    secret fails (HTTP 403)."""
    import urllib.error

    kin = chip_smoke.KinesisStandIn()
    try:
        for aws in (taws, jaws):
            creds = aws.AwsCredentials(*chip_smoke.QU_CREDS[:2],
                                       chip_smoke.QU_CREDS[2])
            out = aws.aws_call(creds, "kinesis", "Kinesis_20131202.PutRecords",
                               {"StreamName": "s", "Records": [
                                   {"Data": "e30=", "PartitionKey": "k"}]},
                               endpoint=kin.url + "/")
            assert out["FailedRecordCount"] == 0
        assert kin.bad_signatures == 0 and len(kin.records["s"]) == 2
        with pytest.raises(urllib.error.HTTPError):
            taws.aws_call(taws.AwsCredentials("k", "wrong", "us-east-1"),
                          "kinesis", "Kinesis_20131202.PutRecords",
                          {"StreamName": "s", "Records": []},
                          endpoint=kin.url + "/")
        assert kin.bad_signatures == 1
    finally:
        kin.close()


# -- the schema registry -----------------------------------------------------


class _FakeRegistry:
    """test_schema_registry.py's in-memory registry behind ``_http``."""

    def __init__(self):
        self.schemas: dict[int, dict] = {}
        self.next_id = 7
        self.requests = []

    def __call__(self, method, url, payload, headers):
        self.requests.append((method, url, headers))
        if method == "GET" and "/schemas/ids/" in url:
            sid = int(url.rsplit("/", 1)[-1])
            if sid not in self.schemas:
                raise ValueError(f"schema {sid} not found")
            return {"schema": json.dumps(self.schemas[sid])}
        if method == "POST" and "/versions" in url:
            sid = self.next_id
            self.next_id += 1
            self.schemas[sid] = json.loads(payload["schema"])
            return {"id": sid}
        raise AssertionError(f"unexpected {method} {url}")


def _schemas():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    out = {}
    for name, pw in (("jax", jpw), ("torch", tpw)):
        class S(pw.Schema):
            name: str = pw.column_definition(primary_key=True)
            age: int
            blob: bytes
            score: float | None

        out[name] = S
    return out


def test_settings_validation_and_auth_headers():
    for reg in (treg, jreg):
        with pytest.raises(ValueError, match="username"):
            reg.SchemaRegistrySettings("http://r", password="secret")
        with pytest.raises(ValueError, match="at least one URL"):
            reg.SchemaRegistrySettings([])
    kw = dict(username="u", password="p",
              headers=[treg.SchemaRegistryHeader("X-A", "1")])
    jkw = dict(kw, headers=[jreg.SchemaRegistryHeader("X-A", "1")])
    got = treg.SchemaRegistrySettings(["http://r"], **kw)._auth_headers()
    assert got == jreg.SchemaRegistrySettings(["http://r"],
                                              **jkw)._auth_headers()
    assert got["Authorization"].startswith("Basic ") and got["X-A"] == "1"
    tok = treg.SchemaRegistrySettings("http://r", token_authorization="tok")
    assert tok._auth_headers()["Authorization"] == "Bearer tok"


def test_register_and_fetch_roundtrip_caches():
    schemas = _schemas()
    runs = {}
    for name, reg in (("torch", treg), ("jax", jreg)):
        fake = _FakeRegistry()
        client = reg.SchemaRegistryClient(
            reg.SchemaRegistrySettings("http://registry:8081", _http=fake))
        schema = reg.avro_schema_for(schemas[name])
        sid = client.register("people-value", schema)
        assert client.register("people-value", schema) == sid  # cached
        assert client.schema_by_id(sid) == schema
        runs[name] = (schema, fake.requests)
    assert runs["torch"] == runs["jax"]
    schema, requests = runs["torch"]
    assert [f["name"] for f in schema["fields"]] == [
        "name", "age", "blob", "score"]
    assert schema["fields"][3]["type"][0] == "null"  # optional: a union
    assert [m for m, _u, _h in requests] == ["POST"]


def test_confluent_messages_match_byte_for_byte():
    schemas = _schemas()
    rng = np.random.default_rng(5)
    schema = treg.avro_schema_for(schemas["torch"])
    assert schema == jreg.avro_schema_for(schemas["jax"])
    for i in range(30):
        row = {"name": f"n{i}", "age": int(rng.integers(0, 120)),
               "blob": bytes(rng.integers(0, 256, 4, dtype=np.uint8)),
               "score": None if i % 3 == 0 else float(rng.normal())}
        msg = treg.encode_avro_message(row, schema, 40 + i)
        assert msg == jreg.encode_avro_message(row, schema, 40 + i)
        assert treg.decode_confluent(msg)[0] == 40 + i
        fake = _FakeRegistry()
        fake.schemas[40 + i] = schema
        for reg in (treg, jreg):
            client = reg.SchemaRegistryClient(
                reg.SchemaRegistrySettings("http://r", _http=fake))
            assert reg.decode_avro_message(msg, client) == (
                reg.coerce_row_for_avro(row, schema))
    with pytest.raises(ValueError, match="wire-format"):
        treg.decode_confluent(b"\x01garbage")


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_a_transport_error_moves_on_to_the_next_url(monkeypatch):
    """Over real HTTP: a URL nothing listens on is a transport error, and
    both clients go on to the next URL; an HTTP error answer is a bad
    message (``LookupError``), not a dead registry; no URL answering is a
    ``ConnectionError``."""
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
    schema = {"type": "record", "name": "R",
              "fields": [{"name": "a", "type": "long"}]}
    live = chip_smoke.RegistryStandIn({3: schema})
    dead = f"http://127.0.0.1:{_closed_port()}"
    try:
        for reg in (treg, jreg):
            client = reg.SchemaRegistryClient(reg.SchemaRegistrySettings(
                [dead, live.url], timeout=5))
            assert client.schema_by_id(3) == schema
            assert client.register("t-value", schema) == 3
            with pytest.raises(LookupError, match="404"):
                client.schema_by_id(99)
            gone = reg.SchemaRegistryClient(
                reg.SchemaRegistrySettings([dead], timeout=5))
            with pytest.raises(ConnectionError, match="unreachable"):
                gone.schema_by_id(3)
        assert live.gets(3) == 2 and live.gets(99) == 2
    finally:
        live.close()
