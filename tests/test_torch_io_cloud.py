"""The port's Kinesis, Pub/Sub and S3 connectors and its object-store
persistence backends held to the JAX package's
(``tests/test_aws_sharepoint_bq.py``, ``test_connectors_tail2.py::
test_pubsub_write``, ``test_s3_postgres.py``'s S3 cases and
``test_ops.py``'s Azure adapter): the same calls with the same payloads,
the same rows under the same keys, the same journal objects, and a
journal the JAX package wrote into an in-memory bucket replayed by the
port key for key.  Kinesis keeps the JAX package's retry of a failed
poll (logged once); a Pub/Sub publish that failed fails the port's run
where the JAX package drops it (``pubsub.py:47``).
"""

import base64
import collections
import json
import logging
import threading
import time

import numpy as np
import pytest

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

PKGS = {"jax": (jpw, jpg), "torch": (tpw, tpg)}
TWO_ROWS = """
name | age
alice | 30
bob | 41
"""


def _schema(pw):
    class S(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        age: int

    return S


def _run(pkg: str, **kw) -> None:
    pw = PKGS[pkg][0]
    kw.setdefault("monitoring_level", pw.MonitoringLevel.NONE)
    if pkg == "torch":
        kw["device"] = "cpu"
    pw.run(**kw)


def _dicts(pkg: str, table) -> dict:
    """``table``'s final rows by key (the port's on the CPU)."""
    pw = PKGS[pkg][0]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    keys, cols = pw.debug.table_to_dicts(table, **kw)
    return {k: tuple(cols[c][k] for c in sorted(cols)) for k in keys}


# -- Kinesis -------------------------------------------------------------------


class _FakeKinesis:
    """test_aws_sharepoint_bq.py's fake behind the ``_http`` seam."""

    def __init__(self):
        self.calls = []
        self.shards = {"shardId-000": []}

    def __call__(self, url, target, payload, headers):
        self.calls.append((target, payload))
        assert headers["authorization"].startswith("AWS4-HMAC-SHA256")
        op = target.split(".")[1]
        if op == "PutRecords":
            self.shards["shardId-000"].extend(payload["Records"])
            return {"FailedRecordCount": 0}
        if op == "ListShards":
            return {"Shards": [{"ShardId": s} for s in self.shards]}
        if op == "GetShardIterator":
            return {"ShardIterator": "it-" + payload.get(
                "StartingSequenceNumber", "0")}
        if op == "GetRecords":
            recs = [{"Data": r["Data"], "SequenceNumber": str(i)}
                    for i, r in enumerate(self.shards["shardId-000"])]
            self.shards["shardId-000"] = []
            return {"Records": recs, "NextShardIterator": "it-next"}
        raise AssertionError(op)


def test_kinesis_write_and_read():
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        fake = _FakeKinesis()
        pg.G.clear()
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.kinesis.write(t, "events", access_key="k", secret_key="s",
                            partition_column="name", _http=fake)
        _run(pkg)
        put = next(p for tg, p in fake.calls if tg.endswith("PutRecords"))
        pg.G.clear()
        fake.shards["shardId-000"] = put["Records"]
        t2 = pw.io.kinesis.read("events", schema=_schema(pw), mode="static",
                                access_key="k", secret_key="s", _http=fake)
        out[pkg] = (put, _dicts(pkg, t2))
        pg.G.clear()
    assert out["torch"] == out["jax"]
    put, rows = out["torch"]
    assert {json.loads(base64.b64decode(r["Data"]))["name"]
            for r in put["Records"]} == {"alice", "bob"}
    assert {r["PartitionKey"] for r in put["Records"]} == {"alice", "bob"}
    assert sorted(rows.values()) == [(30, "alice"), (41, "bob")]


def test_kinesis_shards_offsets_and_a_failed_poll():
    """Shard iteration with sequence numbers as offsets, one shard's failed
    fetch keeping the other's records, and a failed poll logged once and
    retried (``kinesis.py:161``), step for step in both packages."""
    rng = np.random.default_rng(9)
    ages = {s: rng.integers(0, 99, 4) for s in ("a", "b")}
    out = {}
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        if pkg == "torch":
            from pathway_tpu_torch.io.kinesis import KinesisSource
            from pathway_tpu_torch.io._aws import AwsCredentials
        else:
            from pathway_tpu.io.kinesis import KinesisSource
            from pathway_tpu.io._aws import AwsCredentials
        records = {s: [{"Data": base64.b64encode(json.dumps(
            {"name": f"{s}-{i}", "age": int(a)}).encode()).decode(),
            "SequenceNumber": f"{s}:{i}"} for i, a in enumerate(ages[s])]
            for s in ("a", "b")}
        state = {"down": 0, "bad_shard": "b"}

        def http(url, target, payload, headers, records=records,
                 state=state):
            op = target.split(".")[1]
            if state["down"]:
                state["down"] -= 1
                raise ConnectionError("kinesis endpoint down")
            if op == "ListShards":
                return {"Shards": [{"ShardId": s} for s in records]}
            if op == "GetShardIterator":
                return {"ShardIterator": payload["ShardId"]}
            if op == "GetRecords":
                shard = payload["ShardIterator"]
                if shard == state["bad_shard"]:
                    state["bad_shard"] = None
                    raise TimeoutError("throttled")
                recs, records[shard] = records[shard], []
                return {"Records": recs, "NextShardIterator": shard}
            raise AssertionError(op)

        src = KinesisSource(AwsCredentials("k", "s", "us-east-1"), "st",
                            _schema(pw), "json", "streaming", 0.0,
                            "TRIM_HORIZON", None, http)
        steps = [sorted(e[2] for e in src.poll())]  # shard b throttled
        offsets = [src.get_offsets()]
        state["down"] = 2
        steps += [src.poll(), src.poll()]  # two failed polls: [] each
        steps.append(sorted(e[2] for e in src.poll()))  # b again
        offsets.append(src.get_offsets())
        out[pkg] = (steps, offsets, src._err)
    assert out["torch"] == out["jax"]
    steps, offsets, err = out["torch"]
    assert len(steps[0]) == 4 and steps[1] == steps[2] == []
    assert len(steps[3]) == 4 and not err
    assert offsets == [{"a": "a:3"}, {"a": "a:3", "b": "b:3"}]


def test_kinesis_logs_a_failed_poll_once_as_the_jax_package_does(caplog):
    counts = {}
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        if pkg == "torch":
            from pathway_tpu_torch.io.kinesis import KinesisSource
            from pathway_tpu_torch.io._aws import AwsCredentials
        else:
            from pathway_tpu.io.kinesis import KinesisSource
            from pathway_tpu.io._aws import AwsCredentials

        def down(*_a):
            raise ConnectionError("kinesis endpoint down")

        src = KinesisSource(AwsCredentials("k", "s", "us-east-1"), "st",
                            _schema(pw), "json", "streaming", 0.0,
                            "TRIM_HORIZON", None, down)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert [src.poll() for _ in range(4)] == [[]] * 4
        counts[pkg] = [r.getMessage() for r in caplog.records
                       if "kinesis poll failed" in r.getMessage()]
    assert len(counts["torch"]) == len(counts["jax"]) == 1


# -- Pub/Sub -------------------------------------------------------------------


class _Future:
    def __init__(self, error=None):
        self.error = error

    def done(self):
        return True

    def result(self, timeout=None):
        if self.error is not None:
            raise self.error
        return "id"


class _FakePublisher:
    def __init__(self, fail_at=None):
        self.messages = []
        self.fail_at = fail_at

    def topic_path(self, project, topic):
        return f"projects/{project}/topics/{topic}"

    def publish(self, topic, data, **attrs):
        self.messages.append((topic, data, attrs))
        failed = len(self.messages) == self.fail_at
        return _Future(RuntimeError("publish rejected") if failed else None)


def test_pubsub_write():
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        pub = _FakePublisher()
        pg.G.clear()
        t = pw.debug.table_from_markdown("payload\nhello\nworld")
        pw.io.pubsub.write(t, pub, "proj", "blobs")
        _run(pkg)
        out[pkg] = sorted(pub.messages, key=lambda m: m[1])
        pg.G.clear()
        with pytest.raises(ValueError, match="single binary column"):
            pw.io.pubsub.write(pw.debug.table_from_markdown(TWO_ROWS), pub,
                               "p", "t")
        pg.G.clear()
    assert out["torch"] == out["jax"]
    topic, data, attrs = out["torch"][0]
    assert topic == "projects/proj/topics/blobs" and data == b"hello"
    assert attrs["pathway_diff"] == "1"


def test_a_failed_publish_fails_the_run_where_the_jax_package_drops_it():
    """``pubsub.py:47``: the second publish's future fails.  The JAX
    package's run ends as if it had landed; the port's run raises."""
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        pub = _FakePublisher(fail_at=2)
        pg.G.clear()
        t = pw.debug.table_from_markdown("payload\na\nb\nc")
        pw.io.pubsub.write(t, pub, "proj", "blobs")
        try:
            if pkg == "torch":
                with pytest.raises(RuntimeError, match="publish rejected"):
                    _run(pkg)
            else:
                _run(pkg)
        finally:
            pg.G.clear()
        assert len(pub.messages) == 3


# -- S3 ------------------------------------------------------------------------


def _settings(pkg: str, client):
    return PKGS[pkg][0].io.s3.AwsS3Settings(bucket_name="bkt", _client=client)


def _csv_objects(seed: int, n_objects: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_objects):
        rows = "".join(f"w{int(w)},{int(v)}\n" for w, v in zip(
            rng.integers(0, 50, 5), rng.integers(0, 1000, 5)))
        out[f"data/part-{i}.csv"] = ("k,v\n" + rows).encode()
    return out


def test_s3_read_static_csv():
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        client = chip_smoke.MemS3()
        for key, body in _csv_objects(11, 4).items():
            client.put_object("bkt", key, body)

        class S(pw.Schema):
            k: str
            v: int

        pg.G.clear()
        t = pw.io.s3.read("s3://bkt/data/", aws_s3_settings=_settings(
            pkg, client), format="csv", schema=S, mode="static")
        out[pkg] = _dicts(pkg, t)
        pg.G.clear()
    assert out["torch"] == out["jax"] and len(out["torch"]) == 20


def test_s3_scanner_offsets_etags_and_skips_match():
    """The scanner's per-object offsets, its ETag short cut and a JSON
    line that does not parse (skipped, ``s3.py:95``) step for step."""
    out = {}
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        if pkg == "torch":
            from pathway_tpu_torch.io.s3 import S3ScannerSource
        else:
            from pathway_tpu.io.s3 import S3ScannerSource

        class S(pw.Schema):
            w: str

        client = chip_smoke.MemS3()
        client.put_object("bkt", "in/a.jsonl", b'{"w": "alpha"}\n{bad\n')
        src = S3ScannerSource(_settings(pkg, client), "bkt", "in/", "json",
                              S, poll_interval_s=0.0)
        steps = [src.poll()]
        steps.append(src.poll())  # unchanged ETag: nothing read
        client.put_object("bkt", "in/a.jsonl",
                          b'{"w": "alpha"}\n{bad\n{"w": "beta"}\n')
        client.put_object("bkt", "in/b.jsonl", b'{"w": "gamma"}\n')
        steps.append(src.poll())
        offsets = src.get_offsets()
        src2 = S3ScannerSource(_settings(pkg, client), "bkt", "in/", "json",
                               S, poll_interval_s=0.0)
        src2.seek(offsets)
        steps.append(src2.poll())  # resumed: nothing new
        out[pkg] = (steps, offsets)
    assert out["torch"] == out["jax"]
    steps, offsets = out["torch"]
    assert [len(s) for s in steps] == [1, 0, 2, 0]
    assert offsets == {"in/a.jsonl": 2, "in/b.jsonl": 1}


def test_s3_streaming_appends_and_write():
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        client = chip_smoke.MemS3()
        client.put_object("bkt", "in/a.jsonl", b'{"w": "alpha"}\n')

        class S(pw.Schema):
            w: str

        pg.G.clear()
        t = pw.io.s3.read("s3://bkt/in/", aws_s3_settings=_settings(
            pkg, client), format="json", schema=S, mode="streaming")
        counts = t.groupby(t.w).reduce(t.w, c=pw.reducers.count())
        pw.io.s3.write(counts, "s3://bkt/out",
                       aws_s3_settings=_settings(pkg, client))

        def appender(client=client):
            time.sleep(0.4)
            client.put_object("bkt", "in/a.jsonl",
                              b'{"w": "alpha"}\n{"w": "beta"}\n')

        th = threading.Thread(target=appender, daemon=True)
        th.start()
        try:
            _run(pkg, timeout_s=3.0, idle_stop_s=1.5,
                 autocommit_duration_ms=30)
        finally:
            pg.G.clear()
        th.join()
        net = collections.Counter()
        for (b, k), body in client.objects.items():
            if k.startswith("out/"):
                for ln in body.decode().splitlines():
                    o = json.loads(ln)
                    net[(o["w"], o["c"])] += o["diff"]
        out[pkg] = +net
    assert out["torch"] == out["jax"] == {("alpha", 1): 1, ("beta", 1): 1}


@pytest.mark.parametrize("kind", ["s3", "azure"])
def test_object_store_backend_roundtrip(kind):
    """``test_s3_postgres.py``'s backend roundtrip and ``test_ops.py``'s
    Azure adapter: the same verbs read back the same records in both
    packages, and leave the same objects until the first ``replace_all``.
    The port's replacement writes the new records past the old ones and
    moves the stream's live range onto them (``meta/live/{stream}``)
    before it deletes the old; the JAX package's deletes first."""
    stores = {}
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        client = chip_smoke.MemS3()
        if kind == "s3":
            backend = pw.persistence.Backend.s3(
                "s3://bkt/pstore", bucket_settings=_settings(pkg, client))
        else:
            backend = pw.persistence.Backend.azure(
                "az://c/pstore", _AzureAccount(client))
        backend.append("streamA", b"r0")
        backend.append("streamA", b"r1")
        backend.append("streamB__p0", b"x")
        assert backend.read_all("streamA") == [b"r0", b"r1"]
        assert backend.list_streams("stream") == ["streamA", "streamB__p0"]
        backend.put_metadata("journal_format", b"2")
        stores[pkg, "appended"] = dict(client.objects)
        backend.replace_all("streamA", [b"only"])
        assert backend.read_all("streamA") == [b"only"]
        backend.append("streamA", b"after")
        assert backend.read_all("streamA") == [b"only", b"after"]
        assert backend.get_metadata("journal_format") == b"2"
        assert backend.get_metadata("missing") is None
        stores[pkg] = dict(client.objects)
    assert stores["torch", "appended"] == stores["jax", "appended"]
    # a path without s3:// is the prefix whole inside the settings' bucket
    root = "pstore" if kind == "s3" else "az://c/pstore"
    assert sorted(k for _b, k in stores["jax"]) == [
        f"{root}/meta/journal_format", f"{root}/streams/streamA/000000000000",
        f"{root}/streams/streamA/000000000001",
        f"{root}/streams/streamB__p0/000000000000"]
    assert sorted(k for _b, k in stores["torch"]) == [
        f"{root}/meta/journal_format", f"{root}/meta/live/streamA",
        f"{root}/streams/streamA/000000000002",
        f"{root}/streams/streamA/000000000003",
        f"{root}/streams/streamB__p0/000000000000"]


class _FailingS3(chip_smoke.MemS3):
    """``MemS3`` whose ``fail_on`` verb raises from its ``after``-th call
    on: a process that dies at that point of a replacement."""

    def __init__(self):
        super().__init__()
        self.fail_on, self.after, self.calls = None, 0, 0

    def _maybe_fail(self, verb):
        if verb == self.fail_on:
            self.calls += 1
            if self.calls > self.after:
                raise ConnectionError(f"{verb} failed")

    def put_object(self, Bucket, Key, Body):
        self._maybe_fail("put")
        super().put_object(Bucket, Key, Body)

    def delete_object(self, Bucket, Key):
        self._maybe_fail("delete")
        super().delete_object(Bucket, Key)


@pytest.mark.parametrize("fail_on,after,live", [
    ("put", 2, "old"),     # the range frozen, one new record written
    ("put", 3, "old"),     # every new record written, the range not moved
    ("delete", 0, "new"),  # the range moved, nothing deleted
    ("delete", 2, "new"),  # two old records deleted
])
def test_a_replacement_that_dies_leaves_one_whole_journal(fail_on, after,
                                                          live):
    """``replace_all`` dies part way, as a compaction or a trim after a
    snapshot may.  The port's stream then reads either every old record
    or every new one, never a part, and the next append (a new process
    over the same bucket) lands in that whole journal.  The JAX
    package's replacement deletes first: dying at its first put leaves
    the stream empty."""
    old = [b"r0", b"r1", b"r2", b"r3"]
    new = [b"n0", b"n1"]
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        client = _FailingS3()

        def backend(client=client, pw=pw, pkg=pkg):
            return pw.persistence.Backend.s3(
                "s3://bkt/pstore", bucket_settings=_settings(pkg, client))

        b = backend()
        for rec in old:
            b.append("s", rec)
        client.fail_on, client.after = (
            (fail_on, after) if pkg == "torch" else ("put", 0))
        with pytest.raises(ConnectionError):
            b.replace_all("s", new)
        client.fail_on = None
        got = backend().read_all("s")
        if pkg == "jax":
            assert got == []
            continue
        want = old if live == "old" else new
        assert got == want
        restarted = backend()
        restarted.append("s", b"next")
        assert restarted.read_all("s") == want + [b"next"]
        assert backend().read_all("s") == want + [b"next"]
        keys = sorted(k for _b, k in client.objects
                      if k.startswith("pstore/streams/"))
        assert len(keys) == len(want) + 1


class _AzureAccount:
    """An Azure account's settings carrying a ContainerClient over
    ``MemS3`` (``list_blobs`` / ``download_blob`` / ``upload_blob`` /
    ``delete_blob``)."""

    container = "c"

    def __init__(self, client, missing=KeyError):
        store = client

        class Container:
            def list_blobs(self, name_starts_with=""):
                resp = store.list_objects_v2("c", name_starts_with)
                return [type("B", (), {"name": o["Key"]})()
                        for o in resp["Contents"]]

            def download_blob(self, name):
                try:
                    body = store.get_object("c", name)["Body"].read()
                except KeyError:
                    raise missing(name) from None
                return type("R", (), {"readall": lambda self: body})()

            def upload_blob(self, name, body, overwrite=False):
                store.put_object("c", name, body)

            def delete_blob(self, name):
                store.delete_object("c", name)

        self.container_client = Container()


class ResourceNotFoundError(Exception):
    """azure-core's error for a blob that is not there."""


def test_a_fresh_azure_container_starts_a_journal():
    """A real ContainerClient raises ``ResourceNotFoundError`` for a blob
    that is not there.  The port's Azure backend reads it as no metadata,
    so persistence over a fresh container starts its journal; the JAX
    package's missing-key check knows only S3's names and raises."""
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        backend = pw.persistence.Backend.azure(
            "az://c/pstore",
            _AzureAccount(chip_smoke.MemS3(), missing=ResourceNotFoundError))
        if pkg == "jax":
            with pytest.raises(ResourceNotFoundError):
                backend.get_metadata("journal_format")
            continue
        assert backend.get_metadata("journal_format") is None
        backend.append("s", b"r0")
        backend.replace_all("s", [b"n0"])
        backend.append("s", b"r1")
        assert backend.read_all("s") == [b"n0", b"r1"]


def _total_run(pkg: str, client, objects) -> dict:
    pw, pg = PKGS[pkg]

    class S(pw.Schema):
        k: str
        v: int

    pg.G.clear()
    got = {}
    t = pw.io.s3.read("s3://bkt/in/", aws_s3_settings=_settings(pkg, client),
                      format="csv", schema=S, mode="static")
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    got.update({key: (row["k"], row["v"])})
                    if is_addition else got.pop(key, None))
    try:
        _run(pkg, persistence_config=pw.persistence.Config(
            pw.persistence.Backend.s3(
                "s3://bkt/ps", bucket_settings=_settings(pkg, client))))
    finally:
        pg.G.clear()
    return got


def test_s3_persistence_end_to_end():
    """A full run with the S3 backend: a resume does not ingest twice, in
    both packages, with the same journal objects."""
    stores = {}
    for pkg in ("torch", "jax"):
        client = chip_smoke.MemS3()
        client.put_object("bkt", "in/data.csv", b"k,v\na,1\nb,2\n")
        first = _total_run(pkg, client, None)
        assert _total_run(pkg, client, None) == first
        assert sorted(first.values()) == [("a", 1), ("b", 2)]
        stores[pkg] = sorted(k for _b, k in client.objects)
    assert stores["torch"] == stores["jax"]


def test_a_jax_s3_journal_replays_in_the_port_key_for_key():
    """The JAX package journals an S3 read into an in-memory bucket; the
    port restarts over the same bucket after another object landed: the
    journalled rows come back under the JAX package's keys and the new
    object's rows get the keys the JAX package gives them."""
    objects = _csv_objects(13, 3)
    client = chip_smoke.MemS3()
    for key in list(objects)[:2]:
        client.put_object("bkt", "in/" + key.split("/")[1], objects[key])
    first = _total_run("jax", client, None)
    assert len(first) == 10
    last = list(objects)[2]
    client.put_object("bkt", "in/" + last.split("/")[1], objects[last])
    restarted = _total_run("torch", client, None)
    fresh_client = chip_smoke.MemS3()
    for key, body in objects.items():
        fresh_client.put_object("bkt", "in/" + key.split("/")[1], body)
    fresh = _total_run("jax", fresh_client, None)
    assert len(fresh) == 15
    assert restarted == fresh
    assert {k: restarted[k] for k in first} == first


def test_an_s3_read_without_a_schema():
    """Without a schema the port reads one ``data`` column a line; the JAX
    package's ``s3.read`` imports a ``schema_builder`` that its
    ``internals/schema.py`` lacks."""
    client = chip_smoke.MemS3()
    client.put_object("bkt", "t/a.txt", b"one\ntwo\n")
    tpg.G.clear()
    t = tpw.io.s3.read("t/", aws_s3_settings=_settings("torch", client),
                       format="plaintext", mode="static")
    assert sorted(_dicts("torch", t).values()) == [("one",), ("two",)]
    tpg.G.clear()
    with pytest.raises(ImportError, match="schema_builder"):
        jpw.io.s3.read("t/", aws_s3_settings=_settings("jax", client),
                       format="plaintext", mode="static")
    jpg.G.clear()


def test_the_s3_aliases():
    for pkg in ("torch", "jax"):
        pw = PKGS[pkg][0]
        m = pw.io.minio.MinIOSettings("minio.local:9000", "bkt", "a", "s")
        assert (m.endpoint, m.with_path_style, m.bucket_name) == (
            "https://minio.local:9000", True, "bkt")
    client = chip_smoke.MemS3()
    client.put_object("bkt", "x/a.csv", b"data\nq\n")
    tpg.G.clear()
    t = tpw.io.s3_csv.read("x/", aws_s3_settings=_settings("torch", client),
                           schema=tpw.schema_from_types(data=str),
                           mode="static")
    assert sorted(_dicts("torch", t).values()) == [("q",)]
    tpg.G.clear()
    t = tpw.io.minio.read("x/", minio_settings=tpw.io.minio.MinIOSettings(
        bucket_name="bkt", _client=client), format="csv",
        schema=tpw.schema_from_types(data=str), mode="static")
    assert sorted(_dicts("torch", t).values()) == [("q",)]
    tpg.G.clear()
    assert tpw.io.null.write(t) is None
