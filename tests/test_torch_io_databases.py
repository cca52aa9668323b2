"""The port's database connectors held to the JAX package's: Postgres,
MySQL, SQL Server (snapshot, then CDC), MongoDB, Elasticsearch,
ClickHouse, QuestDB, DynamoDB and BigQuery.  Each test runs one program
through the JAX connector and through the port's (``device="cpu"``), on
two fresh copies of a stand-in of ``tests/torch_db_fakes.py``, and holds
the port to the JAX package: the statements, documents and payloads that
reach the stand-ins are equal, and so are the rows a source reads, keys
included.  The tests of the port's own decisions on the JAX package's
quiet fallbacks come last: a failed ``close`` or post-read ``commit``
raises, and a failed poll is counted and retried.
"""

from __future__ import annotations

import json
import re

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

from . import torch_db_fakes as fakes

PKGS = {"jax": (jpw, jpg), "torch": (tpw, tpg)}

TWO_ROWS = """
name | age
alice | 30
bob | 41
"""

# a stream: alice updated at time 2, bob deleted at time 4
STREAM_ROWS = [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 2, -1),
               ("a", 5, 2, 1), ("b", 2, 4, -1)]


def run(pkg: str, build, **run_kw):
    """``build(pw)`` in package ``pkg``, then one ``pw.run`` (the port's on
    the CPU); returns what ``build`` returned."""
    pw, pg = PKGS[pkg]
    pg.G.clear()
    try:
        out = build(pw)
        kw = dict(monitoring_level=pw.MonitoringLevel.NONE, **run_kw)
        if pkg == "torch":
            kw["device"] = "cpu"
        pw.run(**kw)
    finally:
        pg.G.clear()
    return out


def both(build, **run_kw) -> tuple:
    """``run`` in the port, then in the JAX package."""
    return run("torch", build, **run_kw), run("jax", build, **run_kw)


def schema(pw, pk=True):
    class S(pw.Schema):
        name: str = pw.column_definition(primary_key=pk)
        age: int

    return S


def kv_schema(pw):
    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return KV


def subscribed(pw, t, seen: list, on_first=None):
    """``seen`` gets ``(key, name, age, is_addition)`` of each change;
    ``on_first()`` runs once, at the first change."""

    def on_change(key, row, time, is_addition):
        seen.append((key, row["name"], row["age"], is_addition))
        if on_first is not None and len(seen) == 1:
            on_first()

    pw.io.subscribe(t, on_change=on_change)


# -- Postgres -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stream_of_changes", "snapshot"])
def test_postgres_writes_equal_the_jax_packages(mode):
    """``write`` appends every change with its time and diff; a snapshot
    upserts on the key and deletes a retracted one."""

    def build(pw):
        conn = fakes.PgRecorder()
        if mode == "snapshot":
            t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                         is_stream=True)
            pw.io.postgres.write_snapshot(
                t, {"_connection": conn}, "snap", primary_key=[t.k],
                init_mode="create_if_not_exists")
        else:
            t = pw.debug.table_from_rows(kv_schema(pw), [("a", 1), ("b", 2)])
            pw.io.postgres.write(t, {"_connection": conn}, "out_table",
                                 init_mode="create_if_not_exists")
        return conn

    got, want = both(build)
    assert got.statements == want.statements
    assert got.commits == want.commits >= 1
    if mode == "snapshot":
        assert got.snapshot == {"a": ("a", 5)}
        assert any("ON CONFLICT" in s for s, _p in got.statements)
    else:
        creates = [s for s, _p in got.statements if s.startswith("CREATE")]
        assert len(creates) == 1 and "time BIGINT, diff BIGINT" in creates[0]
        inserts = [p for s, p in got.statements if s.startswith("INSERT")]
        assert {p[:2] for p in inserts} == {("a", 1), ("b", 2)}
        assert all(p[-1] == 1 for p in inserts)


# -- MySQL ----------------------------------------------------------------------


def test_mysql_cdc_polling_equals_the_jax_packages():
    """A streaming read: the rows at the start, then an insert and an
    update made at the first change, read under the JAX package's keys."""

    def build(pw):
        db = fakes.SqliteDbApi("mysql")
        db.execute("CREATE TABLE users (name TEXT PRIMARY KEY, age INTEGER)")
        db.execute("INSERT INTO users VALUES ('alice', 30)")
        seen: list = []
        t = pw.io.mysql.read({"_connection": db}, "users", schema(pw),
                             poll_interval_s=0.02)

        def mutate():
            db.execute("INSERT INTO users VALUES ('bob', 41)")
            db.execute("UPDATE users SET age = 31 WHERE name = 'alice'")

        subscribed(pw, t, seen, mutate)
        return seen

    got, want = both(
        build, idle_stop_s=0.4, timeout_s=10.0, autocommit_duration_ms=20)
    assert sorted(got) == sorted(want)
    flat = {(n, a, add) for _k, n, a, add in got}
    assert flat == {("alice", 30, True), ("bob", 41, True),
                    ("alice", 30, False), ("alice", 31, True)}


def test_mysql_write_stream_and_snapshot_equal_the_jax_packages():
    def build(pw):
        db = fakes.SqliteDbApi("mysql")
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.mysql.write(t, {"_connection": db}, "changes",
                          init_mode="create_if_not_exists")
        pw.io.mysql.write_snapshot(t, {"_connection": db}, "snap",
                                   primary_key=["name"],
                                   init_mode="create_if_not_exists")
        return db

    got, want = both(build)
    assert sorted(got.statements) == sorted(want.statements)
    for db in (got, want):
        assert {(n, int(a), d) for n, a, d in db.rows(
            'SELECT name, age, diff FROM "changes"')} == {
            ("alice", 30, 1), ("bob", 41, 1)}
        assert {(n, int(a)) for n, a in db.rows(
            'SELECT name, age FROM "snap"')} == {("alice", 30), ("bob", 41)}
    assert any("ON DUPLICATE KEY UPDATE" in s for s, _p in got.statements)


def test_mysql_rows_without_a_key_keep_their_multiplicity():
    """Two identical rows without a primary key are two rows under the
    JAX package's occurrence-counted keys; deleting one retracts one."""
    from pathway_tpu.internals import dtype as jdt
    from pathway_tpu.internals.compat import schema_builder as jbuilder
    from pathway_tpu.internals.schema import ColumnDefinition as JCol
    from pathway_tpu.io.mysql import MysqlSnapshotSource as JSource
    from pathway_tpu_torch.internals import dtype as tdt
    from pathway_tpu_torch.internals.compat import schema_builder as tbuilder
    from pathway_tpu_torch.internals.schema import ColumnDefinition as TCol
    from pathway_tpu_torch.io.mysql import MysqlSnapshotSource as TSource

    polls = {}
    for pkg, (Source, builder, Col, dt) in {
            "jax": (JSource, jbuilder, JCol, jdt),
            "torch": (TSource, tbuilder, TCol, tdt)}.items():
        db = fakes.SqliteDbApi("mysql")
        db.execute("CREATE TABLE p (name TEXT, age INTEGER)")
        db.execute("INSERT INTO p VALUES ('dup', 1), ('dup', 1), ('x', 2)")
        no_pk = builder({"name": Col(dtype=dt.STR), "age": Col(dtype=dt.INT)},
                        name="NoPk")
        src = Source({"_connection": db}, "p", no_pk, 0.0, "streaming")
        first = src.poll()
        db.execute("DELETE FROM p WHERE rowid = 1")
        src._first = True
        polls[pkg] = (first, src.poll())
    assert polls["torch"] == polls["jax"]
    first, second = polls["torch"]
    assert sum(d for *_e, d in first) == 3
    assert [(r, d) for _t, _k, r, d in second] == [(("dup", 1), -1)]


# -- SQL Server -----------------------------------------------------------------


def people(pw):
    class People(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        age: int

    return People


@pytest.mark.parametrize("change", ["update_insert_delete", "key_change"])
def test_mssql_snapshot_then_cdc_equals_the_jax_packages(change):
    """The snapshot, then the CDC log's changes made at the first change:
    an update retracts the old row, a delete its row, and an update of the
    primary key retracts the old key."""

    def build(pw):
        db = fakes.MssqlCdc("people", ["name", "age"])
        db.upsert(("alice", 30))
        db.upsert(("bob", 41))
        seen: list = []
        t = pw.io.mssql.read({"_connection": db}, "people", people(pw),
                             autocommit_duration_ms=20)

        def mutate():
            if change == "key_change":
                db.change_key("alice", ("alicia", 30))
            else:
                db.upsert(("alice", 31))
                db.upsert(("carol", 22))
                db.delete("bob")

        subscribed(pw, t, seen, mutate)
        return seen

    got, want = both(build, idle_stop_s=0.4, timeout_s=10.0,
                     autocommit_duration_ms=20)
    assert sorted(got) == sorted(want)
    flat = {(n, a, add) for _k, n, a, add in got}
    if change == "key_change":
        assert ("alice", 30, False) in flat and ("alicia", 30, True) in flat
    else:
        assert {("alice", 30, False), ("alice", 31, True),
                ("carol", 22, True), ("bob", 41, False)} <= flat


@pytest.mark.parametrize("off", ["table_cdc_enabled", "cdc_enabled"])
def test_mssql_streaming_without_cdc_fails_at_startup(off):
    for pw, pg in PKGS.values():
        db = fakes.MssqlCdc("people", ["name", "age"])
        setattr(db, off, False)
        db.upsert(("alice", 30))
        pg.G.clear()
        t = pw.io.mssql.read({"_connection": db}, "people", people(pw),
                             autocommit_duration_ms=20)
        pw.io.subscribe(t, on_change=lambda *a: None)
        kw = {"device": "cpu"} if pw is tpw else {}
        try:
            with pytest.raises(Exception, match="sp_cdc_enable_table"):
                pw.run(timeout_s=5.0, autocommit_duration_ms=20,
                       monitoring_level=pw.MonitoringLevel.NONE, **kw)
        finally:
            pg.G.clear()


def test_mssql_static_read_and_identifier_check():
    def build(pw):
        db = fakes.MssqlCdc("people", ["name", "age"])
        db.upsert(("alice", 30))
        seen: list = []
        t = pw.io.mssql.read({"_connection": db}, "people", people(pw),
                             mode="static")
        subscribed(pw, t, seen)
        return seen, db.queries

    (got, q), (want, jq) = both(build)
    assert got == want and [(n, a) for _k, n, a, _add in got] == [
        ("alice", 30)]
    assert q == jq == {"select": 1}
    for pw in (tpw, jpw):
        with pytest.raises(ValueError, match="identifier"):
            pw.io.mssql.read({}, "people; DROP TABLE x", people(pw))


def test_mssql_snapshot_writer_keys_its_table_and_probes_unknown_rowcounts():
    """The snapshot table is created with a PRIMARY KEY, and an update
    under ``rowcount == -1`` probes for the row instead of inserting it
    twice; the statements equal the JAX writer's."""
    from pathway_tpu.io.mssql import _MssqlWriter as JWriter
    from pathway_tpu_torch.io.mssql import _MssqlWriter as TWriter

    conns = {}
    for pkg, Writer in (("jax", JWriter), ("torch", TWriter)):
        conn = fakes.MssqlRecorder()
        w = Writer({"_connection": conn}, "snap", snapshot=True,
                   primary_key=["name"], init_mode="create_if_not_exists")
        w.write_batch(0, ["name", "age"], [(1, ("alice", "30"), 1)])
        w.write_batch(1, ["name", "age"], [(1, ("alice", "31"), 1)])
        conns[pkg] = conn
    got = conns["torch"]
    assert got.statements == conns["jax"].statements
    ddl = next(q for q, _p in got.statements if "CREATE TABLE" in q)
    assert "PRIMARY KEY ([name])" in ddl
    assert "[name] NVARCHAR(450) NOT NULL" in ddl
    assert len(got.inserts) == 1
    assert any(q.startswith("SELECT 1 FROM") for q, _p in got.statements)


def test_mssql_writers_on_a_database_equal_the_jax_packages():
    """``write`` and ``write_snapshot`` against sqlite's T-SQL subset: the
    appended changes and the snapshot an update and a delete leave."""

    def build(pw):
        db = fakes.SqliteDbApi("mssql")
        db.execute("CREATE TABLE changes (k TEXT, v INTEGER, time INTEGER, "
                   "diff INTEGER)")
        db.execute("CREATE TABLE snap (k TEXT PRIMARY KEY, v INTEGER)")
        t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                     is_stream=True)
        pw.io.mssql.write(t, {"_connection": db}, "changes")
        pw.io.mssql.write_snapshot(t, {"_connection": db}, "snap", ["k"])
        return db

    got, want = both(build)
    assert sorted(got.statements) == sorted(want.statements)
    for db in (got, want):
        assert db.rows("SELECT k, v FROM snap") == [("a", 5)]
        assert sorted(db.rows("SELECT k, v, diff FROM changes")) == sorted(
            (k, v, d) for k, v, _t, d in STREAM_ROWS)


# -- MongoDB and Elasticsearch --------------------------------------------------


def test_mongodb_write_and_read_equal_the_jax_packages():
    def write(pw):
        client = fakes.MongoClient()
        t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                     is_stream=True)
        pw.io.mongodb.write(t, "mongodb://x", "db", "coll", _client=client)
        return client

    got, want = both(write)
    assert sorted(got.ops, key=repr) == sorted(want.ops, key=repr)
    assert [(d["k"], d["v"]) for d in got.colls["coll"].values()] == [
        ("a", 5)]

    reads = {}
    for pkg, (pw, pg) in PKGS.items():
        client = fakes.MongoClient()
        client["db"]["coll"].replace_one({"_id": "1"}, {"k": "a", "v": 1})
        client["db"]["coll"].replace_one({"_id": "2"}, {"k": "b", "v": 2})
        pg.G.clear()
        try:
            t = pw.io.mongodb.read("mongodb://x", "db", "coll",
                                   schema=kv_schema(pw), mode="static",
                                   _client=client)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            keys, cols = pw.debug.table_to_dicts(t, **kw)
        finally:
            pg.G.clear()
        reads[pkg] = {k: (cols["k"][k], cols["v"][k]) for k in keys}
    assert reads["torch"] == reads["jax"]
    assert sorted(reads["torch"].values()) == [("a", 1), ("b", 2)]


def test_elasticsearch_upsert_delete_equals_the_jax_packages():
    def build(pw):
        es = fakes.EsClient()
        t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                     is_stream=True)
        auth = pw.io.elasticsearch.ElasticSearchAuth("injected", client=es)
        pw.io.elasticsearch.write(t, "http://localhost:9200", auth, "idx")
        return es

    got, want = both(build)
    assert sorted(got.ops, key=repr) == sorted(want.ops, key=repr)
    assert [d["k"] for d in got.docs.values()] == ["a"]


# -- ClickHouse and QuestDB -----------------------------------------------------


def test_clickhouse_write_and_cdc_read_equal_the_jax_packages():
    def write(pw):
        fake = fakes.ClickHouse()
        settings = pw.io.clickhouse.ClickHouseSettings(_http=fake)
        t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                     is_stream=True)
        pw.io.clickhouse.write(t, settings, "changes",
                               init_mode="create_if_not_exists")
        pw.io.clickhouse.write_snapshot(t, settings, "snap",
                                        primary_key=["k"],
                                        init_mode="create_if_not_exists")
        return fake

    got, want = both(write)
    assert sorted(got.requests, key=repr) == sorted(want.requests, key=repr)
    assert got.tables["snap"] == [{"k": "a", "v": 5}]
    assert sorted((r["k"], r["v"], r["diff"]) for r in got.tables["changes"]
                  ) == sorted((k, v, d) for k, v, _t, d in STREAM_ROWS)

    def read(pw):
        fake = fakes.ClickHouse()
        fake.tables["people"] = [{"name": "alice", "age": 30}]
        seen: list = []
        t = pw.io.clickhouse.read(pw.io.clickhouse.ClickHouseSettings(
            _http=fake), "people", schema(pw), poll_interval_s=0.02)
        subscribed(pw, t, seen, lambda: fake.tables["people"].append(
            {"name": "carol", "age": 22}))
        return seen

    got, want = both(read, idle_stop_s=0.4, timeout_s=10.0,
                     autocommit_duration_ms=20)
    assert sorted(got) == sorted(want)
    assert {(n, a, add) for _k, n, a, add in got} == {
        ("alice", 30, True), ("carol", 22, True)}


def _ilp_rows(db: fakes.QuestDb) -> list:
    """The ILP lines without their designated timestamp (the writer's
    clock), sorted."""
    return sorted(re.sub(r" \d+$", "", ln) for ln in db.lines)


def test_questdb_ilp_write_and_http_read_equal_the_jax_packages():
    def write(pw):
        db = fakes.QuestDb()
        srv = fakes.IlpServer(db)
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.questdb.write(t, "127.0.0.1", table_name="people",
                            port=srv.port)
        return db, srv

    outs = both(write)
    for db, srv in outs:
        srv.drain(2)
        srv.close()
    (got, _), (want, _) = outs
    assert _ilp_rows(got) == _ilp_rows(want)
    assert len(got.lines) == 2
    assert all(ln.startswith("people ") for ln in got.lines)
    assert any('name="alice"' in ln and "age=30i" in ln for ln in got.lines)

    reads = {}
    for pkg, (pw, pg) in PKGS.items():
        db = fakes.QuestDb()
        db.ingest(b'people name="alice",age=30i\npeople name="bob",age=41i\n')
        pg.G.clear()
        try:
            t = pw.io.questdb.read("http://x", "people", schema(pw),
                                   mode="static", _http=db)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            keys, cols = pw.debug.table_to_dicts(t, **kw)
        finally:
            pg.G.clear()
        reads[pkg] = {k: (cols["name"][k], cols["age"][k]) for k in keys}
    assert reads["torch"] == reads["jax"]
    assert sorted(reads["torch"].values()) == [("alice", 30), ("bob", 41)]


# -- DynamoDB and BigQuery ------------------------------------------------------


def test_dynamodb_put_and_delete_equal_the_jax_packages():
    def build(pw):
        store = fakes.Dynamo(key_attrs=("k",))
        t = pw.debug.table_from_rows(kv_schema(pw), STREAM_ROWS,
                                     is_stream=True)
        pw.io.dynamodb.write(t, "people", "k", access_key="k",
                             secret_key="s", _http=store)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    assert list(got.tables["people"].values()) == [
        {"k": {"S": "a"}, "v": {"N": "5"}}]


def test_bigquery_insert_all_equals_the_jax_packages():
    def build(pw):
        store = fakes.BigQuery()
        t = pw.debug.table_from_markdown(TWO_ROWS)
        pw.io.bigquery.write(t, "ds", "tbl", _http=store)
        return store

    got, want = both(build)
    assert got.requests == want.requests
    [(path_ds, rows)] = got.rows.items()
    assert path_ds == ("ds", "tbl")
    assert {r["name"] for _i, r in rows} == {"alice", "bob"}
    assert all(i for i, _r in rows)  # the dedup ids


def test_bigquery_service_account_jwt_verifies():
    """The service-account token request: its JWT verifies with the key's
    public half, in both packages."""
    import base64
    import urllib.parse

    cryptography = pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    import pathway_tpu.io.bigquery as jbq
    import pathway_tpu_torch.io.bigquery as tbq

    assert cryptography
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.private_bytes(serialization.Encoding.PEM,
                            serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption()).decode()
    info = {"client_email": "svc@p.iam.gserviceaccount.com",
            "private_key": pem}
    claims = {}
    for name, bq in (("torch", tbq), ("jax", jbq)):
        sent = {}

        class Reply:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                pass

            def read(self):
                return json.dumps({"access_token": "tok"}).encode()

        def urlopen(req, timeout=None, sent=sent):
            sent["url"], sent["body"] = req.full_url, req.data
            return Reply()

        saved = bq.urllib.request.urlopen
        bq.urllib.request.urlopen = urlopen
        try:
            assert bq._service_account_token(info) == "tok"
        finally:
            bq.urllib.request.urlopen = saved
        assert sent["url"] == "https://oauth2.googleapis.com/token"
        form = dict(urllib.parse.parse_qsl(sent["body"].decode()))
        head, body, sig = form["assertion"].split(".")
        pad = lambda s: base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
        key.public_key().verify(pad(sig), f"{head}.{body}".encode(),
                                padding.PKCS1v15(), hashes.SHA256())
        c = json.loads(pad(body))
        claims[name] = {k: c[k] for k in ("iss", "scope", "aud")}
        assert c["exp"] - c["iat"] == 3600
    assert claims["torch"] == claims["jax"]


def test_dynamodb_write_is_gated_on_the_license(monkeypatch):
    from pathway_tpu.internals.config import pathway_config as jconf
    from pathway_tpu.internals.licensing import MissingLicenseError as JMiss
    from pathway_tpu_torch.internals.config import pathway_config as tconf
    from pathway_tpu_torch.internals.licensing import (
        MissingLicenseError as TMiss)

    for pw, conf, err in ((tpw, tconf, TMiss), (jpw, jconf, JMiss)):
        monkeypatch.setattr(conf, "license_key", None)
        with pytest.raises(err):
            pw.io.dynamodb.write(None, "t", "pk")


# -- the port's decisions on the JAX package's quiet fallbacks ------------------


def _writer(pw, which: str, target):
    t = pw.debug.table_from_rows(kv_schema(pw), [("a", 1)])
    if which == "elasticsearch":
        auth = pw.io.elasticsearch.ElasticSearchAuth("injected",
                                                     client=target)
        pw.io.elasticsearch.write(t, "http://localhost:9200", auth, "idx")
    elif which == "mssql":
        pw.io.mssql.write(t, {"_connection": target}, "changes")
    else:
        getattr(pw.io, which).write(t, {"_connection": target}, "changes")


@pytest.mark.parametrize("which", ["postgres", "mysql", "mssql",
                                   "elasticsearch"])
def test_a_failed_close_fails_the_run(which):
    """The JAX writers swallow a failed ``close``; the port's raise it."""

    def target():
        if which == "elasticsearch":
            t = fakes.EsClient()
        elif which == "postgres":
            t = fakes.PgRecorder()
        else:
            t = fakes.SqliteDbApi(which)
            t.execute("CREATE TABLE changes (k TEXT, v INTEGER, time "
                      "INTEGER, diff INTEGER)")
        t.fail_close = True
        return t

    run("jax", lambda pw: _writer(pw, which, target()))
    with pytest.raises(Exception, match="close refused"):
        run("torch", lambda pw: _writer(pw, which, target()))


def test_elasticsearch_ignores_only_an_absent_document_on_delete():
    def build(pw, fail):
        es = fakes.EsClient()
        es.fail_delete = fail
        # a retraction of a document never indexed: the first delete of
        # an absent document
        t = pw.debug.table_from_rows(kv_schema(pw), [("a", 1, 2, -1)],
                                     is_stream=True)
        auth = pw.io.elasticsearch.ElasticSearchAuth("injected", client=es)
        pw.io.elasticsearch.write(t, "http://localhost:9200", auth, "idx")
        return es

    for pkg in PKGS:
        es = run(pkg, lambda pw: build(pw, False))
        assert [op for op, *_r in es.ops] == ["delete"]
        with pytest.raises(Exception, match="service unavailable"):
            run(pkg, lambda pw: build(pw, True))


def test_a_failed_commit_after_a_mysql_read_is_not_swallowed():
    """The JAX source swallows a failed commit after its SELECT; the
    port's static read fails, and a streaming poll counts it as failed
    (pymysql and mysqlclient commit without error under autocommit, so
    a failing commit is a broken connection)."""
    from pathway_tpu_torch.io.mysql import MysqlSnapshotSource

    def db():
        d = fakes.SqliteDbApi("mysql")
        d.execute("CREATE TABLE users (name TEXT PRIMARY KEY, age INTEGER)")
        d.execute("INSERT INTO users VALUES ('alice', 30)")
        d.fail_commit = True
        return d

    def static(pw):
        seen: list = []
        t = pw.io.mysql.read({"_connection": db()}, "users", schema(pw),
                             mode="static")
        subscribed(pw, t, seen)
        return seen

    assert len(run("jax", static)) == 1
    with pytest.raises(Exception, match="commit refused"):
        run("torch", static)
    src = MysqlSnapshotSource({"_connection": db()}, "users",
                              schema(tpw), 0.0, "streaming")
    assert src.poll() == [] and src.n_failed_polls == 1


def _failing_source(which: str):
    """A port source whose first poll fails and whose second reads the
    table: ``(source, make the next poll fail)``."""
    from pathway_tpu_torch.io import clickhouse, mssql, mysql, questdb

    S = schema(tpw)
    if which == "mysql":
        db = fakes.SqliteDbApi("mysql")
        db.execute("CREATE TABLE people (name TEXT PRIMARY KEY, age INT)")
        db.execute("INSERT INTO people VALUES ('alice', 30)")
        calls = {"n": 0}

        def connect(settings, real=mysql._connect):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ConnectionError("the server went away")
            return real(settings)

        src = mysql.MysqlSnapshotSource({"_connection": db}, "people", S,
                                        0.0, "streaming")
        return src, connect
    if which == "mssql":
        db = fakes.MssqlCdc("people", ["name", "age"])
        db.upsert(("alice", 30))
        db.fail["max_lsn"] = 1
        return mssql.MssqlCdcSource({"_connection": db}, "people", S,
                                    schema_name="dbo", mode="streaming",
                                    poll_interval_s=0.0), None
    if which == "clickhouse":
        fake = fakes.ClickHouse()
        fake.tables["people"] = [{"name": "alice", "age": 30}]
        fake.fail_next = 1
        return clickhouse.ClickHouseSource(
            clickhouse.ClickHouseSettings(_http=fake), "people", S, 0.0,
            "streaming"), None
    db = fakes.QuestDb()
    db.ingest(b'people name="alice",age=30i\n')
    db.fail_next = 1
    return questdb.QuestDbSource("http://x", "people", S, 0.0, "streaming",
                                 _http=db), None


@pytest.mark.parametrize("which", ["mysql", "mssql", "clickhouse",
                                   "questdb"])
def test_a_failed_poll_is_logged_once_counted_and_retried(which, caplog,
                                                          monkeypatch):
    """The reference's retry policy, kept: a failed poll logs a warning
    and returns nothing; the next poll reads the table.  The port counts
    the failed polls in ``n_failed_polls``."""
    import logging

    src, connect = _failing_source(which)
    if connect is not None:
        from pathway_tpu_torch.io import mysql

        monkeypatch.setattr(mysql, "_connect", connect)
    with caplog.at_level(logging.WARNING,
                         logger=f"pathway_tpu_torch.io.{which}"):
        assert src.poll() == []
        assert src.n_failed_polls == 1
        events = src.poll()
    assert [(r, d) for _t, _k, r, d in events] == [(("alice", 30), 1)]
    assert src.n_failed_polls == 1
    assert sum(f"{which} poll failed" in r.getMessage()
               for r in caplog.records) == 1
