"""Stand-ins for the database and vector-store connectors' far ends, shared
by ``tests/test_torch_io_{databases,vector_stores}.py`` and
``chip_smoke.py``'s phase 4q.  None imports either package, so one class
serves the JAX connector and the port's alike: each test runs the same
program through both, on two fresh copies of a stand-in, and compares
what reached them.

- DB-API connections: ``SqliteDbApi`` runs the MySQL, Postgres and
  SQL Server writers' statements on an in-memory sqlite3 database (their
  placeholders, quotes and upserts rewritten to sqlite's), ``PgRecorder``
  and ``MssqlRecorder`` record statements without a database, and
  ``MssqlCdc`` answers the SQL Server source's snapshot and CDC queries.
- Clients: ``MongoClient`` and ``EsClient`` keep documents in dicts.
- HTTP and sockets: ``ClickHouse``, ``QuestDb``, ``Dynamo``, ``BigQuery``
  and ``VectorStore`` (Pinecone, Qdrant, Chroma, Milvus, Weaviate) keep
  their tables in dicts and record each request.  Each answers
  ``handle(method, path, headers, body) -> (status, reply)``, the
  interface of ``chip_smoke.HttpStandIn``, and hands a connector its
  injectable ``_http`` seam as well.  ``IlpServer`` takes QuestDB's line
  protocol on a 127.0.0.1 socket.
"""

from __future__ import annotations

import bisect
import io
import json
import re
import socket
import sqlite3
import threading
import time
import urllib.error
import urllib.parse

# -- DB-API connections ----------------------------------------------------------


class FailingClose(Exception):
    """What a stand-in's ``close`` (or ``commit``) raises when told to."""


class SqliteDbApi:
    """A DB-API connection of ``dialect`` ("mysql", "postgres" or
    "mssql") over an in-memory sqlite3 database.  ``statements`` records
    each ``(sql, params)`` as the connector sent it.  ``fail_commit``
    and ``fail_close`` make those calls raise."""

    def __init__(self, dialect: str):
        self.dialect = dialect
        self.con = sqlite3.connect(":memory:", check_same_thread=False)
        self.lock = threading.RLock()
        self.statements: list = []
        self.commits = 0
        self.fail_commit = False
        self.fail_close = False

    def translate(self, sql: str) -> str:
        if self.dialect == "mysql":
            sql = sql.replace("%s", "?").replace("`", '"')
            if "ON DUPLICATE KEY UPDATE" in sql:
                head, _tail = sql.split("ON DUPLICATE KEY UPDATE")
                sql = head.replace("INSERT INTO", "INSERT OR REPLACE INTO")
        elif self.dialect == "postgres":
            sql = sql.replace("%s", "?")
        return sql

    def execute(self, sql: str, params=()) -> None:
        """Run ``sql`` (sqlite's own) outside the record: set-up."""
        with self.lock:
            self.con.execute(sql, params)
            self.con.commit()

    def rows(self, sql: str) -> list:
        with self.lock:
            return self.con.execute(sql).fetchall()

    def cursor(self):
        return _SqliteCursor(self)

    def commit(self):
        if self.fail_commit:
            raise FailingClose("commit refused")
        with self.lock:
            self.commits += 1
            self.con.commit()

    def close(self):
        if self.fail_close:
            raise FailingClose("close refused")


class _SqliteCursor:
    def __init__(self, db: SqliteDbApi):
        self.db = db
        self._rows: list = []
        self.rowcount = -1

    def execute(self, sql, params=()):
        self.db.statements.append((sql, tuple(params)))
        with self.db.lock:
            cur = self.db.con.execute(self.db.translate(sql),
                                      tuple(bytes(p) if isinstance(
                                          p, memoryview) else p
                                          for p in params))
            self._rows = cur.fetchall()
            self.rowcount = cur.rowcount
        return self

    def fetchall(self):
        return list(self._rows)

    def fetchone(self):
        return self._rows[0] if self._rows else None


class PgRecorder:
    """A Postgres connection that records ``(sql, params)`` and keeps the
    snapshot table an upsert or a delete leaves, keyed on the first
    parameter."""

    def __init__(self):
        self.statements: list = []
        self.commits = 0
        self.snapshot: dict = {}
        self.fail_close = False

    def cursor(self):
        outer = self

        class _Cur:
            def execute(self, sql, params=()):
                outer.statements.append((sql, tuple(params)))
                if sql.startswith("INSERT") and "ON CONFLICT" in sql:
                    outer.snapshot[params[0]] = tuple(params)
                elif sql.startswith("DELETE"):
                    outer.snapshot.pop(params[0], None)

        return _Cur()

    def commit(self):
        self.commits += 1

    def close(self):
        if self.fail_close:
            raise FailingClose("close refused")


class MssqlRecorder:
    """A SQL Server connection whose cursor reports ``rowcount == -1``
    (NOCOUNT): it records ``(sql, params)`` with the whitespace folded,
    answers the writer's existence probe from the keys inserted so far,
    and refuses any other statement."""

    def __init__(self):
        self.statements: list = []
        self.inserts: list = []
        self.present: set = set()

    def cursor(self):
        outer = self

        class _Cur:
            rowcount = -1

            def __init__(self):
                self._result = []

            def execute(self, sql, params=()):
                q = " ".join(sql.split())
                outer.statements.append((q, tuple(params)))
                self._result = []
                if q.startswith("SELECT 1 FROM"):
                    if params[0] in outer.present:
                        self._result = [(1,)]
                elif q.startswith("INSERT INTO"):
                    outer.present.add(params[0])
                    outer.inserts.append(tuple(params))
                elif not q.startswith(("IF OBJECT_ID", "UPDATE", "DELETE")):
                    raise AssertionError(f"unexpected SQL: {q}")

            def fetchone(self):
                return self._result[0] if self._result else None

        return _Cur()

    def commit(self):
        pass

    def close(self):
        pass


class MssqlCdc:
    """A SQL Server table ``dbo.table`` with change data capture: the
    rows by primary key (the first column), and a change log of ``(lsn, op, *row)`` with the
    operation codes of ``cdc.fn_cdc_get_all_changes_*`` (1 delete, 2
    insert, 3 update-before, 4 update-after).  Each call that changes the
    table takes the next LSN unless it runs inside ``transaction()``,
    which gives all its changes one LSN.  ``cdc_enabled`` (database) and
    ``table_cdc_enabled`` (the capture instance) off make the source's
    startup check fail.  ``queries`` counts the source's queries by kind;
    ``fail`` maps a kind to the number of its next queries that raise."""

    def __init__(self, table: str, columns: list):
        self.table, self.columns = table, list(columns)
        self.rows: dict = {}
        self.changes: list = []
        self._lsns: list = []
        self._lsn = 0
        self._in_tx = False
        self.cdc_enabled = True
        self.table_cdc_enabled = True
        self.lock = threading.RLock()
        self.queries: dict = {}
        self.fail: dict = {}

    # -- the table's writers ---------------------------------------------------
    def transaction(self):
        db = self

        class _Tx:
            def __enter__(self):
                db.lock.acquire()
                db._lsn += 1
                db._in_tx = True

            def __exit__(self, *exc):
                db._in_tx = False
                db.lock.release()

        return _Tx()

    def _log(self, op: int, row: tuple) -> None:
        if not self._in_tx:
            self._lsn += 1
        self.changes.append((self._lsn, op) + tuple(row))
        self._lsns.append(self._lsn)

    def upsert(self, row: tuple) -> None:
        with self.lock:
            key = row[0]
            if key in self.rows:
                self._log(3, self.rows[key])
                self._log(4, row)
            else:
                self._log(2, row)
            self.rows[key] = tuple(row)

    def delete(self, key) -> None:
        with self.lock:
            if key in self.rows:
                self._log(1, self.rows.pop(key))

    def change_key(self, old_key, new_row: tuple) -> None:
        """An UPDATE of the primary-key column: the before-image under the
        old key, the after-image under the new one."""
        with self.lock:
            old = self.rows.pop(old_key)
            self._log(3, old)
            self._log(4, new_row)
            self.rows[new_row[0]] = tuple(new_row)

    # -- the DB-API surface ----------------------------------------------------
    def cursor(self):
        return _MssqlCdcCursor(self)

    def commit(self):
        pass

    def close(self):
        pass


class _MssqlCdcCursor:
    def __init__(self, db: MssqlCdc):
        self.db = db
        self._result: list = []
        self.rowcount = -1

    def _count(self, kind: str) -> None:
        self.db.queries[kind] = self.db.queries.get(kind, 0) + 1
        if self.db.fail.get(kind, 0) > 0:
            self.db.fail[kind] -= 1
            raise ConnectionError("the server went away")

    def execute(self, sql, params=()):
        db = self.db
        q = " ".join(sql.split())
        instance = f"dbo_{db.table}"
        cols = ", ".join(f"[{c}]" for c in db.columns)
        with db.lock:
            if "FROM cdc.change_tables" in q:
                self._count("change_tables")
                if not db.cdc_enabled:
                    raise RuntimeError(
                        "Invalid object name 'cdc.change_tables'")
                self._result = ([(instance,)] if db.table_cdc_enabled
                                and params == (db.table,) else [])
            elif "fn_cdc_get_max_lsn" in q:
                self._count("max_lsn")
                self._result = [(db._lsn.to_bytes(10, "big")
                                 if db._lsn else None,)]
            elif "fn_cdc_get_min_lsn" in q:
                self._count("min_lsn")
                self._result = [((1).to_bytes(10, "big"),)]
            elif "fn_cdc_increment_lsn" in q:
                self._count("increment_lsn")
                cur = int.from_bytes(params[0], "big")
                self._result = [((cur + 1).to_bytes(10, "big"),)]
            elif f"fn_cdc_get_all_changes_{instance}" in q:
                self._count("changes")
                lo = int.from_bytes(params[0], "big")
                hi = int.from_bytes(params[1], "big")
                i = bisect.bisect_left(db._lsns, lo)
                j = bisect.bisect_right(db._lsns, hi)
                self._result = [c[1:] for c in db.changes[i:j]]
            elif q == f"SELECT {cols} FROM [dbo].[{db.table}]":
                self._count("select")
                self._result = list(db.rows.values())
            else:
                raise AssertionError(f"unexpected SQL: {q}")

    def fetchall(self):
        return list(self._result)

    def fetchone(self):
        return self._result[0] if self._result else None


# -- clients --------------------------------------------------------------------


class MongoClient:
    """``client[db][collection]``: ``replace_one``, ``delete_one`` and
    ``find``; ``ops`` records each write as ``(op, collection, _id,
    document)``."""

    def __init__(self):
        self.colls: dict = {}
        self.ops: list = []

    def __getitem__(self, _db):
        client = self

        class _Db:
            def __getitem__(self, name):
                return _Coll(client, name)

        return _Db()


class _Coll:
    def __init__(self, client: MongoClient, name: str):
        self.client, self.name = client, name
        self.docs = client.colls.setdefault(name, {})

    def replace_one(self, flt, doc, upsert=False):
        self.client.ops.append(("replace", self.name, flt["_id"], doc))
        self.docs[flt["_id"]] = doc

    def delete_one(self, flt):
        self.client.ops.append(("delete", self.name, flt["_id"], None))
        self.docs.pop(flt["_id"], None)

    def find(self, _q):
        return [dict(d, _id=i) for i, d in self.docs.items()]


class NotFoundError(Exception):
    """elasticsearch-py's error for an absent document."""

    status_code = 404


class TransportError(Exception):
    status_code = 503


class EsClient:
    """``index``, ``delete`` and ``close`` of elasticsearch-py over a dict;
    ``ops`` records each call.  A delete of an absent document raises
    ``NotFoundError``, as the client does; ``fail_delete`` makes every
    delete raise ``TransportError``, ``fail_close`` the close."""

    def __init__(self):
        self.docs: dict = {}
        self.ops: list = []
        self.fail_delete = False
        self.fail_close = False

    def index(self, index, id, document):
        self.ops.append(("index", index, id, document))
        self.docs[(index, id)] = document

    def delete(self, index, id):
        self.ops.append(("delete", index, id, None))
        if self.fail_delete:
            raise TransportError("service unavailable")
        if (index, id) not in self.docs:
            raise NotFoundError(f"{index}/{id}")
        del self.docs[(index, id)]

    def close(self):
        if self.fail_close:
            raise FailingClose("close refused")


# -- HTTP stores ----------------------------------------------------------------


class HttpStore:
    """``requests`` records ``(method, path, payload)`` of each call, the
    payload parsed from JSON where it is JSON.  A subclass answers
    ``route(method, path, query, headers, payload) -> (status, reply)``.
    ``fail_next`` answers that many requests with a 503."""

    def __init__(self):
        self.lock = threading.RLock()
        self.requests: list = []
        self.fail_next = 0

    def handle(self, method, path, headers, body):
        parts = urllib.parse.urlsplit(path)
        query = dict(urllib.parse.parse_qsl(parts.query))
        try:
            payload = json.loads(body) if body else None
        except ValueError:
            payload = body
        with self.lock:
            self.requests.append((method, path, payload))
            if self.fail_next > 0:
                self.fail_next -= 1
                return 503, {"error": "unavailable"}
            return self.route(method, parts.path, query, headers, payload)


class ClickHouse(HttpStore):
    """ClickHouse's HTTP interface: ``CREATE``/``DROP``/``INSERT ...
    FORMAT JSONEachRow``/``ALTER TABLE ... DELETE WHERE``/``SELECT ...
    FORMAT JSONEachRow`` on ``tables`` (name -> list of row dicts).  As
    a ``ClickHouseSettings._http`` it is called ``(query, body)``."""

    def __init__(self):
        super().__init__()
        self.tables: dict = {}

    def __call__(self, query: str, body: bytes | None = None) -> bytes:
        status, reply = self.handle(
            "POST", "/?" + urllib.parse.urlencode({"query": query}), {},
            body or b"")
        if status != 200:
            raise ConnectionError(f"clickhouse {status}")
        return reply

    def handle(self, method, path, headers, body):
        # JSONEachRow bodies are not one JSON document: keep them raw
        query = dict(urllib.parse.parse_qsl(
            urllib.parse.urlsplit(path).query)).get("query", "")
        with self.lock:
            self.requests.append((method, query, body or b""))
            if self.fail_next > 0:
                self.fail_next -= 1
                return 503, b"unavailable"
            return 200, self._run(query.strip(), body or b"")

    @staticmethod
    def _name(q: str) -> str:
        return q.split("`")[1]

    def _run(self, q: str, body: bytes) -> bytes:
        if q.startswith("CREATE TABLE"):
            self.tables.setdefault(self._name(q), [])
        elif q.startswith("DROP TABLE"):
            self.tables.pop(self._name(q), None)
        elif q.startswith("INSERT INTO"):
            rows = self.tables.setdefault(self._name(q), [])
            rows.extend(json.loads(ln) for ln in body.decode().splitlines()
                        if ln.strip())
        elif q.startswith("ALTER TABLE") and "DELETE WHERE" in q:
            name = self._name(q)
            conds = []
            for c in q.split("DELETE WHERE", 1)[1].split(" AND "):
                col, val = c.strip().split(" = ", 1)
                conds.append((col.strip("`"), _sql_literal(val.strip())))
            self.tables[name] = [
                r for r in self.tables.get(name, [])
                if not all(r.get(c) == v for c, v in conds)]
        elif q.startswith("SELECT"):
            name = q.split("FROM", 1)[1].strip().split("`")[1]
            cols = re.findall(r"`([^`]+)`", q.split("FROM", 1)[0])
            return "\n".join(json.dumps({c: r.get(c) for c in cols})
                             for r in self.tables.get(name, [])).encode()
        return b""


def _sql_literal(s: str):
    if s.startswith("'"):
        return s[1:-1].replace("\\'", "'").replace("\\\\", "\\")
    if s == "NULL":
        return None
    try:
        return int(s)
    except ValueError:
        return float(s)


class QuestDb(HttpStore):
    """QuestDB: ``tables`` (name -> list of row dicts) fed by ``ingest``
    (ILP lines), read by ``GET /exec?query=SELECT "a", "b" FROM "t"``.
    As a ``QuestDbSource._http`` it is called ``(query)``."""

    def __init__(self):
        super().__init__()
        self.tables: dict = {}
        self.lines: list = []

    def ingest(self, data: bytes) -> None:
        with self.lock:
            for ln in data.decode().splitlines():
                if ln.strip():
                    self.lines.append(ln)
                    name, row = parse_ilp(ln)
                    self.tables.setdefault(name, []).append(row)

    def __call__(self, query: str) -> dict:
        status, reply = self.handle(
            "GET", "/exec?" + urllib.parse.urlencode({"query": query}), {},
            b"")
        if status != 200:
            raise ConnectionError(f"questdb {status}")
        return reply

    def route(self, method, path, query, headers, payload):
        if path != "/exec":
            return 404, {"error": path}
        q = query["query"]
        head, _, tail = q.partition(" FROM ")
        cols = re.findall(r'"([^"]+)"', head)
        name = re.findall(r'"([^"]+)"', tail)[0]
        rows = self.tables.get(name, [])
        return 200, {"columns": [{"name": c} for c in cols],
                     "dataset": [[r.get(c) for c in cols] for r in rows],
                     "count": len(rows)}


def _ilp_split(s: str, sep: str) -> list:
    """Split ``s`` on ``sep`` outside double quotes and escapes."""
    out, cur, quoted, i = [], [], False, 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            cur.append(s[i:i + 2])
            i += 2
            continue
        if ch == '"':
            quoted = not quoted
        if ch == sep and not quoted:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    out.append("".join(cur))
    return out


def _ilp_unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


def parse_ilp(line: str) -> tuple[str, dict]:
    """One InfluxDB line-protocol line: the measurement and its fields
    (``123i`` an int, ``"..."`` a string, ``t``/``f`` a bool, else a
    float), with the timestamp under ``"ts"`` when it is there."""
    parts = _ilp_split(line, " ")
    name = _ilp_unescape(parts[0])
    row: dict = {}
    for f in _ilp_split(parts[1], ","):
        k, v = f.split("=", 1) if "\\=" not in f else _ilp_kv(f)
        k = _ilp_unescape(k)
        if v.startswith('"'):
            row[k] = _ilp_unescape(v[1:-1])
        elif v.endswith("i"):
            row[k] = int(v[:-1])
        elif v in ("t", "f"):
            row[k] = v == "t"
        else:
            row[k] = float(v)
    if len(parts) > 2:
        row["ts"] = int(parts[2])
    return name, row


def _ilp_kv(f: str) -> tuple[str, str]:
    i = 0
    while True:
        i = f.index("=", i)
        if f[i - 1] != "\\":
            return f[:i], f[i + 1:]
        i += 1


class IlpServer:
    """QuestDB's ILP port on 127.0.0.1 (port 0): every connection's bytes
    go to ``db.ingest`` line by line, as they arrive."""

    def __init__(self, db: QuestDb):
        self.db = db
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        self.conns: list = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        buf = b""
        try:
            while chunk := conn.recv(1 << 16):
                buf += chunk
                head, sep, buf = buf.rpartition(b"\n")
                if sep:
                    self.db.ingest(head + sep)
        except OSError:
            pass
        if buf:
            self.db.ingest(buf)

    def drain(self, n_lines: int, timeout: float = 30.0) -> None:
        """Wait until ``n_lines`` lines have been read (a connection may
        still wait in the listen queue when the writer is done); call it
        before ``close``."""
        deadline = time.monotonic() + timeout
        while len(self.db.lines) < n_lines:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(self.db.lines)} of {n_lines} "
                                   "ILP lines arrived")
            time.sleep(0.005)

    def close(self) -> None:
        for s in [self.srv] + self.conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


class Dynamo(HttpStore):
    """DynamoDB's ``PutItem`` and ``DeleteItem`` (the target in the
    ``x-amz-target`` header) on ``tables`` (name -> {key: item}), keyed
    on ``key_attrs``.  As a writer's ``_http`` it is called ``(url,
    target, payload, headers)``."""

    def __init__(self, key_attrs: tuple):
        super().__init__()
        self.key_attrs = tuple(key_attrs)
        self.tables: dict = {}

    def __call__(self, url, target, payload, headers):
        status, reply = self.handle(
            "POST", "/", {"x-amz-target": target},
            json.dumps(payload).encode())
        if status != 200:
            raise ConnectionError(f"dynamodb {status}")
        return reply

    def _key(self, item: dict) -> tuple:
        return tuple(json.dumps(item[a], sort_keys=True)
                     for a in self.key_attrs if a in item)

    def route(self, method, path, query, headers, payload):
        op = headers.get("x-amz-target", "").rsplit(".", 1)[-1]
        table = self.tables.setdefault(payload["TableName"], {})
        if op == "PutItem":
            table[self._key(payload["Item"])] = payload["Item"]
        elif op == "DeleteItem":
            table.pop(self._key(payload["Key"]), None)
        else:
            return 400, {"__type": "UnknownOperationException"}
        return 200, {}


class BigQuery(HttpStore):
    """``tabledata.insertAll``: ``rows[(dataset, table)]`` gets each row's
    ``json``, with its ``insertId``.  As a writer's ``_http`` it is
    called ``(url, payload, headers)``."""

    def __init__(self):
        super().__init__()
        self.rows: dict = {}

    def __call__(self, url, payload, headers):
        status, reply = self.handle(
            "POST", urllib.parse.urlsplit(url).path, headers,
            json.dumps(payload).encode())
        if status != 200:
            raise ConnectionError(f"bigquery {status}")
        return reply

    def route(self, method, path, query, headers, payload):
        m = re.search(r"/datasets/([^/]+)/tables/([^/]+)/insertAll$", path)
        if m is None or method != "POST":
            return 404, {"error": path}
        dest = self.rows.setdefault(m.groups(), [])
        for r in payload["rows"]:
            dest.append((r["insertId"], r["json"]))
        return 200, {"kind": "bigquery#tableDataInsertAllResponse"}


class VectorStore(HttpStore):
    """The REST calls of Pinecone (``/vectors/upsert``,
    ``/vectors/delete``), Qdrant (``PUT .../points``, ``.../points/
    delete``), Chroma (``.../upsert``, ``.../delete``), Milvus
    (``/v2/vectordb/entities/{upsert,delete}``) and Weaviate
    (``POST /v1/batch/objects``, ``DELETE /v1/objects/{class}/{id}``):
    ``items`` maps an id to ``(vector, metadata)``.  As a writer's
    ``_http`` it is called ``(method, url, payload, headers)``.
    ``upserted_at`` maps an id to the monotonic time of its last
    upsert.  Milvus keys an entity by its ``milvus_pk`` column."""

    def __init__(self, kind: str, milvus_pk: str | None = None):
        super().__init__()
        self.kind = kind
        self.milvus_pk = milvus_pk
        self.items: dict = {}
        self.upserted_at: dict = {}

    def __call__(self, method, url, payload, headers):
        parts = urllib.parse.urlsplit(url)
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        status, reply = self.handle(
            method, path, headers,
            b"" if payload is None else json.dumps(payload).encode())
        if status == 404 and method == "DELETE":
            raise urllib.error.HTTPError(url, 404, "not found", {},
                                         io.BytesIO(b"{}"))
        if not 200 <= status < 300:
            raise ConnectionError(f"{self.kind} {status}")
        return reply if reply != b"" else {}

    def _put(self, i, vector, meta) -> None:
        self.items[i] = (vector, meta)
        self.upserted_at[i] = time.monotonic()

    def route(self, method, path, query, headers, payload):
        k = self.kind
        if k == "pinecone":
            if path.endswith("/vectors/upsert"):
                for v in payload["vectors"]:
                    self._put(v["id"], v["values"], v["metadata"])
                return 200, {"upsertedCount": len(payload["vectors"])}
            if path.endswith("/vectors/delete"):
                for i in payload["ids"]:
                    self.items.pop(i, None)
                return 200, {}
        elif k == "qdrant":
            if method == "PUT" and path.endswith("/points"):
                for p in payload["points"]:
                    self._put(p["id"], p["vector"], p["payload"])
                return 200, {"status": "ok"}
            if path.endswith("/points/delete"):
                for i in payload["points"]:
                    self.items.pop(i, None)
                return 200, {"status": "ok"}
        elif k == "chroma":
            if path.endswith("/upsert"):
                docs = payload.get("documents") or [None] * len(
                    payload["ids"])
                for i, v, m, d in zip(payload["ids"], payload["embeddings"],
                                      payload["metadatas"], docs):
                    self._put(i, v, m if d is None else dict(m, text=d))
                return 200, {}
            if path.endswith("/delete"):
                for i in payload["ids"]:
                    self.items.pop(i, None)
                return 200, {}
        elif k == "milvus":
            if path.endswith("/entities/upsert"):
                for e in payload["data"]:
                    meta = {c: v for c, v in e.items() if c != "vector"}
                    self._put(e[self.milvus_pk], e.get("vector"), meta)
                return 200, {"code": 0, "data": {
                    "upsertCount": len(payload["data"])}}
            if path.endswith("/entities/delete"):
                m = re.fullmatch(r"(\w+) in \[(.*)\]", payload["filter"])
                ids = json.loads(f"[{m.group(2)}]") if m.group(2) else []
                for i in ids:
                    self.items.pop(i, None)
                return 200, {"code": 0}
        elif k == "weaviate":
            if method == "POST" and path == "/v1/batch/objects":
                for o in payload["objects"]:
                    self._put(o["id"], o.get("vector"), o["properties"])
                return 200, [{"id": o["id"], "result": {}}
                             for o in payload["objects"]]
            if method == "DELETE" and path.startswith("/v1/objects/"):
                oid = path.rsplit("/", 1)[1]
                if self.items.pop(oid, None) is None:
                    return 404, {}
                return 204, b""
        return 404, {"error": f"{method} {path}"}
