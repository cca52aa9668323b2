"""Postgres output connector (reference: python/pathway/io/postgres/__init__.py
write :605 / write_snapshot :968 over src/connectors/data_storage/postgres.rs).

The DB-API connection comes from one seam (`_connect`) — psycopg/psycopg2
when installed, injectable fakes in tests.  `write` appends a stream of
changes (time/diff columns); `write_snapshot` maintains the live snapshot
keyed on a primary key (INSERT ... ON CONFLICT DO UPDATE / DELETE).
CDC *input* from Postgres rides the debezium format on the kafka connector
(pw.io.debezium).

The port of ``pathway_tpu/io/postgres.py``.  A failed ``close`` raises.
"""

from __future__ import annotations

from typing import Any, Iterable

from ..internals.table import Table
from ._utils import add_output_node


def _connect(postgres_settings: dict):
    injected = postgres_settings.get("_connection")
    if injected is not None:
        return injected
    try:
        import psycopg

        return psycopg.connect(
            **{k: v for k, v in postgres_settings.items() if not k.startswith("_")}
        )
    except ImportError:
        pass
    try:
        import psycopg2

        return psycopg2.connect(
            **{k: v for k, v in postgres_settings.items() if not k.startswith("_")}
        )
    except ImportError as exc:
        raise ImportError(
            "pw.io.postgres requires psycopg or psycopg2 (or an injected "
            "_connection for tests)"
        ) from exc


def _quote_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


class _PostgresWriter:
    def __init__(self, settings: dict, table_name: str, colnames_hint=None,
                 snapshot: bool = False, primary_key: list[str] | None = None,
                 init_mode: str = "default"):
        self.settings = settings
        self.table_name = table_name
        self.snapshot = snapshot
        self.primary_key = primary_key or []
        self.init_mode = init_mode
        self._conn = None
        self._initialized = False

    def _ensure(self, colnames: list[str]):
        if self._conn is None:
            self._conn = _connect(self.settings)
        if not self._initialized:
            self._initialized = True
            if self.init_mode in ("create_if_not_exists", "replace"):
                cur = self._conn.cursor()
                if self.init_mode == "replace":
                    cur.execute(
                        f"DROP TABLE IF EXISTS {_quote_ident(self.table_name)}"
                    )
                cols = ", ".join(f"{_quote_ident(c)} TEXT" for c in colnames)
                extra = "" if self.snapshot else ", time BIGINT, diff BIGINT"
                cur.execute(
                    f"CREATE TABLE IF NOT EXISTS "
                    f"{_quote_ident(self.table_name)} ({cols}{extra})"
                )
                self._conn.commit()
        return self._conn

    def write_batch(self, time_, colnames, updates) -> None:
        from ..engine.types import unwrap_row

        if not updates:
            return
        conn = self._ensure(list(colnames))
        cur = conn.cursor()
        tbl = _quote_ident(self.table_name)
        qcols = [_quote_ident(c) for c in colnames]
        if not self.snapshot:
            # stream of changes: every update appends with time/diff
            sql = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}, time, diff) "
                f"VALUES ({', '.join(['%s'] * (len(qcols) + 2))})"
            )
            for _key, row, diff in updates:
                cur.execute(sql, tuple(unwrap_row(row)) + (time_, diff))
        else:
            pk = self.primary_key or [colnames[0]]
            pk_q = [_quote_ident(c) for c in pk]
            non_pk = [c for c in colnames if c not in pk]
            set_clause = ", ".join(
                f"{_quote_ident(c)} = EXCLUDED.{_quote_ident(c)}" for c in non_pk
            ) or f"{pk_q[0]} = EXCLUDED.{pk_q[0]}"
            upsert = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}) "
                f"VALUES ({', '.join(['%s'] * len(qcols))}) "
                f"ON CONFLICT ({', '.join(pk_q)}) DO UPDATE SET {set_clause}"
            )
            pk_idx = [list(colnames).index(c) for c in pk]
            delete = (
                f"DELETE FROM {tbl} WHERE "
                + " AND ".join(f"{q} = %s" for q in pk_q)
            )
            for _key, row, diff in updates:
                vals = tuple(unwrap_row(row))
                if diff > 0:
                    cur.execute(upsert, vals)
                else:
                    cur.execute(delete, tuple(vals[i] for i in pk_idx))
        conn.commit()

    def close(self) -> None:
        # a failed close raises (the JAX writer swallows it)
        if self._conn is not None:
            self._conn.close()


def write(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    *,
    init_mode: str = "default",
    output_table_type: str = "stream_of_changes",
    primary_key: Iterable[Any] | None = None,
    **kwargs,
) -> None:
    """Reference: io/postgres/__init__.py:605."""
    pk_names = [
        getattr(c, "_name", c) for c in (primary_key or [])
    ]
    add_output_node(
        table,
        _PostgresWriter(
            postgres_settings, table_name,
            snapshot=(output_table_type == "snapshot"),
            primary_key=pk_names,
            init_mode=init_mode,
        ),
    )


def write_snapshot(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    primary_key: Iterable[Any],
    *,
    init_mode: str = "default",
    **kwargs,
) -> None:
    """Reference: io/postgres/__init__.py:968."""
    write(
        table, postgres_settings, table_name,
        init_mode=init_mode, output_table_type="snapshot",
        primary_key=primary_key,
    )
