"""Google Cloud Pub/Sub sink (reference: python/pathway/io/pubsub/__init__.py:53).

The reference takes a user-constructed `pubsub_v1.PublisherClient`; we keep
that contract — the client object is injected, so there is no google-cloud
dependency here and tests pass a fake with the same `topic_path`/`publish`
surface.  The table must have exactly one binary (`bytes`) column; each
change publishes a message whose body is the cell and whose attributes carry
`pathway_time` / `pathway_diff` (reference semantics).

The port of ``pathway_tpu/io/pubsub.py``.  A publish that failed fails
the run: its future's exception is raised from the next batch or from
``close``, where the JAX package drops it.
"""

from __future__ import annotations

from typing import Any

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.table import Table


class _PubSubWriter:
    def __init__(self, publisher: Any, project_id: str, topic_id: str):
        self.publisher = publisher
        self.topic = publisher.topic_path(project_id, topic_id)
        self._futures: list = []

    def write_batch(self, time_, colnames, updates) -> None:
        for _key, row, diff in updates:
            (data,) = unwrap_row(row)
            if data is None:
                continue
            if isinstance(data, str):
                data = data.encode()
            fut = self.publisher.publish(
                self.topic, data,
                pathway_time=str(time_), pathway_diff=str(diff),
            )
            self._futures.append(fut)
        # bound memory: settle the resolved futures (a failed one raises)
        pending = []
        for f in self._futures:
            if getattr(f, "done", lambda: True)():
                f.result(timeout=0)
            else:
                pending.append(f)
        self._futures = pending

    def close(self) -> None:
        futures, self._futures = self._futures, []
        for f in futures:
            f.result(timeout=30)


def write(table: Table, publisher: Any, project_id: str, topic_id: str,
          *, name: str | None = None, sort_by=None) -> None:
    """Publish the table's stream of changes to a Pub/Sub topic."""
    colnames = table.column_names()
    if len(colnames) != 1:
        raise ValueError(
            "pw.io.pubsub.write expects a table with a single binary column, "
            f"got columns {colnames!r}"
        )
    dtypes = table.schema.dtypes()
    d = dtypes[colnames[0]].strip_optional()
    if d not in (dt.BYTES, dt.STR, dt.ANY):
        raise ValueError(
            "pw.io.pubsub.write expects a binary column, got "
            f"{colnames[0]!r}: {d}"
        )
    pg.new_output_node(
        "output", [table], colnames=colnames,
        writer=_PubSubWriter(publisher, project_id, topic_id),
    )
