"""DataIndex: index-as-a-join over live tables.

The port of ``pathway_tpu/stdlib/indexing/data_index.py`` (reference:
stdlib/indexing/data_index.py:206,278).  ``query()`` is fully incremental
(answers are revised as data changes); ``query_as_of_now()`` is
request/response (answered once, never revised: the serving path).  Both
lower to one engine operator, ``ExternalIndexOperator``, that keeps an
``InnerIndex`` beside the data rows (src/engine/dataflow/operators/
external_index.rs equivalent), registered with the runner's
``register_lowering``.

Three things differ from the JAX package, the last in what is answered:

- the indexed item (and the metadata) of each data row is computed once
  per ``DataIndex``, in one select over the data table, and read by
  every query operator built from it; the JAX operators each compute
  it again, row by row.  An embedder's expression carries a
  ``batch_fn``, so the select embeds a whole update batch in one call,
  and an embedder with ``device_resident=True`` hands the indexes
  ``DeviceVec`` handles;
- nothing is swallowed: a failing ``search_batch`` fails the run (the
  JAX operator retries each query with ``search``), and the index
  pass's serve counters are recorded without a guard;
- an operator snapshot restores the index with the data rows: the durable
  state of the JAX operator is ``DiffOutputOperator``'s (the input rows and
  the last answers) and leaves its ``InnerIndex`` out, so a restored JAX
  index starts empty and finds only the documents of the journal's tail.
  ``restore_state`` here adds every restored data row to the fresh index,
  on the index's device, in one ``add_batch`` where the index has one (a
  ``DeviceVec`` in a snapshot pickles to numpy, so those rows go back to
  the card), and the as-of-now answers not yet retracted are state too.
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable

from ...engine.graph import DiffOutputOperator
from ...engine.runner import _compile, _env_for, register_lowering
from ...engine.types import consolidate
from ...internals import dtype as dt
from ...internals import parse_graph as pg
from ...internals.expression import ColumnExpression, wrap
from ...internals.table import Table
from ...internals.value import Error
from ...obs.tracer import record_span
from ...serve.metrics import serve_stats

# the routing rule of the JAX operator: this many query inserts (or
# more) at one time, with one k and no filter, go to ``search_batch``
BATCH_MIN = 4


class ExternalIndexOperator(DiffOutputOperator):
    """Port 0: queries, port 1: data."""

    _STATE_ATTRS = ("state", "last_out", "emitted")

    def __init__(
        self,
        query_env,
        data_env,
        index_factory: Callable[[], Any],
        query_item_fn,
        data_item_fn,
        data_meta_fn,
        k_fn,
        filter_fn,
        n_data_cols: int,
        as_of_now: bool,
        name="external_index",
    ):
        super().__init__(2, name)
        self.query_env, self.data_env = query_env, data_env
        self.index = index_factory()
        self.query_item_fn = query_item_fn
        self.data_item_fn = data_item_fn
        self.data_meta_fn = data_meta_fn
        self.k_fn = k_fn
        self.filter_fn = filter_fn
        self.n_data_cols = n_data_cols
        self.as_of_now = as_of_now
        self.emitted: dict[int, tuple] = {}  # as-of-now answers
        self._pending: list = []
        # the sizes of the as-of-now index passes, in order
        self.query_batches: list[int] = []

    # -- index maintenance -------------------------------------------------
    def _item(self, key, row):
        """(item, metadata) of a data row; item None when it indexes
        nothing."""
        env = self.data_env.build(key, row)
        item = self.data_item_fn(env)
        if item is None or isinstance(item, Error):
            return None, None
        return item, (self.data_meta_fn(env) if self.data_meta_fn else None)

    def restore_state(self, st) -> None:
        super().restore_state(st)
        keys, items, metas = [], [], []
        for key, row in self.state[1].items():
            item, meta = self._item(key, row)
            if item is not None:
                keys.append(key)
                items.append(item)
                metas.append(meta)
        if hasattr(self.index, "add_batch"):
            self.index.add_batch(keys, items, metas)
        else:
            for key, item, meta in zip(keys, items, metas):
                self.index.add(key, item, meta)

    def pre_apply(self, port, key, row, diff):
        if port != 1:
            return
        if diff > 0:
            item, meta = self._item(key, row)
            if item is None:
                return
            self.index.add(key, item, meta)
        else:
            self.index.remove(key)

    def dirty_keys_for(self, port, key):
        return (key,)

    def process(self, port, updates, time):
        if port == 1:
            # data: every standing query sees the change (query(): marked
            # dirty and revised at flush; as-of-now: answered at flush)
            for key, row, diff in updates:
                self.pre_apply(1, key, row, diff)
                self.state[1].apply(key, row, diff)
            if not self.as_of_now:
                self._dirty.update(self.state[0].keys())
            return
        if not self.as_of_now:
            super().process(port, updates, time)
            return
        # as-of-now: query batches buffer until flush so EVERY data update
        # at this logical time is visible to queries at this time,
        # independent of intra-time arrival order
        self._pending.append(list(updates))

    def flush(self, time):
        if not self.as_of_now:
            super().flush(time)
            return
        for updates in self._pending:
            self._answer_query_batch(updates, time)
        self._pending.clear()

    def _answer_query_batch(self, updates, time):
        # answer query inserts, never revise.  Inserts are answered in
        # arrival order (batched per consecutive run) so a same-batch
        # insert+delete cancels correctly.
        out = []
        pending_inserts: list = []

        def flush_inserts():
            if not pending_inserts:
                return
            n = len(pending_inserts)
            t0 = _time.perf_counter()
            if n >= BATCH_MIN:
                answers = self._answer_batch(pending_inserts)
            else:
                answers = [self._answer(k, r) for k, r in pending_inserts]
            record_span("index.query", t0, _time.perf_counter(),
                        index=self.name, n=n)
            self.query_batches.append(n)
            stats = serve_stats(f"index:{self.name}")
            stats.record_admitted(n)
            stats.record_batch(n)
            stats.record_completed(n)
            for (key, _row), ans in zip(pending_inserts, answers):
                out.append((key, ans, 1))
                self.emitted[key] = ans
            pending_inserts.clear()

        for key, row, diff in updates:
            if diff > 0:
                self.state[0].apply(key, row, diff)
                pending_inserts.append((key, row))
            else:
                flush_inserts()
                self.state[0].apply(key, row, diff)
                prev = self.emitted.pop(key, None)
                if prev is not None:
                    out.append((key, prev, -1))
        flush_inserts()
        if out:
            self.emit(time, consolidate(out))

    def _empty(self) -> tuple:
        return ((), ()) + ((),) * self.n_data_cols

    def _answer_batch(self, inserts: list) -> list[tuple]:
        """As-of-now answers of one pass: one ``search_batch`` when every
        valid query has the same k and there is no filter, else one
        ``search`` per query."""
        if not hasattr(self.index, "search_batch") or self.filter_fn is not None:
            return [self._answer(k, r) for k, r in inserts]
        metas = []
        for key, row in inserts:
            env = self.query_env.build(key, row)
            metas.append((self.query_item_fn(env), self.k_fn(env)))
        valid = [i for i, (q, k) in enumerate(metas)
                 if q is not None and not isinstance(q, Error)
                 and not isinstance(k, Error)]
        answers: list = [self._empty()] * len(inserts)
        ks = {int(metas[i][1]) for i in valid}
        if len(ks) > 1:
            for i in valid:
                answers[i] = self._pack(
                    self.index.search(metas[i][0], int(metas[i][1]), None))
            return answers
        if valid:
            results = self.index.search_batch([metas[i][0] for i in valid],
                                              ks.pop())
            for i, matches in zip(valid, results):
                answers[i] = self._pack(matches)
        return answers

    def _pack(self, matches: list) -> tuple:
        keys = tuple(m[0] for m in matches)
        scores = tuple(float(m[1]) for m in matches)
        cols = []
        for i in range(self.n_data_cols):
            vals = []
            for mk in keys:
                drow = self.state[1].get_row(mk)
                vals.append(drow[i] if drow is not None else None)
            cols.append(tuple(vals))
        return (keys, scores) + tuple(cols)

    def _answer(self, key, row) -> tuple:
        env = self.query_env.build(key, row)
        q = self.query_item_fn(env)
        if q is None or isinstance(q, Error):
            return self._empty()
        k = self.k_fn(env)
        mf = self.filter_fn(env) if self.filter_fn else None
        return self._pack(self.index.search(q, int(k), mf))

    def compute(self, key):
        row = self.state[0].get_row(key)
        if row is None:
            return None
        return self._answer(key, row)


@register_lowering("external_index")
def _lower_external_index(node, lg):
    p = node.params
    qt, data = node.input_tables
    return ExternalIndexOperator(
        _env_for(qt),
        _env_for(data),
        p["index_factory"],
        _compile(p["query_item"]),
        _compile(p["data_item"]),
        _compile(p["data_meta"]) if p.get("data_meta") is not None else None,
        _compile(p["k_expr"]),
        _compile(p["filter_expr"]) if p.get("filter_expr") is not None else None,
        p["n_data_cols"],
        p["as_of_now"],
    )


class DataIndex:
    """An index over ``data_table`` built from ``data_column``;
    ``index_factory()`` makes each query operator's ``InnerIndex`` when
    the graph is lowered (a retriever factory binds the device)."""

    def __init__(
        self,
        data_table: Table,
        data_column: ColumnExpression,
        *,
        index_factory: Callable[[], Any],
        metadata_column: ColumnExpression | None = None,
        embedder: Callable | None = None,
    ):
        self.data_table = data_table
        self.embedder = embedder
        if embedder is not None:
            data_column = embedder(data_column)
        self.data_column = data_table._desugar(data_column)
        self.metadata_column = (
            data_table._desugar(metadata_column)
            if metadata_column is not None else None)
        self.index_factory = index_factory
        # the data rows with their item (and metadata) appended, computed
        # once for every query operator of this index
        extra = {"_pw_index_item": self.data_column}
        if self.metadata_column is not None:
            extra["_pw_index_meta"] = self.metadata_column
        self._items = data_table.with_columns(**extra)

    def _query(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: Any = 3,
        metadata_filter: ColumnExpression | None = None,
        as_of_now: bool,
    ) -> Table:
        deps = [r.table for r in wrap(query_column)._dependencies()
                if isinstance(r.table, Table)]
        if not deps:
            raise ValueError("query column must reference the query table")
        qt = deps[0]
        qcol = qt._desugar(query_column)
        if self.embedder is not None:
            qcol = qt._desugar(self.embedder(qcol))
        k_expr = (qt._desugar(number_of_matches)
                  if isinstance(number_of_matches, ColumnExpression)
                  else wrap(number_of_matches))
        f_expr = (qt._desugar(metadata_filter)
                  if metadata_filter is not None else None)
        data_cols = self.data_table.column_names()
        items = self._items
        node = pg.new_node(
            "external_index",
            [qt, items],
            index_factory=self.index_factory,
            query_item=qcol,
            data_item=items._pw_index_item,
            data_meta=(items._pw_index_meta
                       if self.metadata_column is not None else None),
            k_expr=k_expr,
            filter_expr=f_expr,
            n_data_cols=len(data_cols),
            as_of_now=as_of_now,
        )
        out_names = ["_pw_index_reply_id", "_pw_index_reply_score"] + data_cols
        dtypes: dict[str, dt.DType] = {
            "_pw_index_reply_id": dt.List(dt.POINTER),
            "_pw_index_reply_score": dt.List(dt.FLOAT),
        }
        for n in data_cols:
            dtypes[n] = dt.List(self.data_table._dtype_of(n))
        return Table(node, out_names, dtypes, qt._universe, name="index_reply")

    def query(self, query_column, *, number_of_matches=3, collapse_rows=True,
              metadata_filter=None, **kwargs) -> Table:
        """Answers revised as the data changes."""
        return self._query(query_column, number_of_matches=number_of_matches,
                           metadata_filter=metadata_filter, as_of_now=False)

    def query_as_of_now(self, query_column, *, number_of_matches=3,
                        collapse_rows=True, metadata_filter=None,
                        **kwargs) -> Table:
        """Each query answered once, against the data of its time."""
        return self._query(query_column, number_of_matches=number_of_matches,
                           metadata_filter=metadata_filter, as_of_now=True)
