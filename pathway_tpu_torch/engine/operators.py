"""Concrete engine operators.

The port of ``pathway_tpu/engine/operators.py``: the reference's dataflow operators
(src/engine/dataflow.rs — join_tables :2720, group_by_table
:3747, expression tables :1557, connector_table :4022, output :4405).  All
operators are incremental over Z-set update batches; stateless ops stream
per-delta, stateful ops stabilize once per logical time via
DiffOutputOperator.flush.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Iterable

from ..internals.value import ERROR, Error, ref_pair, ref_scalar
from .graph import DiffOutputOperator, KeyedState, Operator
from .types import Key, Row, Time, Update, consolidate, rows_equal


class EnvBuilder:
    """Builds the expression-evaluation environment for a row.

    Maps (table_id, column_name) aliases to positions in the concatenated row
    so that ColumnReferences from any aliased table resolve correctly.
    """

    __slots__ = ("positions",)

    def __init__(self, positions: dict[tuple[int, str], int]):
        self.positions = positions

    @staticmethod
    def single(table_id: int, colnames: list[str]) -> "EnvBuilder":
        return EnvBuilder({(table_id, n): i for i, n in enumerate(colnames)})

    def with_alias(self, table_id: int, colnames: list[str], offset: int = 0) -> "EnvBuilder":
        pos = dict(self.positions)
        for i, n in enumerate(colnames):
            pos[(table_id, n)] = offset + i
        return EnvBuilder(pos)

    def build(self, key: Key, row: Row) -> dict:
        env: dict = {"id": key}
        for alias, i in self.positions.items():
            env[alias] = row[i]
        return env


class InputOperator(Operator):
    """Entry node; the runner pushes update batches into it.

    Large row batches transpose to struct-of-arrays ONCE here, so every
    downstream vectorized operator reuses the columns instead of
    re-extracting them (engine/columnar.py)."""

    def process(self, port: int, updates: list[Update], time: Time) -> None:
        from .columnar import ColumnarBatch
        from .vectorize import VEC_THRESHOLD

        if not isinstance(updates, ColumnarBatch) and len(updates) >= VEC_THRESHOLD:
            cb = ColumnarBatch.from_updates(updates)
            if cb is not None:
                updates = cb
        self.emit(time, updates)


def _batched_columns(raw_exprs) -> list | None:
    """(position, expr) of the columns whose top-level Apply carries a
    ``batch_fn`` over positional arguments (the device-UDF hook)."""
    if raw_exprs is None:
        return None
    from ..internals.expression import ApplyExpression

    batched = [(i, e) for i, e in enumerate(raw_exprs)
               if isinstance(e, ApplyExpression) and e._batch_fn is not None
               and not e._kwargs]
    return batched or None


class StatelessRowwise(Operator):
    """select/with_columns over a single input with deterministic expressions.

    Streams per-delta: f is deterministic, so a retraction maps to the
    retraction of the mapped row (reference: expression_table_deterministic,
    dataflow.rs:1557).  Large homogeneous batches take the columnar
    vectorized path (engine/vectorize.py).
    """

    def __init__(self, env: EnvBuilder, exprs: list[Callable[[dict], Any]],
                 raw_exprs=None, n_in_cols: int = 0, name="", device=None):
        super().__init__(name)
        self.env = env
        self.exprs = exprs
        self.n_in_cols = n_in_cols
        # the data plane's device: the vectorized plans' device tier
        self.device = device
        self._plan = ...  # compiled lazily; None = unsupported
        self._raw_exprs = raw_exprs
        # device-UDF batching: columns whose top-level Apply carries batch_fn
        self._batched = _batched_columns(raw_exprs)

    def _get_plan(self):
        if self._plan is ...:
            from . import vectorize

            if self._raw_exprs is None:
                self._plan = None
            else:
                self._plan = vectorize.compile_plan(self._raw_exprs, self.env.positions)
        return self._plan

    def _process_batched_apply(self, updates, time) -> None:
        """Evaluate batch_fn columns with ONE call per micro-batch (the
        device-UDF hook); other columns row-evaluate."""
        build = self.env.build
        envs = [build(k, r) for k, r, _d in updates]
        n = len(updates)
        out_cols: dict[int, list] = {}
        for i, e in self._batched:
            arg_lists = []
            ok_idx = []
            results: list = [None] * n
            for j, env in enumerate(envs):
                vals = [a._eval(env) for a in e._args]
                if any(isinstance(v, Error) for v in vals):
                    results[j] = ERROR
                elif e._propagate_none and any(v is None for v in vals):
                    results[j] = None
                else:
                    arg_lists.append(vals[0] if len(vals) == 1 else tuple(vals))
                    ok_idx.append(j)
            if ok_idx:
                try:
                    batch_out = list(e._batch_fn(arg_lists))
                    if len(batch_out) != len(ok_idx):
                        raise ValueError(
                            f"batch_fn returned {len(batch_out)} results for "
                            f"{len(ok_idx)} inputs"
                        )
                except Exception:
                    # per-row fallback: only genuinely-failing rows poison,
                    # with error-log provenance (parity with the row path)
                    batch_out = [e._eval(envs[j]) for j in ok_idx]
                for j, v in zip(ok_idx, batch_out):
                    results[j] = v
            out_cols[i] = results
        out: list[Update] = []
        for j, (key, row, diff) in enumerate(updates):
            vals = []
            for i, f in enumerate(self.exprs):
                if i in out_cols:
                    vals.append(out_cols[i][j])
                else:
                    vals.append(f(envs[j]))
            out.append((key, tuple(vals), diff))
        self.emit(time, out)

    def process(self, port, updates, time):
        from .columnar import ColumnarBatch
        from .vectorize import STATS, VEC_THRESHOLD, RowFallback, try_columns

        if self._batched is not None and len(updates) > 1:
            self._process_batched_apply(updates, time)
            return

        plan = self._get_plan() if len(updates) >= VEC_THRESHOLD else None
        if plan is not None:
            cols = try_columns(updates, self.n_in_cols, plan.used_columns)
            if cols is not None:
                import numpy as np

                n = len(updates)
                try:
                    outs = plan(cols, n, self.device)
                except RowFallback:
                    outs = None  # fall back to per-row error poisoning
                if outs is not None:
                    # output columns stay columnar: arrays/lists ride the
                    # ColumnarBatch straight into the next operator
                    out_cols = []
                    for o in outs:
                        if isinstance(o, np.ndarray) and o.ndim == 1:
                            out_cols.append(o)
                        elif isinstance(o, list):
                            out_cols.append(o)
                        else:
                            v = o.item() if isinstance(o, np.ndarray) else o
                            out_cols.append([v] * n)
                    if isinstance(updates, ColumnarBatch):
                        keys, diffs = updates.keys, updates.diffs
                        prevalidated = updates.validated_ids()
                    else:
                        keys = [u[0] for u in updates]
                        diffs = [u[2] for u in updates]
                        prevalidated = {}
                    cb = ColumnarBatch(keys, out_cols, diffs)
                    for ci, o in enumerate(out_cols):
                        if id(o) in prevalidated:
                            cb._np_cache[ci] = o  # passthrough column
                    self.emit(time, cb)
                    return
        if len(updates) >= VEC_THRESHOLD:
            STATS["row_batches"] += 1  # a real fallback, not a tiny batch
        out: list[Update] = []
        build = self.env.build
        exprs = self.exprs
        for key, row, diff in updates:
            e = build(key, row)
            out.append((key, tuple(f(e) for f in exprs), diff))
        self.emit(time, out)


class StatefulRowwise(DiffOutputOperator):
    """Rowwise over multiple same-universe inputs, or non-deterministic UDFs.

    Port 0 is the primary table; extra ports are same-universe tables whose
    columns are referenced.  Output exists only when all inputs have the key.
    A column whose Apply carries a ``batch_fn`` is computed for all of a
    time's changed keys in one call; a call that raises records the error
    and poisons those rows, as a failing row call does.
    """

    def __init__(self, n_inputs: int, env: EnvBuilder, exprs, name="",
                 raw_exprs=None):
        super().__init__(n_inputs, name)
        self.env = env
        self.exprs = exprs
        self._batched = _batched_columns(raw_exprs)
        self._precomputed: dict[Key, dict[int, Any]] = {}

    def _env(self, key: Key) -> dict | None:
        rows = []
        for st in self.state:
            r = st.get_row(key)
            if r is None:
                return None
            rows.append(r)
        return self.env.build(key, tuple(v for r in rows for v in r))

    def compute(self, key: Key) -> Row | None:
        e = self._env(key)
        if e is None:
            return None
        pre = self._precomputed.get(key, {})
        return tuple(pre[i] if i in pre else f(e)
                     for i, f in enumerate(self.exprs))

    def flush(self, time: Time) -> None:
        if self._batched is not None and len(self._dirty) > 1:
            self._precompute_batched()
        try:
            super().flush(time)
        finally:
            self._precomputed.clear()

    def _precompute_batched(self) -> None:
        from ..internals.expression import _record_error

        envs = {k: e for k in self._dirty
                if (e := self._env(k)) is not None}
        for i, e in self._batched:
            todo, vals = [], []
            for key, env in envs.items():
                args = [a._eval(env) for a in e._args]
                if any(isinstance(v, Error) for v in args):
                    out = ERROR
                elif e._propagate_none and any(v is None for v in args):
                    out = None
                else:
                    todo.append(key)
                    vals.append(args[0] if len(args) == 1 else tuple(args))
                    continue
                self._precomputed.setdefault(key, {})[i] = out
            if not todo:
                continue
            try:
                outs = list(e._batch_fn(vals))
                if len(outs) != len(todo):
                    raise ValueError(f"batch_fn returned {len(outs)} results "
                                     f"for {len(todo)} inputs")
            except Exception as exc:
                _record_error(exc, getattr(e._batch_fn, "__name__", "apply"))
                outs = [ERROR] * len(todo)
            for key, out in zip(todo, outs):
                self._precomputed.setdefault(key, {})[i] = out


class StatelessFilter(Operator):
    def __init__(self, env: EnvBuilder, predicate: Callable[[dict], Any],
                 raw_predicate=None, n_in_cols: int = 0, name="", device=None):
        super().__init__(name)
        self.env = env
        self.predicate = predicate
        self.n_in_cols = n_in_cols
        self.device = device
        self._raw = raw_predicate
        self._plan = ...

    def _get_plan(self):
        if self._plan is ...:
            from . import vectorize

            if self._raw is None:
                self._plan = None
            else:
                self._plan = vectorize.compile_plan([self._raw], self.env.positions)
        return self._plan

    def process(self, port, updates, time):
        import numpy as np

        from .columnar import ColumnarBatch
        from .vectorize import STATS, VEC_THRESHOLD, RowFallback, try_columns

        plan = self._get_plan() if len(updates) >= VEC_THRESHOLD else None
        if plan is not None:
            cols = try_columns(updates, self.n_in_cols, plan.used_columns)
            if cols is not None:
                try:
                    [mask] = plan(cols, len(updates), self.device)
                except RowFallback:
                    mask = None
                if mask is not None:
                    mask = np.asarray(mask)
                    if mask.ndim == 0:
                        mask = np.broadcast_to(mask, (len(updates),))
                    if mask.dtype == bool and mask.shape == (len(updates),):
                        if isinstance(updates, ColumnarBatch):
                            self.emit(time, updates.select_mask(mask))
                        else:
                            self.emit(
                                time, [u for u, m in zip(updates, mask) if m]
                            )
                        return
        if len(updates) >= VEC_THRESHOLD:
            STATS["row_batches"] += 1  # a real fallback, not a tiny batch
        out: list[Update] = []
        for key, row, diff in updates:
            v = self.predicate(self.env.build(key, row))
            if isinstance(v, np.generic):
                v = v.item()
            if v is True:
                out.append((key, row, diff))
        self.emit(time, out)


class StatefulFilter(DiffOutputOperator):
    """filter with references to extra same-universe tables."""

    def __init__(self, n_inputs: int, env: EnvBuilder, predicate, name=""):
        super().__init__(n_inputs, name)
        self.env = env
        self.predicate = predicate

    def compute(self, key):
        import numpy as np

        rows = []
        for st in self.state:
            r = st.get_row(key)
            if r is None:
                return None
            rows.append(r)
        joined = tuple(v for r in rows for v in r)
        v = self.predicate(self.env.build(key, joined))
        if isinstance(v, np.generic):
            v = v.item()
        if v is True:
            return rows[0]
        return None


class ReindexOperator(Operator):
    """with_id / with_id_from: derive a new key from the row (dataflow.rs
    reindex; reference Table.with_id_from internals/table.py)."""

    def __init__(self, env: EnvBuilder, key_fn: Callable[[dict], Any], name=""):
        super().__init__(name)
        self.env = env
        self.key_fn = key_fn

    def process(self, port, updates, time):
        out: list[Update] = []
        for key, row, diff in updates:
            new_key = self.key_fn(self.env.build(key, row))
            out.append((new_key, row, diff))
        self.emit(time, out)


class ConcatOperator(Operator):
    """Disjoint union; the Table layer guarantees key-disjointness
    (concat_reindex reindexes first)."""

    def process(self, port, updates, time):
        self.emit(time, updates)


class FlattenOperator(Operator):
    """Explode a sequence column; new key derived from (key, position)
    (reference: flatten_table, dataflow.rs)."""

    def __init__(self, position: int, name=""):
        super().__init__(name)
        self.position = position

    def process(self, port, updates, time):
        out: list[Update] = []
        pos = self.position
        for key, row, diff in updates:
            seq = row[pos]
            if seq is None:
                continue
            if isinstance(seq, Error):
                continue
            import numpy as np

            if isinstance(seq, (str, bytes)):
                items: Iterable = list(seq)
            elif isinstance(seq, np.ndarray):
                items = list(seq)
            else:
                items = seq
            for j, v in enumerate(items):
                nk = ref_scalar(key, j)
                nrow = row[:pos] + (v,) + row[pos + 1 :]
                out.append((nk, nrow, diff))
        self.emit(time, out)


class JoinOperator(Operator):
    """Incremental binary join with inner/left/right/outer modes.


    Re-design of join_tables (dataflow.rs:2720): per-side arrangements keyed
    by join key; each delta joins against the opposite arrangement; outer
    padding rows are maintained via per-join-key multiplicity totals.
    """

    _STATE_ATTRS = ("left", "right", "left_total", "right_total")

    def state_size(self) -> int:
        # retained rows across both arrangements (inner dicts), not the
        # number of distinct join keys
        return sum(len(d) for d in self.left.values()) + sum(
            len(d) for d in self.right.values()
        )

    def __init__(
        self,
        left_env: EnvBuilder,
        right_env: EnvBuilder,
        left_on: list[Callable],
        right_on: list[Callable],
        how: str,
        id_policy: str,
        left_ncols: int,
        right_ncols: int,
        exact_match: bool = False,
        simple_on: tuple | None = None,
        name: str = "",
        device=None,
    ):
        super().__init__(name)
        self.device = device
        self.left_env, self.right_env = left_env, right_env
        self.left_on, self.right_on = left_on, right_on
        self.how = how
        self.id_policy = id_policy
        self.left_ncols, self.right_ncols = left_ncols, right_ncols
        # (left_positions, right_positions) when every on-expr is a plain
        # column of its side — enables the columnar bulk path
        self.simple_on = simple_on
        # durable arrangement state (operator snapshots)
        # jk -> {row_key: (row, count)}
        self.left: dict[Any, dict[Key, tuple[Row, int]]] = defaultdict(dict)
        self.right: dict[Any, dict[Key, tuple[Row, int]]] = defaultdict(dict)
        self.left_total: dict[Any, int] = defaultdict(int)
        self.right_total: dict[Any, int] = defaultdict(int)

    # -- key derivation ----------------------------------------------------
    def _out_key(self, lk: Key, rk: Key) -> Key:
        if self.id_policy == "left":
            return lk
        if self.id_policy == "right":
            return rk
        return ref_pair(lk, rk)

    def _pad_key_left(self, lk: Key) -> Key:
        return lk if self.id_policy == "left" else ref_scalar(lk, None)

    def _pad_key_right(self, rk: Key) -> Key:
        return rk if self.id_policy == "right" else ref_scalar(None, rk)

    def _jk(self, side: str, key: Key, row: Row):
        env = (self.left_env if side == "l" else self.right_env).build(key, row)
        fns = self.left_on if side == "l" else self.right_on
        vals = tuple(f(env) for f in fns)
        if any(isinstance(v, Error) for v in vals):
            return None  # error rows never match
        try:
            hash(vals)
            return vals
        except TypeError:
            from ..internals.value import hash_values

            return ("#h", hash_values(vals))

    @staticmethod
    def _apply(index: dict, totals: dict, jk, key: Key, row: Row, diff: int) -> None:
        side = index[jk]
        cur = side.get(key)
        if cur is None:
            side[key] = (row, diff)
        else:
            crow, c = cur
            if c + diff == 0:
                del side[key]
            else:
                side[key] = (row if diff > 0 else crow, c + diff)
        if not side:
            del index[jk]
        totals[jk] += diff
        if totals[jk] == 0:
            del totals[jk]

    def _bulk_jks(self, side: str, updates):
        """Columnar join-key extraction for plain-column on-exprs: key
        tuples come straight off the batch columns — no per-row env dict,
        no compiled-closure dispatch — with the serial path's exact
        Error/hashability rules.  Validated columns (np_col) provably hold
        no Error/None and only hashable scalars, so their rows skip the
        per-row checks entirely; the tuples still hold the ORIGINAL column
        objects (list_col), so value/identity semantics — NaN keys
        included — match the serial `_jk` walk bit for bit.  Returns
        (jks, codes): jks[i] is row i's join key (None = error row), codes
        the validated int64 key column for single-int-column joins (feeds
        the membership pre-filter), else None."""
        pos = self.simple_on[0] if side == "l" else self.simple_on[1]
        arrs = [updates.np_col(ci) for ci in pos]
        cols = [updates.list_col(ci) for ci in pos]
        if all(a is not None for a in arrs):
            codes = None
            if len(pos) == 1:
                import numpy as np

                if arrs[0].dtype == np.int64:
                    codes = arrs[0]
            return list(zip(*cols)), codes
        jks: list = []
        for vals in zip(*cols):
            if any(isinstance(v, Error) for v in vals):
                jks.append(None)
                continue
            try:
                hash(vals)
            except TypeError:
                from ..internals.value import hash_values

                vals = ("#h", hash_values(vals))
            jks.append(vals)
        return jks, None

    def _bulk_membership(self, codes, build: dict):
        """Inner-join pre-filter: bool mask over the batch marking join
        keys present in the opposite arrangement (mapreduce's vectorized
        ``pw.join.member`` primitive), or None when the arrangement's key
        shapes make int-array equality unsound (a float or bool key can
        equal an int: ``(1.0,) == (1,)``).  A masked-out row provably joins
        nothing AND needs no outer padding (inner mode), so only its own
        arrangement update remains."""
        ks = []
        for k in build:
            if type(k) is tuple and len(k) == 1 and type(k[0]) is int:
                ks.append(k[0])
            else:
                return None
        import numpy as np

        from ..parallel.mapreduce import hash_join_membership

        try:
            barr = np.array(ks, np.int64)
        except OverflowError:
            return None
        return hash_join_membership(codes, barr, device=self.device)

    def process(self, port, updates, time):
        jks = member = None
        if self.simple_on is not None and len(updates) >= 64:
            from .columnar import ColumnarBatch

            if isinstance(updates, ColumnarBatch):
                jks, codes = self._bulk_jks("l" if port == 0 else "r", updates)
                # the opposite arrangement is static for this whole batch
                # (port 0 mutates only left state and vice versa), so one
                # mask is valid for every row
                if self.how == "inner" and codes is not None and len(updates) >= 1024:
                    member = self._bulk_membership(
                        codes, self.right if port == 0 else self.left
                    )
        out: list[Update] = []
        pad_r = (None,) * self.right_ncols
        pad_l = (None,) * self.left_ncols
        for i, (key, row, diff) in enumerate(updates):
            if jks is not None:
                jk = jks[i]
                if jk is None:
                    continue
                if member is not None and not member[i]:
                    if port == 0:
                        self._apply(self.left, self.left_total, jk, key, row, diff)
                    else:
                        self._apply(self.right, self.right_total, jk, key, row, diff)
                    continue
            if port == 0:
                if jks is None:
                    jk = self._jk("l", key, row)
                if jk is None:
                    continue
                # join against current right state
                for rk, (rrow, rc) in list(self.right.get(jk, {}).items()):
                    out.append(
                        (self._out_key(key, rk), row + rrow + (key, rk), diff * rc)
                    )
                if self.how in ("left", "outer") and self.right_total.get(jk, 0) == 0:
                    out.append((self._pad_key_left(key), row + pad_r + (key, None), diff))
                self._apply(self.left, self.left_total, jk, key, row, diff)
                # right-outer padding driven by left-side emptiness changes
                if self.how in ("right", "outer"):
                    lt_new = self.left_total.get(jk, 0)
                    lt_old = lt_new - diff
                    if lt_old == 0 and lt_new != 0:
                        for rk, (rrow, rc) in list(self.right.get(jk, {}).items()):
                            out.append(
                                (self._pad_key_right(rk), pad_l + rrow + (None, rk), -rc)
                            )
                    elif lt_old != 0 and lt_new == 0:
                        for rk, (rrow, rc) in list(self.right.get(jk, {}).items()):
                            out.append(
                                (self._pad_key_right(rk), pad_l + rrow + (None, rk), rc)
                            )
            else:
                if jks is None:
                    jk = self._jk("r", key, row)
                if jk is None:
                    continue
                old_total = self.right_total.get(jk, 0)
                for lk, (lrow, lc) in list(self.left.get(jk, {}).items()):
                    out.append(
                        (self._out_key(lk, key), lrow + row + (lk, key), diff * lc)
                    )
                self._apply(self.right, self.right_total, jk, key, row, diff)
                new_total = self.right_total.get(jk, 0)
                if self.how in ("left", "outer"):
                    if old_total == 0 and new_total != 0:
                        for lk, (lrow, lc) in list(self.left.get(jk, {}).items()):
                            out.append(
                                (self._pad_key_left(lk), lrow + pad_r + (lk, None), -lc)
                            )
                    elif old_total != 0 and new_total == 0:
                        for lk, (lrow, lc) in list(self.left.get(jk, {}).items()):
                            out.append(
                                (self._pad_key_left(lk), lrow + pad_r + (lk, None), lc)
                            )
                if self.how in ("right", "outer"):
                    if self.left_total.get(jk, 0) == 0:
                        out.append(
                            (self._pad_key_right(key), pad_l + row + (None, key), diff)
                        )
        self.emit(time, consolidate(out))


class GroupbyOperator(Operator):
    """Incremental groupby with the full reducer set (dataflow.rs:3747).

    Output stabilizes once per logical time: per dirty group, the operator
    diffs the freshly-computed row against the last emitted one.
    """

    _STATE_ATTRS = ("groups", "last_out")

    def __init__(
        self,
        env: EnvBuilder,
        gb_fns: list[Callable],
        reducers: list[tuple[str, list[Callable], dict]],
        n_out_gvals: int | None = None,
        key_fn: Callable | None = None,
        sort_fn: Callable | None = None,
        simple_spec: tuple | None = None,
        name: str = "",
        device=None,
    ):
        super().__init__(name)
        self.device = device
        self.env = env
        self.gb_fns = gb_fns
        self.n_out_gvals = len(gb_fns) if n_out_gvals is None else n_out_gvals
        self.key_fn = key_fn
        self.sort_fn = sort_fn
        self.reducer_specs = reducers
        # columnar fast path: (gb_positions, [("count",)|("sum",pos)|("avg",pos)])
        self.simple_spec = simple_spec
        self._gkey_cache: dict[tuple, Key] = {}
        # gkey -> (gvals, [ReducerState], count)
        self.groups: dict[Key, list] = {}
        self.last_out: dict[Key, Row] = {}
        self._dirty: set[Key] = set()

    def _process_bulk(self, updates) -> bool:
        """Columnar ingest for plain-column groupings with
        count/sum/avg/min/max reducers: one state update per touched group
        per batch instead of one per row (the wordcount hot path).
        ColumnarBatch inputs read their columns directly — no row tuples
        are ever built."""
        from .columnar import ColumnarBatch

        gb_pos, red_plan = self.simple_spec
        minmax = {i for i, spec in enumerate(red_plan) if spec[0] in ("min", "max")}
        if isinstance(updates, ColumnarBatch):
            gb_cols = [updates.list_col(p) for p in gb_pos]
            val_cols = [
                updates.list_col(spec[1]) if spec[0] != "count" else None
                for spec in red_plan
            ]
            diffs = updates.diffs
            n = len(updates.keys)
        else:
            gb_cols = None
            n = len(updates)
        acc: dict[tuple, list] = {}
        try:
            for j in range(n):
                if gb_cols is not None:
                    gvals = tuple(c[j] for c in gb_cols)
                    diff = diffs[j]
                else:
                    _key, row, diff = updates[j]
                    gvals = tuple(row[p] for p in gb_pos)
                entry = acc.get(gvals)
                if entry is None:
                    # int zeros so integer sums stay int (type parity with
                    # the row path); min/max accumulate value->count dicts
                    entry = acc[gvals] = [
                        0, [({} if i in minmax else 0) for i in range(len(red_plan))]
                    ]
                entry[0] += diff
                sums = entry[1]
                for i, spec in enumerate(red_plan):
                    if spec[0] == "count":
                        continue
                    if gb_cols is not None:
                        v = val_cols[i][j]
                    else:
                        v = row[spec[1]]
                    if v is None or isinstance(v, Error):
                        return False  # slow path handles skips/poison
                    if i in minmax:
                        d = sums[i]
                        d[v] = d.get(v, 0) + diff
                    else:
                        sums[i] += v * diff
        except TypeError:
            return False  # unhashable group values
        from . import reducers_impl

        for gvals, (total_diff, sums) in acc.items():
            gkey = self._gkey_cache.get(gvals)
            if gkey is None:
                gkey = ref_scalar(*gvals)
                if len(self._gkey_cache) < 1_000_000:
                    self._gkey_cache[gvals] = gkey
            group = self.groups.get(gkey)
            if group is None:
                states = [
                    reducers_impl.make_state(rid, kw)
                    for rid, _, kw in self.reducer_specs
                ]
                group = [gvals, states, 0]
                self.groups[gkey] = group
            group[2] += total_diff
            for i, (st, spec, ws) in enumerate(zip(group[1], red_plan, sums)):
                if i in minmax:
                    st.bulk_merge(ws)
                elif spec[0] == "count":
                    st.bulk_add(total_diff, None)
                else:
                    st.bulk_add(total_diff, ws)
            self._dirty.add(gkey)
        return True

    @staticmethod
    def _factorize(arr):
        """(uniq, codes) group factorization: pandas' C hashtable when
        available (O(n) on string columns vs np.unique's comparison sort),
        np.unique otherwise."""
        import numpy as np

        try:
            import pandas as pd

            codes, uniq = pd.factorize(arr)
            if len(codes) and codes.min() < 0:
                return None, None  # null-like slipped through
            return np.asarray(uniq), np.asarray(codes)
        except Exception:
            pass
        try:
            u, c = np.unique(arr, return_inverse=True)
            return u, c
        except Exception:
            return None, None

    def _process_bulk_np(self, batch) -> bool:
        """Factorized columnar ingest (single plain group column): group
        codes via np.unique, count/sum via scatter-add, min/max via a
        lexsort + run-length pass over (code, value) pairs — the whole
        batch reduces in C with one Python step per TOUCHED GROUP, not per
        row.  Falls back (False) whenever types/bounds make the numpy
        result diverge from Python semantics."""
        import numpy as np

        gb_pos, red_plan = self.simple_spec
        if len(gb_pos) != 1:
            return False
        garr = batch.np_col(gb_pos[0])
        if garr is None:
            return False
        n = len(batch.keys)
        diffs = np.asarray(batch.diffs, np.int64)
        total_abs_diff = int(np.sum(np.abs(diffs))) if n else 0
        uniq, codes = self._factorize(garr)
        if uniq is None:
            return False
        val_arrs: list = []
        for spec in red_plan:
            if spec[0] == "count":
                val_arrs.append(None)
                continue
            v = batch.np_col(spec[1])
            if v is None or v.dtype == object:
                return False
            if v.dtype == np.float64 and spec[0] in ("min", "max"):
                if np.any(np.isnan(v)):
                    return False  # NaN breaks multiset netting either way
            if spec[0] in ("sum", "avg") and v.dtype == np.int64:
                # exactness guard: per-batch int sums accumulate in int64
                amax = int(np.max(np.abs(v))) if n else 0
                if amax * max(total_abs_diff, 1) >= 2**62:
                    return False
            val_arrs.append(v)
        # per-shard reduce_sum building block: the scatter-add segment
        # sums route through parallel/mapreduce.py, which picks the exact
        # numpy kernel or the device segment_sum program for int32/
        # float32 at size (exactness-sensitive int64/float64 columns
        # always stay on numpy)
        from ..parallel import mapreduce

        G = len(uniq)
        dev = self.device
        total = mapreduce.segment_sum(diffs, codes, G, device=dev)
        red_results: list = []
        for spec, v in zip(red_plan, val_arrs):
            if spec[0] == "count":
                red_results.append(None)
            elif spec[0] in ("sum", "avg"):
                red_results.append(
                    mapreduce.segment_sum(v, codes, G, weights=diffs,
                                          device=dev)
                )
            else:  # min/max: net (code, value) multiset deltas
                order = np.lexsort((v, codes))
                c_s, v_s, d_s = codes[order], v[order], diffs[order]
                boundary = np.empty(len(order), bool)
                if len(order):
                    boundary[0] = True
                    boundary[1:] = (c_s[1:] != c_s[:-1]) | (v_s[1:] != v_s[:-1])
                starts = np.flatnonzero(boundary)
                netd = np.add.reduceat(d_s, starts) if len(starts) else np.array([])
                red_results.append((c_s[starts], v_s[starts], netd))
        from . import reducers_impl

        uniq_list = uniq.tolist()
        total_list = total.tolist()
        gstates: list = [None] * G
        for gi in range(G):
            gvals = (uniq_list[gi],)
            gkey = self._gkey_cache.get(gvals)
            if gkey is None:
                gkey = ref_scalar(*gvals)
                if len(self._gkey_cache) < 1_000_000:
                    self._gkey_cache[gvals] = gkey
            group = self.groups.get(gkey)
            if group is None:
                states = [
                    reducers_impl.make_state(rid, kw)
                    for rid, _, kw in self.reducer_specs
                ]
                group = [gvals, states, 0]
                self.groups[gkey] = group
            group[2] += total_list[gi]
            gstates[gi] = group[1]
            self._dirty.add(gkey)
        for st_i, (spec, res) in enumerate(zip(red_plan, red_results)):
            if spec[0] == "count":
                for gi in range(G):
                    gstates[gi][st_i].bulk_add(total_list[gi], None)
            elif spec[0] in ("sum", "avg"):
                res_list = res.tolist()
                for gi in range(G):
                    gstates[gi][st_i].bulk_add(total_list[gi], res_list[gi])
            else:
                c_u, v_u, d_u = res
                per_group: dict[int, dict] = {}
                for c, vv, dd in zip(c_u.tolist(), v_u.tolist(), d_u.tolist()):
                    per_group.setdefault(c, {})[vv] = dd
                for gi, vc in per_group.items():
                    gstates[gi][st_i].bulk_merge(vc)
        return True

    def process(self, port, updates, time):
        from . import reducers_impl
        from .columnar import ColumnarBatch

        if self.simple_spec is not None and len(updates) >= 64:
            if (
                isinstance(updates, ColumnarBatch)
                and len(updates) >= 1024
                and self._process_bulk_np(updates)
            ):
                return
            if self._process_bulk(updates):
                return
        for key, row, diff in updates:
            e = self.env.build(key, row)
            gvals = tuple(f(e) for f in self.gb_fns)
            gkey = self.key_fn(e) if self.key_fn is not None else ref_scalar(*gvals)
            group = self.groups.get(gkey)
            if group is None:
                states = [
                    reducers_impl.make_state(rid, kw) for rid, _, kw in self.reducer_specs
                ]
                group = [gvals, states, 0]
                self.groups[gkey] = group
            group[2] += diff
            # ordering key for tuple/ndarray/earliest reducers: sort_by wins,
            # row key breaks ties (reference: sort_by in group_by_table)
            okey = key if self.sort_fn is None else (_sort_key(self.sort_fn(e)), key)
            for (rid, arg_fns, kw), st in zip(self.reducer_specs, group[1]):
                args = tuple(f(e) for f in arg_fns)
                st.update(args, diff, time, okey)
            self._dirty.add(gkey)

    def flush(self, time):
        if not self._dirty:
            return
        out: list[Update] = []
        for gkey in self._dirty:
            group = self.groups.get(gkey)
            old = self.last_out.get(gkey)
            if group is None or group[2] <= 0:
                # negative counts are kept: a retraction can precede its
                # matching insertion across logical times; the group resolves
                # to 0 (and is dropped) once the insertion arrives
                if group is not None and group[2] == 0:
                    del self.groups[gkey]
                if old is not None:
                    out.append((gkey, old, -1))
                    del self.last_out[gkey]
                continue
            new_row = tuple(group[0][: self.n_out_gvals]) + tuple(
                st.value() for st in group[1]
            )
            if rows_equal(new_row, old):
                continue
            if old is not None:
                out.append((gkey, old, -1))
            out.append((gkey, new_row, 1))
            self.last_out[gkey] = new_row
        self._dirty.clear()
        self.emit(time, consolidate(out))


def _sort_key(v):
    # totally-ordered wrapper for heterogeneous sort values
    if v is None:
        return (0, 0)
    try:
        v < v  # comparability probe
        return (1, v)
    except TypeError:
        from ..internals.value import hash_values

        return (2, hash_values(v))


class IxOperator(DiffOutputOperator):
    """Pointer lookup: output[src_key] = target_row[ptr(src_row)]
    (reference: ix/ix_ref, internals/table.py; restrict/with_universe_of uses
    the identity pointer)."""

    _STATE_ATTRS = ("state", "last_out", "fwd", "rev")

    def __init__(
        self,
        src_env: EnvBuilder,
        ptr_fn: Callable[[dict], Any],
        optional: bool,
        target_ncols: int,
        name: str = "",
    ):
        super().__init__(2, name)
        self.src_env = src_env
        self.ptr_fn = ptr_fn
        self.optional = optional
        self.target_ncols = target_ncols
        self.fwd: dict[Key, Any] = {}
        self.rev: dict[Any, set[Key]] = defaultdict(set)

    def _ptr(self, key: Key, row: Row):
        return self.ptr_fn(self.src_env.build(key, row))

    def pre_apply(self, port, key, row, diff):
        if port != 0:
            return
        if diff > 0:
            ptr = self._ptr(key, row)
            old = self.fwd.get(key)
            if old is not None and old != ptr:
                self.rev[old].discard(key)
            self.fwd[key] = ptr
            self.rev[ptr].add(key)
        # retractions keep reverse entries until recompute; harmless

    def dirty_keys_for(self, port, key):
        if port == 0:
            return (key,)
        return tuple(self.rev.get(key, ()))

    def compute(self, key):
        srow = self.state[0].get_row(key)
        if srow is None:
            return None
        ptr = self._ptr(key, srow)
        if ptr is None:
            if self.optional:
                return (None,) * self.target_ncols
            # non-optional lookup of a null pointer: poisoned row
            # (reference: ix errors on missing keys rather than dropping)
            return (ERROR,) * self.target_ncols
        trow = self.state[1].get_row(ptr)
        if trow is None:
            if self.optional:
                return (None,) * self.target_ncols
            # missing target key: Error row, not a silent drop — this is
            # what makes with_universe_of misuse visible (universe algebra
            # says the universes are equal; the data disagrees)
            return (ERROR,) * self.target_ncols
        return trow


class DifferenceOperator(DiffOutputOperator):
    def __init__(self, name=""):
        super().__init__(2, name)

    def compute(self, key):
        if key in self.state[1]:
            return None
        return self.state[0].get_row(key)


class IntersectOperator(DiffOutputOperator):
    def __init__(self, n_inputs: int, name=""):
        super().__init__(n_inputs, name)

    def compute(self, key):
        for st in self.state[1:]:
            if key not in st:
                return None
        return self.state[0].get_row(key)


class UpdateRowsOperator(DiffOutputOperator):
    """other's rows override self's by key (internals/table.py update_rows)."""

    def __init__(self, name=""):
        super().__init__(2, name)

    def compute(self, key):
        r = self.state[1].get_row(key)
        if r is not None:
            return r
        return self.state[0].get_row(key)


class UpdateCellsOperator(DiffOutputOperator):
    """Override a subset of columns for matching keys (update_cells)."""

    def __init__(self, positions: list[int], name=""):
        super().__init__(2, name)
        self.positions = positions

    def compute(self, key):
        base = self.state[0].get_row(key)
        if base is None:
            return None
        over = self.state[1].get_row(key)
        if over is None:
            return base
        row = list(base)
        for i, pos in enumerate(self.positions):
            row[pos] = over[i]
        return tuple(row)


class DeduplicateOperator(Operator):
    """Stateful deduplication with a user acceptor
    (reference: deduplicate, dataflow.rs:3858; stdlib/stateful/deduplicate.py)."""

    _STATE_ATTRS = ("accepted",)

    def __init__(
        self,
        env: EnvBuilder,
        value_fn: Callable,
        instance_fns: list[Callable],
        acceptor: Callable[[Any, Any], bool],
        name: str = "",
    ):
        super().__init__(name)
        self.env = env
        self.value_fn = value_fn
        self.instance_fns = instance_fns
        self.acceptor = acceptor
        # instance_key -> (value, row)
        self.accepted: dict[Key, tuple[Any, Row]] = {}
        self._pending_out: list[Update] = []

    def process(self, port, updates, time):
        for key, row, diff in updates:
            if diff <= 0:
                continue  # deduplicate consumes append-only streams
            e = self.env.build(key, row)
            value = self.value_fn(e)
            ivals = tuple(f(e) for f in self.instance_fns)
            ikey = ref_scalar(*ivals) if ivals else ref_scalar(None)
            cur = self.accepted.get(ikey)
            # first value is always accepted (reference:
            # expression_evaluator deduplicate — `state is None or acceptor(...)`)
            accept = cur is None or bool(self.acceptor(value, cur[0]))
            if accept:
                if cur is not None:
                    self._pending_out.append((ikey, cur[1], -1))
                self.accepted[ikey] = (value, row)
                self._pending_out.append((ikey, row, 1))

    def flush(self, time):
        if self._pending_out:
            self.emit(time, consolidate(self._pending_out))
            self._pending_out = []


class OutputOperator(Operator):
    """Terminal sink: consolidates per time and invokes a callback
    (reference: output_table/subscribe_table, dataflow.rs:4405,4510).

    With terminate_on_error set, an Error value reaching the sink aborts the
    run (reference: terminate_on_error flag; handled errors never reach
    sinks because fill_error replaced them upstream)."""

    terminate_on_error = False

    def __init__(
        self,
        on_time: Callable[[Time, list[Update]], None],
        on_end: Callable[[], None] | None = None,
        name: str = "",
    ):
        super().__init__(name)
        self._on_time = on_time
        self._on_end = on_end
        self._buffer: list[Update] = []

    def process(self, port, updates, time):
        self._buffer.extend(updates)

    def flush(self, time):
        if self._buffer:
            batch = consolidate(self._buffer)
            self._buffer = []
            if batch:
                if self.terminate_on_error:
                    for _k, row, _d in batch:
                        if any(isinstance(v, Error) for v in row):
                            detail = ""
                            from .telemetry import global_error_log

                            if global_error_log.entries:
                                e = global_error_log.entries[-1]
                                detail = f"; last error: {e['message']}"
                                if e.get("trace"):
                                    detail += f" at {e['trace']}"
                            raise RuntimeError(
                                "Error value reached an output "
                                "(terminate_on_error is set); use "
                                f"pw.fill_error to handle it{detail}"
                            )
                self._on_time(time, batch)

    def on_end(self):
        # idempotent: the streaming loop may close a sink early (all of its
        # upstream sources finished) and the final drain calls again
        if self._on_end is not None:
            cb, self._on_end = self._on_end, None
            cb()
