"""pw.iterate — fixed-point iteration.

The port of ``pathway_tpu/internals/iterate.py``.

Reference: internals/common.py:39 + dataflow.rs:5046 (nested differential
scopes).  TPU-first re-design: instead of nested timestamps, the iterate
operator snapshots its input state at each logical time, runs the loop body
to a fixed point as a sequence of batch sub-executions, and emits the diff
of the result against what it last emitted.  This keeps the outer dataflow
fully incremental while the inner loop is free to use any operator.  The
body's sub-executions run on the outer run's data-plane device.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from ..engine.graph import DiffOutputOperator
from ..engine.runner import GraphRunner, register_lowering
from . import parse_graph as pg
from .datasource import StaticDataSource
from .table import Table, Universe

_DEFAULT_LIMIT = 1000


class _IterationLimit:
    def __init__(self, limit: int = _DEFAULT_LIMIT):
        self.limit = limit


iteration_limit = _IterationLimit


@contextlib.contextmanager
def _fresh_graph():
    old = pg.G
    pg.G = pg.ParseGraph()
    try:
        yield pg.G
    finally:
        pg.G = old


def _run_body_once(
    func: Callable,
    states: dict[str, dict],
    colnames: dict[str, list[str]],
    dtypes: dict[str, dict],
    device,
) -> tuple[dict[str, dict], dict[str, list[str]], dict[str, dict]]:
    """Execute the loop body on static snapshots on ``device``; return
    output states."""
    with _fresh_graph():
        arg_tables = {}
        for name, state in states.items():
            events = [(0, k, row, 1) for k, row in state.items()]
            node = pg.new_node("input", [], source=StaticDataSource(events))
            arg_tables[name] = Table(
                node, colnames[name], dtypes[name], Universe(), name=f"iter_{name}"
            )
        result = func(**arg_tables)
        out_tables = _normalize_result(result)
        sinks = {name: t._materialize_capture() for name, t in out_tables.items()}
        runner = GraphRunner(list(sinks.values()), device=device)
        caps = runner.run_batch()
        out_states = {name: caps[s.id].squash() for name, s in sinks.items()}
        out_colnames = {name: t.column_names() for name, t in out_tables.items()}
        out_dtypes = {name: dict(t._dtypes) for name, t in out_tables.items()}
        return out_states, out_colnames, out_dtypes


def _normalize_result(result) -> dict[str, Table]:
    if isinstance(result, Table):
        return {"__single__": result}
    if isinstance(result, dict):
        return result
    if hasattr(result, "_asdict"):
        return result._asdict()
    if isinstance(result, tuple):
        return {f"t{i}": t for i, t in enumerate(result)}
    raise TypeError("iterate body must return Table(s)")


class IterateOperator(DiffOutputOperator):
    """One engine operator per iterate output table."""

    def __init__(
        self,
        func: Callable,
        in_names: list[str],
        out_name: str,
        colnames: dict[str, list[str]],
        dtypes: dict[str, dict],
        limit: int,
        device,
        name: str = "iterate",
    ):
        super().__init__(len(in_names), name)
        self.func = func
        self.in_names = in_names
        self.out_name = out_name
        self.colnames = colnames
        self.dtypes = dtypes
        self.limit = limit
        self.device = device

    def dirty_keys_for(self, port, key):
        return ()  # custom flush below

    def process(self, port, updates, time):
        st = self.state[port]
        for key, row, diff in updates:
            st.apply(key, row, diff)
        self._dirty.add(0)  # any change triggers recompute

    def flush(self, time):
        if not self._dirty:
            return
        self._dirty.clear()
        states = {
            name: dict(self.state[i].items()) for i, name in enumerate(self.in_names)
        }
        colnames = dict(self.colnames)
        dtypes = dict(self.dtypes)
        fed_back = set(self.in_names)
        final_states = states
        self._last_outs = {}
        for _ in range(self.limit):
            out_states, out_cols, out_dts = _run_body_once(
                self.func, final_states, colnames, dtypes, self.device
            )
            if "__single__" in out_states and len(self.in_names) == 1:
                out_states = {self.in_names[0]: out_states["__single__"]}
                out_cols = {self.in_names[0]: out_cols["__single__"]}
                out_dts = {self.in_names[0]: out_dts["__single__"]}
            converged = True
            next_states = dict(final_states)
            for name in fed_back:
                if name in out_states:
                    if not _states_equal(out_states[name], final_states.get(name, {})):
                        converged = False
                    next_states[name] = out_states[name]
                    colnames[name] = out_cols[name]
                    dtypes[name] = out_dts[name]
            self._last_outs = out_states
            final_states = next_states
            if converged:
                break
        target = (
            self._last_outs.get(self.out_name)
            if self.out_name in self._last_outs
            else final_states.get(self.out_name, {})
        )
        if target is None:
            target = {}
        out = []
        for key, row in self.last_out.items():
            new = target.get(key)
            if new is None or new != row:
                out.append((key, row, -1))
        for key, row in target.items():
            old = self.last_out.get(key)
            if old is None or old != row:
                out.append((key, row, 1))
        self.last_out = dict(target)
        self.emit(time, out)


def _states_equal(a: dict, b: dict) -> bool:
    if len(a) != len(b):
        return False
    from ..engine.types import rows_equal

    for k, row in a.items():
        other = b.get(k)
        if other is None or not rows_equal(row, other):
            return False
    return True


@register_lowering("iterate")
def _lower_iterate(node, lg):
    p = node.params
    return IterateOperator(
        p["func"], p["in_names"], p["out_name"], p["colnames"], p["dtypes"],
        p["limit"], lg.device,
    )


def iterate(func: Callable, iteration_limit: int | None = None, **kwargs: Table):
    """Iterate `func` over the given tables to a fixed point (pw.iterate)."""
    limit = iteration_limit.limit if isinstance(iteration_limit, _IterationLimit) else (
        iteration_limit or _DEFAULT_LIMIT
    )
    in_tables = dict(kwargs)
    in_names = list(in_tables.keys())
    colnames = {n: t.column_names() for n, t in in_tables.items()}
    dtypes = {n: dict(t._dtypes) for n, t in in_tables.items()}

    # probe the body once (on empty inputs) to learn output structure
    with _fresh_graph():
        probe_args = {}
        for name, t in in_tables.items():
            pn = pg.new_node("input", [], source=StaticDataSource([]))
            probe_args[name] = Table(pn, colnames[name], dtypes[name], Universe())
        probe_result = func(**probe_args)
    out_tables = _normalize_result(probe_result)
    single = isinstance(probe_result, Table)

    results: dict[str, Table] = {}
    for out_name, probe_t in out_tables.items():
        node_out_name = (
            in_names[0] if out_name == "__single__" and len(in_names) == 1 else out_name
        )
        n = pg.new_node(
            "iterate",
            list(in_tables.values()),
            func=func,
            in_names=in_names,
            out_name=node_out_name,
            colnames=colnames,
            dtypes=dtypes,
            limit=limit,
        )
        results[out_name] = Table(
            n, probe_t.column_names(), dict(probe_t._dtypes), Universe(),
            name=f"iterate_{out_name}",
        )
    if single:
        return results["__single__"]
    if hasattr(probe_result, "_asdict"):
        return type(probe_result)(**results)
    if isinstance(probe_result, tuple):
        return tuple(results.values())
    return results
