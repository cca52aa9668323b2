"""Row transformers — the legacy class-transformer API (the port of
``pathway_tpu/internals/row_transformer.py``).

Reference: python/pathway/internals/row_transformer.py +
graph_runner/row_transformer_operator_handler.py (pointer-chasing
`Computer`s, engine.pyi:476).

    @pw.transformer
    class tree_sum:
        class tree(pw.ClassArg):
            val: pw.input_attribute
            left: pw.input_attribute
            right: pw.input_attribute

            @pw.output_attribute
            def total(self) -> int:
                s = self.val
                if self.left is not None:
                    s += self.transformer.tree[self.left].total
                if self.right is not None:
                    s += self.transformer.tree[self.right].total
                return s

    result = tree_sum(tree=t).tree   # table with column `total`

Execution: one engine operator per output class; at each logical time it
snapshots the argument tables and evaluates output attributes lazily with
memoization (cycles raise), emitting diffs vs the last emitted state — the
same stabilize-per-time discipline as the rest of the engine.
"""

from __future__ import annotations

from typing import Any, Callable

from ..engine.graph import DiffOutputOperator
from ..engine.runner import register_lowering
from . import dtype as dt
from . import parse_graph as pg
from .table import Table, Universe


class input_attribute:  # noqa: N801 - reference-parity name
    def __init__(self, default=...):
        self.default = default


def output_attribute(fn=None, **kwargs):
    if fn is None:
        return lambda f: output_attribute(f, **kwargs)
    fn._pw_output_attribute = True
    return fn


def method(fn=None, **kwargs):
    if fn is None:
        return lambda f: method(f, **kwargs)
    fn._pw_method = True
    return fn


class ClassArg:
    """Base for transformer argument classes; instances are row views."""

    def __init__(self, ctx: "_TransformerContext", class_name: str, key):
        object.__setattr__(self, "_ctx", ctx)
        object.__setattr__(self, "_class_name", class_name)
        object.__setattr__(self, "_key", key)

    @property
    def transformer(self):
        return self._ctx

    @property
    def id(self):
        return self._key

    @property
    def pointer(self):
        return self._key

    def __getattribute__(self, name: str):
        if name.startswith("_") or name in ("transformer", "id", "pointer"):
            return object.__getattribute__(self, name)
        cls_attr = getattr(type(self), name, None)
        if callable(cls_attr) and (
            getattr(cls_attr, "_pw_output_attribute", False)
            or getattr(cls_attr, "_pw_method", False)
        ):
            ctx = object.__getattribute__(self, "_ctx")
            cname = object.__getattribute__(self, "_class_name")
            key = object.__getattribute__(self, "_key")
            if getattr(cls_attr, "_pw_method", False):
                # methods take extra args: return a bound evaluator
                return lambda *a, **kw: cls_attr(self, *a, **kw)
            return ctx.attribute(cname, key, name)
        try:
            return object.__getattribute__(self, name)
        except AttributeError:
            ctx = object.__getattribute__(self, "_ctx")
            cname = object.__getattribute__(self, "_class_name")
            key = object.__getattribute__(self, "_key")
            return ctx.attribute(cname, key, name)


class _TransformerContext:
    """Holds per-time snapshots + memoized attribute evaluation."""

    def __init__(self, spec: dict, states: dict):
        self.spec = spec  # class_name -> (colnames, input_attrs, outputs cls)
        self.states = states  # class_name -> {key: row tuple}
        self.memo: dict = {}
        self._in_progress: set = set()

    def __getattr__(self, name: str):
        if name in self.spec:
            return _ClassView(self, name)
        raise AttributeError(name)

    def attribute(self, class_name: str, key, attr: str):
        colnames, inputs, cls = self.spec[class_name]
        if attr in inputs:
            row = self.states[class_name].get(key)
            if row is None:
                raise KeyError(f"no row {key} in {class_name}")
            return row[colnames.index(attr)]
        fn = getattr(cls, attr, None)
        if fn is None:
            raise AttributeError(f"{class_name}.{attr}")
        memo_key = (class_name, key, attr)
        if memo_key in self.memo:
            return self.memo[memo_key]
        if callable(fn) and (
            getattr(fn, "_pw_output_attribute", False) or getattr(fn, "_pw_method", False)
        ):
            if memo_key in self._in_progress:
                raise RecursionError(
                    f"cyclic attribute dependency at {class_name}.{attr}"
                )
            self._in_progress.add(memo_key)
            try:
                view = cls(self, class_name, key)
                value = fn(view)
            finally:
                self._in_progress.discard(memo_key)
            self.memo[memo_key] = value
            return value
        return fn


class _ClassView:
    def __init__(self, ctx: _TransformerContext, class_name: str):
        self._ctx = ctx
        self._class_name = class_name

    def __getitem__(self, key):
        cls = self._ctx.spec[self._class_name][2]
        return cls(self._ctx, self._class_name, key)


class RowTransformerOperator(DiffOutputOperator):
    """One per output class; ports follow the transformer's table order."""

    def __init__(self, spec: dict, class_order: list[str], out_class: str,
                 out_attrs: list[str], name="row_transformer"):
        super().__init__(len(class_order), name)
        self.spec = spec
        self.class_order = class_order
        self.out_class = out_class
        self.out_attrs = out_attrs

    def dirty_keys_for(self, port, key):
        return ()

    def process(self, port, updates, time):
        st = self.state[port]
        for key, row, diff in updates:
            st.apply(key, row, diff)
        self._dirty.add(0)

    def flush(self, time):
        if not self._dirty:
            return
        self._dirty.clear()
        states = {
            cname: dict(self.state[i].items())
            for i, cname in enumerate(self.class_order)
        }
        ctx = _TransformerContext(self.spec, states)
        target: dict = {}
        out_idx = self.class_order.index(self.out_class)
        for key in self.state[out_idx].keys():
            try:
                row = tuple(
                    ctx.attribute(self.out_class, key, a) for a in self.out_attrs
                )
            except (KeyError, RecursionError):
                continue
            target[key] = row
        out = []
        from ..engine.types import rows_equal

        for key, row in list(self.last_out.items()):
            if key not in target or not rows_equal(target[key], row):
                out.append((key, row, -1))
                del self.last_out[key]
        for key, row in target.items():
            if key not in self.last_out:
                out.append((key, row, 1))
                self.last_out[key] = row
        self.emit(time, out)


@register_lowering("row_transformer")
def _lower_row_transformer(node, lg):
    p = node.params
    return RowTransformerOperator(
        p["spec"], p["class_order"], p["out_class"], p["out_attrs"]
    )


class _TransformerResult:
    def __init__(self, tables: dict[str, Table]):
        self._tables = tables

    def __getattr__(self, name):
        if name in self._tables:
            return self._tables[name]
        raise AttributeError(name)


def transformer(cls):
    """@pw.transformer decorator."""
    class_specs: dict[str, tuple[list[str], set[str], type]] = {}
    class_order: list[str] = []
    for name, inner in vars(cls).items():
        if isinstance(inner, type) and issubclass(inner, ClassArg):
            inputs = {
                n for n, v in vars(inner).items()
                if isinstance(v, input_attribute)
            }
            inputs |= {
                n for n, v in inner.__annotations__.items()
                if v is input_attribute or isinstance(v, input_attribute)
            } if hasattr(inner, "__annotations__") else set()
            class_specs[name] = ([], inputs, inner)
            class_order.append(name)

    def build(*args, **kwargs):
        tables: dict[str, Table] = {}
        for i, a in enumerate(args):
            tables[class_order[i]] = a
        tables.update(kwargs)
        spec = {}
        for cname in class_order:
            t = tables[cname]
            _cols, inputs, inner = class_specs[cname]
            spec[cname] = (t.column_names(), inputs, inner)
        out_tables: dict[str, Table] = {}
        input_tables = [tables[c] for c in class_order]
        for cname in class_order:
            inner = class_specs[cname][2]
            out_attrs = [
                n for n, v in vars(inner).items()
                if callable(v) and getattr(v, "_pw_output_attribute", False)
            ]
            if not out_attrs:
                out_tables[cname] = tables[cname]
                continue
            node = pg.new_node(
                "row_transformer",
                input_tables,
                spec=spec,
                class_order=class_order,
                out_class=cname,
                out_attrs=out_attrs,
            )
            dtypes = {a: dt.ANY for a in out_attrs}
            out_tables[cname] = Table(
                node, out_attrs, dtypes, tables[cname]._universe,
                name=f"transformer_{cname}",
            )
        return _TransformerResult(out_tables)

    build.__name__ = cls.__name__
    return build
