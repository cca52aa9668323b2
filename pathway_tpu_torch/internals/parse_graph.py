"""Lazy operation graph captured by Table operations.

Reference: python/pathway/internals/parse_graph.py:103 — every Table operation
appends an OpNode; `pw.run()` / debug captures tree-shake and lower the graph
to engine operators (engine/runner.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

_node_counter = itertools.count()


class OpNode:
    """One declarative operation.

    kind: operation name understood by engine/runner.py
    input_tables: upstream Table objects (port order matters)
    params: kind-specific parameters (desugared expressions, callables, specs)
    """

    __slots__ = ("id", "kind", "input_tables", "params", "output_table", "trace")

    def __init__(self, kind: str, input_tables: list, params: dict[str, Any]):
        self.id = next(_node_counter)
        self.kind = kind
        self.input_tables = input_tables
        self.params = params
        self.output_table = None
        from .trace import capture_trace

        self.trace = capture_trace()

    def __repr__(self) -> str:
        return f"OpNode#{self.id}({self.kind})"


class ParseGraph:
    def __init__(self) -> None:
        self.nodes: list[OpNode] = []
        self.outputs: list[OpNode] = []  # sinks registered for pw.run()

    def add(self, node: OpNode) -> OpNode:
        self.nodes.append(node)
        return node

    def add_output(self, node: OpNode) -> OpNode:
        self.add(node)
        self.outputs.append(node)
        return node

    def clear(self) -> None:
        self.nodes.clear()
        self.outputs.clear()


G = ParseGraph()


def new_node(kind: str, input_tables: list, **params: Any) -> OpNode:
    return G.add(OpNode(kind, input_tables, params))


def new_output_node(kind: str, input_tables: list, **params: Any) -> OpNode:
    return G.add_output(OpNode(kind, input_tables, params))
