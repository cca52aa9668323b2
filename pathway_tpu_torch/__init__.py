"""PyTorch/CUDA port of ``pathway_tpu``: the data plane and the RAG
serving path.

The data plane (``pw.Table``, expressions, the dataflow runner and its
operators, ``debug``, ``run`` and ``io.subscribe``) runs its three device
programs — the vectorized expression tier, the segment reductions and
the join membership (``engine/vectorize.py``, ``parallel/mapreduce.py``)
— in PyTorch on the data plane's device.

The generation half (``kvcache.engine.PagedDecodeEngine`` over the paged
KV cache, greedy or seeded sampling, with supervised restart,
speculative decoding and optionally int8-resident weights;
``kvcache.statecache.StateDecodeEngine``, the constant-memory SSD
engine; ``models.decoder.TorchDecoderLM.generate`` over a dense cache;
``models.host_decoder.Int8DecoderHost``, the int8 host tier on the
CPU) and the retrieval half (``models.encoder.TorchEncoder`` plus
``stdlib.indexing.inner_index.BruteForceKnn``) run on one NVIDIA H100.
The four TPU kernels on that path are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first launch (``ops/_cuda.py``).

The package imports ``torch`` and nothing of JAX or ``pathway_tpu``;
module layout follows ``pathway_tpu`` so each module's counterpart is
found under the same path.  Entry points take ``device`` (default
``"cuda"``) and raise when no card is present unless ``device="cpu"``.
Importing the package initialises no CUDA context.
"""

from __future__ import annotations

from ._device import resolve_device, resolve_dtype
from .internals import dtype as _dt
from .internals import reducers
from .internals.dtype import DType
from .internals.expression import (
    ApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnExpression,
    ColumnReference,
    ConvertExpression,
    FillErrorExpression,
    IfElseExpression,
    MakeTupleExpression,
    RequireExpression,
    unwrap_value,
    wrap,
)
from .internals.run import run, run_all
from .internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from .internals.table import GroupedTable, JoinResult, Table, Universe
from .internals.thisclass import left, right, this
from .internals.value import ERROR, PENDING, Json, Pointer

# -- dtype aliases (pw.INT etc. as in reference engine types) ---------------
INT = int
FLOAT = float
BOOL = bool
STR = str
BYTES = bytes
DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
DATE_TIME_UTC = _dt.DATE_TIME_UTC
DURATION = _dt.DURATION


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


# -- expression constructors -------------------------------------------------
def apply(fun, *args, **kwargs) -> ApplyExpression:
    """Apply a Python function per row (reference: pw.apply)."""
    return ApplyExpression(fun, _dt.ANY, args, kwargs)


def apply_with_type(fun, ret_type, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, ret_type, args, kwargs)


def if_else(if_clause, then_clause, else_clause) -> IfElseExpression:
    return IfElseExpression(if_clause, then_clause, else_clause)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *deps) -> RequireExpression:
    return RequireExpression(val, *deps)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def cast(target_type, expr) -> CastExpression:
    return CastExpression(target_type, expr)


def unwrap(expr) -> ConvertExpression:
    return ConvertExpression(unwrap_value, wrap(expr))


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def declare_type(target_type, expr) -> ColumnExpression:
    e = wrap(expr)
    e._dtype = _dt.wrap(target_type)
    return e


# -- namespaces --------------------------------------------------------------
from . import debug  # noqa: E402
from . import io  # noqa: E402

__all__ = [
    "resolve_device", "resolve_dtype", "DType", "Schema", "ColumnDefinition",
    "column_definition", "schema_from_dict", "schema_from_pandas",
    "schema_from_types", "Table", "GroupedTable", "JoinResult", "Universe",
    "this", "left", "right", "reducers", "apply", "apply_with_type", "cast",
    "coalesce", "if_else", "require", "make_tuple", "unwrap", "fill_error",
    "declare_type", "ColumnExpression", "ColumnReference", "Json", "Pointer",
    "ERROR", "PENDING", "JoinMode", "INT", "FLOAT", "BOOL", "STR", "BYTES",
    "DATE_TIME_NAIVE", "DATE_TIME_UTC", "DURATION", "debug", "io", "run",
    "run_all",
]
