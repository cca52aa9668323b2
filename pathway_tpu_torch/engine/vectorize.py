"""Vectorized (columnar) expression evaluation.

The port of ``pathway_tpu/engine/vectorize.py``.  The reference evaluates
expressions batch-vectorized per AST node (src/engine/expression.rs
Expressions::eval over whole batches).  Here the same plan compiles twice:

  - a numpy tier (host SIMD) used for any batch over VEC_THRESHOLD rows;
  - a device tier: the same AST over torch on the data plane's device,
    for the numeric outputs of batches of at least the crossover
    (``pw.map.vecplan`` in the planner, 65,536 rows on a fresh host).
    The used numeric columns move to the device once, the outputs are
    evaluated eagerly node by node, and each comes back with one copy.
    It stays eager: a fused program may contract ``a*b+c`` into an FMA,
    and float64 results would then differ in their last bit from
    numpy's and the row interpreter's.

Batches arrive either as row-tuple lists (extracted via try_columns) or as
ColumnarBatch struct-of-arrays (columns reused directly — no per-row
extraction; see engine/columnar.py).

Correctness contract vs the row interpreter:
  - on the numpy tier, any arithmetic fault or unsupported value shape
    raises :class:`RowFallback` and the batch re-runs through the row
    interpreter (which yields per-row Error poisoning).  Division stays
    on numpy: a device's x/0 yields inf where the row interpreter
    poisons with Error;
  - on the device tier, an operand type the numpy tier treats otherwise
    (bool arithmetic, a float under ``~`` or ``&``, a float cast to int)
    raises :class:`Unsupported` before anything of that output is
    launched, and the batch takes the numpy tier.  Nothing else is
    caught: a device that fails raises;
  - integer expressions carry a static magnitude-bound analysis so int64
    can never wrap (inputs are bounded at column-extraction time), keeping
    results byte-identical to Python bignum semantics.
"""

from __future__ import annotations

import time as _time
from typing import Any

import numpy as np

from ..internals import expression as E
from ..internals.value import Error
from .columnar import ColumnarBatch, _INT_LEAF_BOUND

VEC_THRESHOLD = 32
# fresh-host default; a module-level override (test monkeypatch) pins
# it, otherwise the planner's measured pw.map.vecplan crossover applies
# — see _device_threshold()
_DEVICE_THRESHOLD_DEFAULT = 65536
DEVICE_THRESHOLD = _DEVICE_THRESHOLD_DEFAULT


def _device_threshold() -> int:
    """Active device-tier row threshold: an explicit pin (tests
    monkeypatch :data:`DEVICE_THRESHOLD`) wins; otherwise the planner's
    measured device/numpy crossover for the vectorized plan programs."""
    if DEVICE_THRESHOLD != _DEVICE_THRESHOLD_DEFAULT:
        return DEVICE_THRESHOLD
    from ..obs import planner

    return planner.cached_crossover(
        "pw.map.vecplan", default=_DEVICE_THRESHOLD_DEFAULT
    )


# the column magnitude bound is enforced at extraction time in columnar.py;
# 2**44 admits millisecond epoch timestamps while keeping sums analyzable
_INT_LEAF_EXP = _INT_LEAF_BOUND.bit_length() - 1
_INT_SAFE_EXP = 62  # results must provably fit in int64

# observability: which tier actually executed (tests assert on these);
# on the card, the bytes the device tier moved each way and its stream
# time from the first upload to the end of the last output (CUDA events)
STATS = {"np_batches": 0, "device_batches": 0, "row_batches": 0,
         "h2d_bytes": 0, "d2h_bytes": 0, "device_ms": 0.0}


class Unsupported(Exception):
    """An expression or operand the tier cannot evaluate exactly."""


class RowFallback(Exception):
    """The numpy tier met a fault or value that the row interpreter
    owns (its per-row Error poisoning): the caller re-runs the batch
    row by row."""


class _Node:
    __slots__ = ("fn", "kind", "exp", "jaxable", "nonefree")

    def __init__(self, fn, kind: str, exp: int, jaxable: bool = True,
                 nonefree: bool = True):
        self.fn = fn
        self.kind = kind  # "int" | "float" | "bool" | "str" | "any"
        self.exp = exp  # log2 magnitude bound for ints (overflow analysis)
        # may run on the device tier (the JAX package's name is kept)
        self.jaxable = jaxable
        # provably never None within a vectorized batch (input columns are
        # None-free by extraction; method-call results are NOT)
        self.nonefree = nonefree


class Plan:
    """Compiled columnar evaluator. plan(cols, n, device) -> list of
    arrays/scalars."""

    def __init__(self, exprs, nodes: list[_Node], used: set[int], positions):
        self.nodes = nodes
        self.used_columns = used
        self._exprs = exprs
        self._positions = positions
        # the device tier covers the device-capable SUBSET of output
        # expressions (a string passthrough column must not keep the
        # numeric ones off the device); the exact subset depends on
        # runtime column dtypes, so programs are cached per subset
        self._device_static = [i for i, nd in enumerate(nodes) if nd.jaxable]
        self._node_deps: list[set[int]] = []
        for e in exprs:
            deps = set()
            for r in e._dependencies():
                ci = positions.get((id(r.table), r._name))
                if ci is not None:
                    deps.add(ci)
            self._node_deps.append(deps)
        self._device_cache: dict[tuple, Any] = {}

    def _get_device(self, idx: tuple, device):
        key = (idx, str(device))
        if key not in self._device_cache:
            self._device_cache[key] = _build_device(
                [self._exprs[i] for i in idx], self._positions, device
            )
        return self._device_cache[key]

    def _host(self, cols, out: list) -> list:
        """The numpy tier over every output not yet computed.  Error-
        poisoning parity: arithmetic faults (errstate) and anything a
        method call raises abort the columnar path."""
        with np.errstate(divide="raise", invalid="raise", over="raise"):
            try:
                for i, node in enumerate(self.nodes):
                    if out[i] is None:
                        out[i] = node.fn(cols)
            except Exception as exc:  # noqa: BLE001 - host values only
                raise RowFallback(f"{type(exc).__name__}: {exc}") from exc
        return out

    def __call__(self, cols: list, n: int | None = None, device=None):
        """Evaluate the plan over ``cols``.  With a ``device`` and a
        batch of at least the crossover, the numeric outputs run on the
        device tier; the rest (and every output of a smaller batch) on
        numpy.  Raises :class:`RowFallback` where the row interpreter
        must take the batch."""
        if (device is not None and n is not None and self._device_static
                and n >= _device_threshold()):
            numeric = {
                ci
                for ci in self.used_columns
                if isinstance(cols[ci], np.ndarray) and cols[ci].dtype != object
            }
            idx = tuple(
                i for i in self._device_static if self._node_deps[i] <= numeric
            )
            prog = self._get_device(idx, device) if idx else None
            if prog is not None:
                try:
                    douts = prog(cols, n)
                except Unsupported:
                    douts = None  # an operand the numpy tier owns
                if douts is not None:
                    out: list = [None] * len(self.nodes)
                    for i, o in zip(idx, douts):
                        out[i] = o
                    self._host(cols, out)
                    STATS["device_batches"] += 1
                    return out
        out = self._host(cols, [None] * len(self.nodes))
        STATS["np_batches"] += 1
        return out


def compile_plan(exprs, positions: dict[tuple[int, str], int]):
    """Compile expressions to a columnar Plan; None when unsupported."""
    try:
        nodes = [_compile(e, positions) for e in exprs]
    except Unsupported:
        return None

    used: set[int] = set()
    for e in exprs:
        for ref in e._dependencies():
            idx = positions.get((id(ref.table), ref._name))
            if idx is not None:
                used.add(idx)
    return Plan(exprs, nodes, used, positions)


class _Torch:
    """The array namespace of the device tier: the few ``xp`` calls of
    :func:`_compile`, over torch tensors on one device, with operand
    checks where torch and numpy part ways."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.float64 = torch.float64
        self.int64 = torch.int64

    def const(self, v):
        """A constant as a 0-dim tensor of its own dtype: a Python float
        beside an int64 tensor would promote to float32, torch's default
        dtype, where numpy gives float64."""
        t = self.torch
        if isinstance(v, bool):
            dtype = t.bool
        elif isinstance(v, int):
            dtype = t.int64
        else:
            dtype = t.float64
        return t.tensor(v, dtype=dtype, device=self.device)

    def is_bool(self, x) -> bool:
        return isinstance(x, bool) or (
            isinstance(x, self.torch.Tensor) and x.dtype == self.torch.bool)

    def is_float(self, x) -> bool:
        return isinstance(x, float) or (
            isinstance(x, self.torch.Tensor) and x.is_floating_point())

    def binop(self, op: str, fn):
        if op in ("+", "-", "*"):
            def checked(a, b):
                # numpy's bool arithmetic (True + True -> True, bool -
                # bool a TypeError) is not torch's: numpy tier
                if self.is_bool(a) or self.is_bool(b):
                    raise Unsupported(f"bool operand of {op}")
                return fn(a, b)
            return checked
        if op in ("&", "|", "^"):
            def bitwise(a, b):
                if self.is_float(a) or self.is_float(b):
                    raise Unsupported(f"float operand of {op}")
                return fn(a, b)
            return bitwise
        return fn

    def neg(self, a):
        if self.is_bool(a):
            raise Unsupported("negation of a bool")
        return -a

    def invert(self, a):
        if self.is_float(a):
            raise Unsupported("~ of a float")
        if isinstance(a, bool):
            return self.const(not a)
        return ~a

    def where(self, c, a, b):
        t = self.torch
        if not isinstance(c, t.Tensor):
            c = self.const(bool(c))
        elif c.dtype != t.bool:
            c = c != 0  # numpy's truthiness of a numeric condition
        return t.where(c, *(self.const(x) if not isinstance(x, t.Tensor)
                             else x for x in (a, b)))

    def to_float(self, a):
        if not isinstance(a, self.torch.Tensor):
            a = self.const(a)
        return a.to(self.float64)

    def to_int(self, a):
        # numpy raises on a NaN/inf cast (errstate), the row interpreter
        # poisons it; a device cast gives a value: numpy tier
        if self.is_float(a):
            raise Unsupported("float to int cast")
        if not isinstance(a, self.torch.Tensor):
            a = self.const(a)
        return a.to(self.int64)


def _build_device(exprs, positions, device):
    """Device tier: the same AST over torch on ``device``; registered
    in the cost observatory as ``pw.map.vecplan``.  None when an
    expression has no device form."""
    import torch

    from ..obs.profiler import profiled

    xp = _Torch(device)
    try:
        nodes = [_compile(e, positions, xp=xp) for e in exprs]
    except Unsupported:
        return None
    used = sorted(
        {
            positions[(id(r.table), r._name)]
            for e in exprs
            for r in e._dependencies()
            if (id(r.table), r._name) in positions
        }
    )
    pos_map = {ci: j for j, ci in enumerate(used)}
    width = max(used) + 1 if used else 0

    def raw(*arrs):
        cols: list = [None] * width
        for ci, j in pos_map.items():
            cols[ci] = arrs[j]
        return [node.fn(cols) for node in nodes]

    prog = profiled("pw.map.vecplan", raw)
    dev = xp.device
    card = dev.type == "cuda"

    def call(all_cols, n: int):
        arrs = [all_cols[ci] for ci in used]
        if any(
            a is None or not isinstance(a, np.ndarray) or a.dtype == object
            for a in arrs
        ):
            raise Unsupported("non-numeric column in the device tier")
        t0 = _time.perf_counter()
        if card:
            stream = torch.cuda.current_stream(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        ins = [torch.from_numpy(a).to(dev) for a in arrs]
        outs = prog(*ins)
        if card:
            ev[1].record(stream)
        res = []
        for o in outs:
            if isinstance(o, torch.Tensor):
                o = o.cpu()  # on the card: synchronous, past ev[1]
                if card:
                    STATS["d2h_bytes"] += o.numel() * o.element_size()
                o = o.numpy()
            res.append(o)
        if card:
            STATS["h2d_bytes"] += sum(a.nbytes for a in arrs)
            STATS["device_ms"] += ev[0].elapsed_time(ev[1])
        # the copies back closed the window: its event pair has passed
        prog.record_dispatch(_time.perf_counter() - t0, items=n)
        return res

    return call


def _compile(e, positions, xp=np) -> _Node:
    dev = xp is not np
    if isinstance(e, E.ColumnReference):
        if e._name == "id":
            raise Unsupported("id column")
        idx = positions.get((id(e._table), e._name))
        if idx is None:
            raise Unsupported("unknown column")
        # column kind resolved at runtime by try_columns; assume numeric-int
        # bound for the overflow analysis (strings get kind "any")
        return _Node(lambda cols: cols[idx], "any", _INT_LEAF_EXP)
    if isinstance(e, E.ConstExpression):
        v = e._value
        if isinstance(v, str):
            return _Node(lambda cols: v, "str", 0, jaxable=False)
        if isinstance(v, bool):
            kind, exp = "bool", 0
        elif isinstance(v, int):
            kind, exp = "int", max(v.bit_length(), 1)
            if exp > 62:
                raise Unsupported("large int const")
        elif isinstance(v, float):
            kind, exp = "float", 0
        else:
            raise Unsupported("const type")
        c = xp.const(v) if dev else v
        return _Node(lambda cols: c, kind, exp)
    if isinstance(e, E.BinaryOpExpression):
        n1 = _compile(e._left, positions, xp)
        n2 = _compile(e._right, positions, xp)
        op = e._op
        fn = _vec_binop(op, xp)
        if fn is None:
            raise Unsupported(op)
        exp = _bound(op, n1, n2)
        if exp > _INT_SAFE_EXP:
            raise Unsupported("possible int64 overflow")
        f1, f2 = n1.fn, n2.fn
        kind = "bool" if op in _CMP_OPS else "any"
        # division stays on the numpy tier: a device's x/0 yields inf
        # (int: 0) where the row interpreter poisons with Error —
        # errstate parity exists only under numpy
        jaxable = n1.jaxable and n2.jaxable and op not in ("/", "//", "%")
        return _Node(
            lambda cols: fn(f1(cols), f2(cols)), kind, exp,
            jaxable=jaxable,
            nonefree=n1.nonefree and n2.nonefree,
        )
    if isinstance(e, E.UnaryOpExpression):
        n1 = _compile(e._expr, positions, xp)
        f1 = n1.fn
        if e._op == "-":
            neg = xp.neg if dev else (lambda a: -a)
            return _Node(
                lambda cols: neg(f1(cols)), n1.kind, n1.exp + 1, n1.jaxable,
                n1.nonefree,
            )

        if dev:
            def invert(cols):
                return xp.invert(f1(cols))
        else:
            def invert(cols):
                a = np.asarray(f1(cols))
                return ~a

        return _Node(invert, n1.kind, n1.exp, n1.jaxable, n1.nonefree)
    if isinstance(e, E.IfElseExpression):
        nc = _compile(e._cond, positions, xp)
        nt = _compile(e._then, positions, xp)
        ne = _compile(e._else, positions, xp)
        fc, ft, fe = nc.fn, nt.fn, ne.fn
        return _Node(
            lambda cols: xp.where(fc(cols), ft(cols), fe(cols)),
            "any", max(nt.exp, ne.exp),
            nc.jaxable and nt.jaxable and ne.jaxable,
            nc.nonefree and nt.nonefree and ne.nonefree,
        )
    if isinstance(e, E.IsNoneExpression):
        # the static shortcut is only sound for provably None-free operands
        # (input columns); a method-call result CAN be None — row path then
        inner = _compile(e._expr, positions, xp)
        if not inner.nonefree:
            raise Unsupported("is_none over maybe-None operand")
        result = isinstance(e, E.IsNotNoneExpression)
        return _Node(lambda cols: result, "bool", 0)
    if isinstance(e, E.CoalesceExpression):
        # None-free first argument wins outright; maybe-None args (method
        # calls) fall back to the row interpreter
        for a in e._args:
            if isinstance(a, E.ConstExpression) and a._value is None:
                continue
            node = _compile(a, positions, xp)
            if not node.nonefree:
                raise Unsupported("coalesce over maybe-None argument")
            return node
        raise Unsupported("coalesce of all-None")
    if isinstance(e, E.CastExpression):
        inner = _compile(e._expr, positions, xp)
        from ..internals import dtype as dt

        if not inner.nonefree:
            raise Unsupported("cast over maybe-None operand")
        target = e._target.strip_optional()
        fi = inner.fn
        if target == dt.FLOAT:
            if dev:
                def to_float(cols):
                    return xp.to_float(fi(cols))
            else:
                def to_float(cols):
                    return np.asarray(fi(cols), np.float64)
            return _Node(to_float, "float", 0, inner.jaxable)
        if target == dt.INT:
            if dev:
                def to_int(cols):
                    return xp.to_int(fi(cols))
            else:
                def to_int(cols):
                    return np.asarray(fi(cols), np.int64)
            return _Node(to_int, "int", _INT_LEAF_EXP, inner.jaxable)
        raise Unsupported("cast target")
    if isinstance(e, E.MethodCallExpression) and not dev:
        # .dt/.str/.num method calls vectorize as a single fused column map:
        # no per-row env dicts, one Python-level loop per batch (host tier
        # only — the per-value fn is arbitrary Python)
        arg_nodes = [_compile(a, positions, np) for a in e._args]
        fn = e._fn
        if fn is None:
            raise Unsupported("method without fn")
        if len(arg_nodes) == 1:
            f1 = arg_nodes[0].fn

            def mapped(cols, _fn=fn, _f1=f1):
                a = _f1(cols)
                if isinstance(a, np.ndarray):
                    vals = a.tolist()
                elif isinstance(a, list):
                    vals = a
                else:
                    return _fn(a)
                # object dtype: results may be None/heterogeneous, and any
                # consumer must do elementwise Python ops, never list concat
                out = np.empty(len(vals), object)
                out[:] = [_fn(v) for v in vals]
                return out

            return _Node(
                mapped, "any", _INT_LEAF_EXP, jaxable=False, nonefree=False
            )

        fns = [a.fn for a in arg_nodes]

        def mapped_n(cols, _fn=fn, _fns=fns):
            vals = [f(cols) for f in _fns]
            n = None
            for v in vals:
                if isinstance(v, (np.ndarray, list)):
                    n = len(v)
                    break
            if n is None:
                return _fn(*vals)
            lists = [
                v.tolist() if isinstance(v, np.ndarray)
                else (v if isinstance(v, list) else [v] * n)
                for v in vals
            ]
            out = np.empty(n, object)
            out[:] = [_fn(*vs) for vs in zip(*lists)]
            return out

        return _Node(
            mapped_n, "any", _INT_LEAF_EXP, jaxable=False, nonefree=False
        )
    raise Unsupported(type(e).__name__)


_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}


def _bound(op: str, n1: _Node, n2: _Node) -> int:
    if op in _CMP_OPS or op in ("&", "|", "^"):
        return 0
    if op in ("+", "-"):
        return max(n1.exp, n2.exp) + 1
    if op == "*":
        return n1.exp + n2.exp
    if op == "//":
        return n1.exp
    if op == "%":
        return n2.exp
    if op == "/":
        return 0  # float result; errstate traps overflow/div0
    if op == "**":
        raise Unsupported("** not vectorized (unbounded int growth)")
    return 63


def _vec_binop(op: str, xp):
    if op == "/":
        if xp is np:
            return lambda a, b: np.asarray(a, np.float64) / b
        return lambda a, b: xp.to_float(a) / b
    fn = _PY_BINOPS.get(op)
    if fn is None or xp is np:
        return fn
    return xp.binop(op, fn)


_PY_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
    "^": lambda a, b: a ^ b,
}


def try_columns(updates, ncols: int, used: set[int]):
    """Extract used columns as homogeneous numpy arrays.

    ColumnarBatch inputs reuse their cached column arrays (no per-row work).
    Returns None (forcing the row-interpreter path) when a column mixes
    types, contains None/Error, or holds ints outside the overflow-safe
    leaf bound.
    """
    if isinstance(updates, ColumnarBatch):
        cols: list = [None] * max(ncols, len(updates.cols))
        for ci in used:
            arr = updates.np_col(ci)
            if arr is None:
                return None
            cols[ci] = arr
        return cols
    n = len(updates)
    cols = [None] * ncols
    for ci in used:
        kinds = set()
        for _k, row, _d in updates:
            v = row[ci]
            if v is None or isinstance(v, Error):
                return None
            if isinstance(v, (bool, np.bool_)):
                kinds.add("bool")
            elif isinstance(v, (int, np.integer)):
                kinds.add("int")
            elif isinstance(v, (float, np.floating)):
                kinds.add("float")
            elif isinstance(v, str):
                kinds.add("str")
            else:
                return None
            if len(kinds) > 1:
                return None
        kind = kinds.pop() if kinds else "int"
        if kind == "bool":
            # numpy bool arithmetic (True+True -> True) diverges from Python
            # int semantics; bool columns stay on the row interpreter
            return None
        if kind == "int":
            dt_ = np.int64
        elif kind == "float":
            dt_ = np.float64
        else:
            dt_ = object  # strings
        try:
            arr = np.empty(n, dt_)
            for i, (_k, row, _d) in enumerate(updates):
                arr[i] = row[ci]
            if kind == "int" and (
                np.any(arr > _INT_LEAF_BOUND) or np.any(arr < -_INT_LEAF_BOUND)
            ):
                return None
            cols[ci] = arr
        except (TypeError, ValueError, OverflowError):
            return None
    return cols
