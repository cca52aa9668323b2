"""Static type inference over expression trees.

Lean equivalent of the reference's type interpreter
(python/pathway/internals/type_interpreter.py, 748 LoC).  Falls back to ANY
rather than rejecting programs; strictness can be tightened per-op later.
"""

from __future__ import annotations

from . import dtype as dt
from . import expression as expr


_ARITH = {"+", "-", "*", "/", "//", "%", "**", "@"}
_CMP = {"==", "!=", "<", "<=", ">", ">="}
_LOGIC = {"&", "|", "^"}


def infer_dtype(e: expr.ColumnExpression) -> dt.DType:
    if e._dtype is not None and e._dtype != dt.ANY:
        return e._dtype
    if isinstance(e, expr.ColumnReference):
        table = e.table
        if e.name == "id":
            return dt.POINTER
        getter = getattr(table, "_dtype_of", None)
        if getter is not None:
            try:
                return getter(e.name)
            except Exception:
                return dt.ANY
        return dt.ANY
    if isinstance(e, expr.ConstExpression):
        return dt.dtype_of_value(e._value)
    if isinstance(e, expr.BinaryOpExpression):
        lt = infer_dtype(e._left).strip_optional()
        rt = infer_dtype(e._right).strip_optional()
        op = e._op
        if op in _CMP:
            return dt.BOOL
        if op in _LOGIC:
            if lt == dt.BOOL and rt == dt.BOOL:
                return dt.BOOL
            if lt == dt.INT and rt == dt.INT:
                return dt.INT
            return dt.ANY
        if op in _ARITH:
            if op == "/":
                if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
                    return dt.FLOAT
            if lt == dt.INT and rt == dt.INT:
                return dt.INT
            if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
                return dt.FLOAT
            if lt == dt.STR and rt == dt.STR and op == "+":
                return dt.STR
            if lt == dt.STR and rt == dt.INT and op == "*":
                return dt.STR
            if isinstance(lt, dt.Array) or isinstance(rt, dt.Array):
                return dt.lub(lt, rt) if isinstance(lt, dt.Array) and isinstance(rt, dt.Array) else dt.ANY_ARRAY
            # datetime arithmetic
            if lt in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                if rt == dt.DURATION:
                    return lt
                if rt == lt and op == "-":
                    return dt.DURATION
            if lt == dt.DURATION:
                if rt == dt.DURATION:
                    return dt.DURATION if op in ("+", "-") else dt.FLOAT if op == "/" else dt.DURATION
                if rt in (dt.INT, dt.FLOAT):
                    return dt.DURATION
                if rt in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and op == "+":
                    return rt
        return dt.ANY
    if isinstance(e, expr.UnaryOpExpression):
        inner = infer_dtype(e._expr).strip_optional()
        if e._op == "~" and inner == dt.BOOL:
            return dt.BOOL
        return inner
    if isinstance(e, (expr.IsNoneExpression, expr.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(e, expr.IfElseExpression):
        return dt.lub(infer_dtype(e._then), infer_dtype(e._else))
    if isinstance(e, expr.CoalesceExpression):
        parts = [infer_dtype(a) for a in e._args]
        stripped = [p.strip_optional() for p in parts]
        out = dt.lub(*stripped)
        if all(p.is_optional() or p == dt.NONE for p in parts):
            return dt.optional(out)
        return out
    if isinstance(e, expr.RequireExpression):
        return dt.optional(infer_dtype(e._val))
    if isinstance(e, expr.CastExpression):
        return e._target
    if isinstance(e, expr.FillErrorExpression):
        return dt.lub(infer_dtype(e._expr), infer_dtype(e._replacement))
    if isinstance(e, expr.ApplyExpression):
        return e._dtype
    if isinstance(e, expr.MethodCallExpression):
        return e._dtype
    if isinstance(e, expr.PointerExpression):
        return e._dtype
    if isinstance(e, expr.MakeTupleExpression):
        return dt.Tuple(*[infer_dtype(a) for a in e._args])
    if isinstance(e, expr.GetExpression):
        obj = infer_dtype(e._obj).strip_optional()
        if isinstance(obj, dt.List):
            return obj.wrapped
        if obj == dt.JSON:
            return dt.JSON
        if isinstance(obj, dt.Tuple):
            if isinstance(e._index, expr.ConstExpression) and isinstance(e._index._value, int):
                i = e._index._value
                if 0 <= i < len(obj.args):
                    return obj.args[i]
            return dt.lub(*obj.args) if obj.args else dt.ANY
        return dt.ANY
    if isinstance(e, expr.ReducerExpression):
        from .reducers import reducer_return_dtype

        return reducer_return_dtype(e)
    return dt.ANY
