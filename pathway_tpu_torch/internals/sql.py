"""pw.sql — SQL front-end (the port of ``pathway_tpu/internals/sql.py``;
reference: internals/sql/processing.py via sqlglot).

Minimal dialect: SELECT cols/exprs FROM t [WHERE ...] [GROUP BY ...]; lowered
onto Table.select/filter/groupby.  sqlglot is not available in this
environment, so a small parser covers the common subset; unsupported syntax
raises with a clear message.
"""

from __future__ import annotations

import ast
import re
from typing import Any

from . import reducers
from .expression import ColumnExpression
from .table import Table
from .thisclass import this

_AGGS = {
    "count": reducers.count,
    "sum": reducers.sum,
    "avg": reducers.avg,
    "min": reducers.min,
    "max": reducers.max,
}


def sql(query: str, **tables: Table) -> Table:
    """pw.sql — reference: internals/sql/processing.py (sqlglot transpiler).
    Native mini-transpiler: SELECT/WHERE/GROUP BY/HAVING/JOIN, UNION
    [ALL]/INTERSECT/EXCEPT, subqueries in FROM, WITH CTEs, CASE WHEN,
    BETWEEN, [NOT] IN lists, and the scalar functions IF/COALESCE/IFNULL/
    ABS/ROUND/LOWER/UPPER/LENGTH/CONCAT.

    Dialect notes: ``ROUND`` rounds halves AWAY FROM ZERO (the
    MySQL/Postgres/SQLite convention — ``ROUND(2.5) = 3``), not Python's
    banker's rounding.  ``CONCAT`` treats NULL arguments as the empty
    string (the MySQL ``CONCAT_WS``-style lenient policy) rather than
    propagating NULL; wrap arguments in ``NULLIF``/``IF`` if NULL
    propagation is wanted."""
    q = query.strip().rstrip(";")
    q, tables = _extract_ctes(q, dict(tables))
    return _sql_query(q, tables)


def _extract_ctes(q: str, tables: dict) -> tuple[str, dict]:
    """WITH name AS (query) [, ...] main — each CTE evaluates against the
    tables visible so far (earlier CTEs included, reference sql_expr.CTE).
    Paren counting runs on quote-PROTECTED text so a ')' inside a string
    literal cannot truncate a CTE body."""
    m = re.match(r"(?is)^\s*WITH\s+", q)
    if not m:
        return q, tables
    rest, lits = _quote_split(q[m.end():])
    while True:
        mc = re.match(r"(?is)^\s*([A-Za-z_]\w*)\s+AS\s*\(", rest)
        if not mc:
            raise NotImplementedError(f"malformed WITH clause near {rest!r}")
        name = mc.group(1)
        depth, i = 1, mc.end()
        while i < len(rest) and depth:
            if rest[i] == "(":
                depth += 1
            elif rest[i] == ")":
                depth -= 1
            i += 1
        if depth:
            raise NotImplementedError(f"unbalanced parens in WITH {name!r}")
        tables = dict(tables)
        body = _restore_literals(rest[mc.end(): i - 1].strip(), lits)
        tables[name] = _sql_query(body, tables)
        rest = rest[i:].lstrip()
        if rest.startswith(","):
            rest = rest[1:]
            continue
        return _restore_literals(rest, lits), tables


def _restore_literals(txt: str, lits: list[str]) -> str:
    def sub(m):
        return "'" + lits[int(m.group(1))].replace("'", "''") + "'"

    return re.sub(r"\s?__litstr_(\d+)__\s?", sub, txt)


def _split_protected(q: str, word: str) -> list[str]:
    """Split on a top-level keyword, never inside quotes or parens."""
    protected, lits = _quote_split(q)
    parts = _split_keyword(protected, word)
    if len(parts) == 1:
        return [q]
    return [_restore_literals(p, lits).strip() for p in parts]


def _content_keyed(t: Table) -> Table:
    """Re-key by row content so set operations use SQL value semantics."""
    return t.with_id_from(*[t[c] for c in t.column_names()])


def _distinct(t: Table) -> Table:
    cols = t.column_names()
    return t.groupby(*[t[c] for c in cols]).reduce(**{c: t[c] for c in cols})


def _split_setops(q: str) -> list[tuple[str | None, str]]:
    """[(op, segment)]: top-level UNION [ALL] / EXCEPT splits, in order
    (equal precedence, left-associative, per the SQL standard)."""
    protected, lits = _quote_split(q)
    matches = []
    depth = 0
    pat = re.compile(r"(?i)\b(UNION(?:\s+ALL)?|EXCEPT)\b")
    found = [(m.start(), m.end(), m.group(1)) for m in pat.finditer(protected)]
    fi = 0
    cuts: list[tuple[int, int, str]] = []
    for idx, ch in enumerate(protected):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        while fi < len(found) and found[fi][0] == idx:
            if depth == 0:
                cuts.append(found[fi])
            fi += 1
    out: list[tuple[str | None, str]] = []
    last = 0
    last_op: str | None = None
    for start, end, op in cuts:
        out.append((last_op, _restore_literals(protected[last:start], lits).strip()))
        last_op = re.sub(r"\s+", " ", op.upper())
        last = end
    out.append((last_op, _restore_literals(protected[last:], lits).strip()))
    return out


def _sql_query(q: str, tables: dict) -> Table:
    q = q.strip()
    # UNION/EXCEPT: equal precedence, left-associative; INTERSECT binds
    # tighter and is handled per segment below
    segments = _split_setops(q)
    if len(segments) > 1:
        acc = _sql_intersect(segments[0][1], tables)
        for op, seg in segments[1:]:
            rhs = _sql_intersect(seg, tables)
            if op == "UNION ALL":
                acc = acc.concat_reindex(rhs)
            elif op == "UNION":
                acc = _distinct(acc.concat_reindex(rhs))
            else:  # EXCEPT
                acc = _content_keyed(acc).difference(_content_keyed(rhs))
        return acc
    return _sql_intersect(q, tables)


def _sql_intersect(q: str, tables: dict) -> Table:
    q = q.strip()
    parts = _split_protected(q, "INTERSECT")
    if len(parts) > 1:
        acc = _content_keyed(_sql_select(parts[0], tables))
        for p in parts[1:]:
            acc = acc.intersect(_content_keyed(_sql_select(p, tables)))
        return acc
    return _sql_select(q, tables)


def _extract_from_subquery(q: str, tables: dict) -> str:
    """FROM (SELECT ...) [AS] alias — evaluate the subquery, register it
    under the alias, splice the alias into the text."""
    m = re.search(r"(?is)\bfrom\s*\(", q)
    if not m:
        return q
    start = q.index("(", m.start())
    depth = 0
    for i in range(start, len(q)):
        if q[i] == "(":
            depth += 1
        elif q[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    else:
        raise NotImplementedError(f"unbalanced parens in {q!r}")
    inner = q[start + 1 : end]
    rest = q[end + 1 :]
    am = re.match(r"(?is)^\s*(?:as\s+)?(\w+)(.*)$", rest, re.S)
    if not am:
        raise NotImplementedError("FROM subquery requires an alias")
    alias, tail = am.group(1), am.group(2)
    tables[alias] = _sql_query(inner.strip(), tables)
    return q[: m.start()] + f"FROM {alias}" + tail


_AGG_CALL = re.compile(r"(?i)\b(count|sum|avg|min|max)\s*\(")


def _extract_having_aggs(having: str) -> tuple[str, dict[str, str]]:
    """Replace aggregate calls in HAVING with hidden aliases computed in the
    reduce: 'COUNT(*) > 2' -> ('__h0 > 2', {'__h0': 'COUNT(*)'})."""
    hidden: dict[str, str] = {}
    out = []
    i = 0
    while i < len(having):
        m = _AGG_CALL.search(having, i)
        if not m:
            out.append(having[i:])
            break
        out.append(having[i : m.start()])
        depth = 0
        j = having.index("(", m.start())
        for k in range(j, len(having)):
            if having[k] == "(":
                depth += 1
            elif having[k] == ")":
                depth -= 1
                if depth == 0:
                    break
        else:
            raise NotImplementedError(f"unbalanced parens in HAVING {having!r}")
        call = having[m.start() : k + 1]
        name = f"__h{len(hidden)}"
        hidden[name] = call
        out.append(name)
        i = k + 1
    return "".join(out), hidden


def _sql_select(q: str, tables: dict) -> Table:
    q = q.strip()
    # subquery aliases stay local to THIS select: they must not shadow real
    # tables in sibling set-operation branches
    tables = dict(tables)
    q = _extract_from_subquery(q, tables)
    m = re.match(
        r"(?is)^select\s+(?P<cols>.*?)\s+from\s+(?P<table>\w+)"
        r"(?P<joins>(?:\s+(?:inner\s+|left\s+|right\s+|outer\s+)?join\s+\w+\s+on\s+.*?(?=\s+(?:inner\s+|left\s+|right\s+|outer\s+)?join|\s+where|\s+group\s+by|\s+order\s+by|\s+limit|$))*)"
        r"(?:\s+where\s+(?P<where>.*?))?"
        r"(?:\s+group\s+by\s+(?P<group>.*?))?"
        r"(?:\s+having\s+(?P<having>.*?))?"
        r"(?:\s+order\s+by\s+(?P<order>.*?))?"
        r"(?:\s+limit\s+(?P<limit>\d+))?$",
        q,
    )
    if not m:
        raise NotImplementedError(f"unsupported SQL: {q!r}")
    tname = m.group("table")
    if tname not in tables:
        raise ValueError(f"unknown table {tname!r} in SQL query")
    t = tables[tname]
    joins_txt = m.group("joins") or ""
    for jm in re.finditer(
        r"(?is)(?:(?P<how>inner|left|right|outer)\s+)?join\s+(?P<jt>\w+)\s+on\s+"
        r"(?P<on>.*?)(?=\s+(?:inner\s+|left\s+|right\s+|outer\s+)?join|\s*$)",
        joins_txt,
    ):
        jt_name = jm.group("jt")
        if jt_name not in tables:
            raise ValueError(f"unknown table {jt_name!r} in SQL join")
        right = tables[jt_name]
        how = (jm.group("how") or "inner").lower()
        on = jm.group("on").strip()
        # ON accepts (possibly parenthesized, arbitrarily nested)
        # AND-composed equality pairs: multi-key joins per the
        # reference's sqlglot-backed parser
        def flatten_and(expr: str) -> list[str]:
            expr = expr.strip()
            while True:
                inner = _strip_outer_parens(expr)
                if inner is None:
                    break
                expr = inner.strip()
            parts = _split_keyword(expr, "and")
            if len(parts) == 1:
                return [expr]
            out: list[str] = []
            for p in parts:
                out.extend(flatten_and(p))
            return out

        conds = []
        for part in flatten_and(on):
            cm = re.match(
                r'(?s)^[`"]?(\w+)[`"]?\.[`"]?(\w+)[`"]?\s*=\s*'
                r'[`"]?(\w+)[`"]?\.[`"]?(\w+)[`"]?$', part)
            if not cm:
                raise NotImplementedError(
                    f"unsupported JOIN condition: {part!r}")
            lt_n, lc, rt_n, rc = cm.groups()
            sides = {lt_n, rt_n}
            if jt_name not in sides:
                raise ValueError(
                    f"JOIN condition {part!r} must reference the joined "
                    f"table {jt_name!r}"
                )
            if len(sides) == 1:
                raise ValueError(
                    f"JOIN condition {part!r} must reference two different "
                    "tables"
                )
            other = (sides - {jt_name}).pop()
            if other not in tables:
                raise ValueError(
                    f"JOIN condition references unknown table {other!r}")
            if rt_n == jt_name:
                conds.append((lc, rc))
            else:
                conds.append((rc, lc))
        jr = t.join(
            right,
            *[t[lcol] == right[rcol] for lcol, rcol in conds],
            how=how,
        )
        # flatten the join into a plain table carrying both sides' columns
        sel = {}
        for n in t.column_names():
            sel[n] = t[n]
        for n in right.column_names():
            if n not in sel:
                sel[n] = right[n]
        t = jr.select(**sel)
    if m.group("where"):
        t = t.filter(_parse_expr(m.group("where"), t))
    cols_txt = _split_commas(m.group("cols"))
    group_txt = m.group("group")
    if m.group("order") or m.group("limit"):
        raise NotImplementedError(
            "ORDER BY / LIMIT: incremental tables are unordered; sort at the "
            "sink (e.g. pandas) or use Table.sort for prev/next traversal"
        )
    if group_txt:
        gb_cols = [c.strip() for c in group_txt.split(",")]
        out: dict[str, Any] = {}
        for c in cols_txt:
            name, e = _parse_output(c, t)
            out[name] = e
        having_txt = m.group("having")
        if having_txt:
            rewritten, hidden = _extract_having_aggs(having_txt)
            hidden_exprs = {
                name: _parse_expr(call, t) for name, call in hidden.items()
            }
            reduced = t.groupby(*[t[g] for g in gb_cols]).reduce(
                **out, **hidden_exprs
            )
            reduced = reduced.filter(_parse_expr(rewritten, reduced))
            return reduced.select(**{n: reduced[n] for n in out})
        return t.groupby(*[t[g] for g in gb_cols]).reduce(**out)
    if m.group("having"):
        raise NotImplementedError("HAVING requires GROUP BY")
    if len(cols_txt) == 1 and cols_txt[0].strip() == "*":
        return t.select(*[t[n] for n in t.column_names()])
    has_agg = any(re.match(r"(?i)\s*(count|sum|avg|min|max)\s*\(", c) for c in cols_txt)
    out = {}
    for c in cols_txt:
        name, e = _parse_output(c, t)
        out[name] = e
    if has_agg:
        return t.reduce(**out)
    return t.select(**out)


def _split_commas(s: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def _parse_output(col: str, t: Table):
    m = re.match(r"(?is)^(?P<expr>.*?)\s+as\s+(?P<name>\w+)\s*$", col.strip())
    if m:
        e = _parse_expr(m.group("expr"), t)
        return m.group("name"), e
    e = _parse_expr(col.strip(), t)
    name = col.strip() if re.match(r"^\w+$", col.strip()) else f"col_{abs(hash(col)) % 1000}"
    magg = re.match(r"(?i)^\s*(count|sum|avg|min|max)\s*\(", col.strip())
    if magg:
        name = magg.group(1).lower()
    return name, e


def _quote_split(txt: str) -> tuple[str, list[str]]:
    """Pull single-quoted SQL string literals out into placeholders so the
    keyword/operator rewrites never touch text inside quotes ('a=b AND c'
    stays intact).  '' inside a literal is the SQL escape for one quote."""
    out: list[str] = []
    lits: list[str] = []
    i, n = 0, len(txt)
    while i < n:
        ch = txt[i]
        if ch == "'":
            j = i + 1
            buf: list[str] = []
            while j < n:
                if txt[j] == "'":
                    if j + 1 < n and txt[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(txt[j])
                j += 1
            else:
                raise NotImplementedError(f"unterminated string literal in {txt!r}")
            out.append(f" __litstr_{len(lits)}__ ")
            lits.append("".join(buf))
            i = j + 1
        else:
            out.append(ch)
            i += 1
    return "".join(out), lits


_ALLOWED_BINOPS = {
    "Add": lambda a, b: a + b,
    "Sub": lambda a, b: a - b,
    "Mult": lambda a, b: a * b,
    "Div": lambda a, b: a / b,
    "Mod": lambda a, b: a % b,
    "BitAnd": lambda a, b: a & b,
    "BitOr": lambda a, b: a | b,
    "FloorDiv": lambda a, b: a // b,
}
_ALLOWED_CMPOPS = {
    "Eq": lambda a, b: a == b,
    "NotEq": lambda a, b: a != b,
    "Lt": lambda a, b: a < b,
    "LtE": lambda a, b: a <= b,
    "Gt": lambda a, b: a > b,
    "GtE": lambda a, b: a >= b,
}


def _eval_ast(node, names: dict, lits: list[str]):
    """Whitelist AST interpreter — no eval(): only names, constants,
    arithmetic/comparison/bitwise operators.  Attribute access, subscripts,
    calls, comprehensions etc. are rejected, so no dunder-chain escapes."""
    if isinstance(node, ast.Expression):
        return _eval_ast(node.body, names, lits)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float, bool, str)) or node.value is None:
            return node.value
        raise NotImplementedError(f"unsupported literal {node.value!r}")
    if isinstance(node, ast.Name):
        m = re.match(r"^__litstr_(\d+)__$", node.id)
        if m:
            return lits[int(m.group(1))]
        low = node.id.lower()
        if low == "null" or low == "none":
            return None
        if low == "true":
            return True
        if low == "false":
            return False
        if node.id in names:
            return names[node.id]
        raise NotImplementedError(f"unknown column {node.id!r}")
    if isinstance(node, ast.BinOp):
        opname = type(node.op).__name__
        if opname not in _ALLOWED_BINOPS:
            raise NotImplementedError(f"unsupported operator {opname}")
        return _ALLOWED_BINOPS[opname](
            _eval_ast(node.left, names, lits), _eval_ast(node.right, names, lits)
        )
    if isinstance(node, ast.UnaryOp):
        opname = type(node.op).__name__
        v = _eval_ast(node.operand, names, lits)
        if opname == "USub":
            return -v
        if opname in ("Invert", "Not"):
            return (not v) if isinstance(v, bool) else ~v
        raise NotImplementedError(f"unsupported unary operator {opname}")
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise NotImplementedError("chained comparisons unsupported in SQL")
        opname = type(node.ops[0]).__name__
        if opname not in _ALLOWED_CMPOPS:
            raise NotImplementedError(f"unsupported comparison {opname}")
        return _ALLOWED_CMPOPS[opname](
            _eval_ast(node.left, names, lits),
            _eval_ast(node.comparators[0], names, lits),
        )
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name) or node.keywords:
            raise NotImplementedError("unsupported SQL function call form")
        fname = node.func.id.upper()
        fn = _sql_funcs().get(fname)
        if fn is None:
            raise NotImplementedError(f"unsupported SQL function {fname}")
        args = [_eval_ast(a, names, lits) for a in node.args]
        return fn(*args)
    raise NotImplementedError(f"unsupported SQL syntax node {type(node).__name__}")


def _scalar_fn(py_fn, ret_type):
    """Lift a python scalar function over column expressions via apply
    (plain values short-circuit)."""
    def lifted(*args):
        from .. import apply_with_type
        from .expression import ColumnExpression

        if any(isinstance(a, ColumnExpression) for a in args):
            return apply_with_type(py_fn, ret_type, *args)
        return py_fn(*args)

    return lifted


def _sql_round(v, nd=0):
    """SQL ROUND: half away from zero (MySQL/Postgres/SQLite behavior),
    NOT Python's banker's rounding — round(2.5)=2 in Python but SQL says 3.
    Decimal-based so scaling artifacts (2.675*100 = 267.4999…) don't flip
    the tie direction."""
    if v is None:
        return None
    from decimal import ROUND_HALF_UP, Decimal

    nd = int(nd)
    q = Decimal(str(v)).quantize(Decimal(1).scaleb(-nd), rounding=ROUND_HALF_UP)
    if isinstance(v, int) and nd <= 0:
        return int(q)
    return float(q)


def _make_sql_funcs():
    from .. import coalesce as _coalesce, if_else as _if_else
    from . import dtype as _dt

    return {
        "IF": _if_else,
        "COALESCE": _coalesce,
        "IFNULL": _coalesce,
        "NULLIF": _scalar_fn(lambda a, b: None if a == b else a, _dt.ANY),
        "ABS": _scalar_fn(lambda v: abs(v) if v is not None else None,
                          _dt.ANY),
        "ROUND": _scalar_fn(_sql_round, _dt.ANY),
        "LOWER": _scalar_fn(lambda v: v.lower() if v is not None else None,
                            _dt.STR),
        "UPPER": _scalar_fn(lambda v: v.upper() if v is not None else None,
                            _dt.STR),
        "LENGTH": _scalar_fn(lambda v: len(v) if v is not None else None,
                             _dt.INT),
        "CONCAT": _scalar_fn(
            lambda *vs: "".join("" if v is None else str(v) for v in vs),
            _dt.STR,
        ),
    }


_SQL_FUNCS_CACHE: dict | None = None


def _sql_funcs() -> dict:
    """Memoized function table (built lazily: the package's init
    imports this module, so eager top-level imports would cycle)."""
    global _SQL_FUNCS_CACHE
    if _SQL_FUNCS_CACHE is None:
        _SQL_FUNCS_CACHE = _make_sql_funcs()
    return _SQL_FUNCS_CACHE


def _split_keyword(s: str, kw: str) -> list[str]:
    """Split on a boolean keyword at paren depth 0 (quotes already extracted
    into placeholders by _quote_split)."""
    matches = [(m.start(), m.end()) for m in re.finditer(rf"(?i)\b{kw}\b", s)]
    if not matches:
        return [s]
    parts: list[str] = []
    depth = 0
    last = 0
    mi = 0
    for idx, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        while mi < len(matches) and matches[mi][0] == idx:
            if depth == 0:
                parts.append(s[last:idx])
                last = matches[mi][1]
            mi += 1
    parts.append(s[last:])
    return parts


def _strip_outer_parens(s: str) -> str | None:
    """'(…)' → '…' when the parens wrap the whole expression, else None."""
    if not (s.startswith("(") and s.endswith(")")):
        return None
    depth = 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0 and i != len(s) - 1:
                return None
    return s[1:-1]


def _parse_bool(s: str, names: dict, lits: list[str]):
    # KEEP IN SYNC with _boolkw_to_ops (the string-rewrite twin used
    # inside CASE/IF arguments) — see its docstring.
    """SQL boolean grammar: OR < AND < NOT < comparison — each comparison
    clause is evaluated as its own atom, so Python's `&`-binds-tighter-than-
    `==` precedence never mangles `a = 1 AND b = 2`."""
    ors = _split_keyword(s, "OR")
    if len(ors) > 1:
        res = _parse_bool(ors[0], names, lits)
        for p in ors[1:]:
            res = res | _parse_bool(p, names, lits)
        return res
    ands = _split_keyword(s, "AND")
    if len(ands) > 1:
        res = _parse_bool(ands[0], names, lits)
        for p in ands[1:]:
            res = res & _parse_bool(p, names, lits)
        return res
    s2 = s.strip()
    m = re.match(r"(?is)^NOT\b(.*)$", s2)
    if m:
        v = _parse_bool(m.group(1), names, lits)
        # a constant-folded predicate is a plain bool: ~False would be -1
        return (not v) if isinstance(v, bool) else ~v
    inner = _strip_outer_parens(s2)
    if inner is not None:
        return _parse_bool(inner, names, lits)
    return _parse_atom(s2, names, lits)


def _parse_atom(s: str, names: dict, lits: list[str]):
    py = re.sub(r"(?<![<>!=])=(?!=)", "==", s)
    py = re.sub(r"(?i)\s+IS\s+NOT\s+", " != ", py)
    py = re.sub(r"(?i)\s+IS\s+", " == ", py)
    py = re.sub(r"<>", "!=", py)
    try:
        tree = ast.parse(py, mode="eval")
    except SyntaxError as exc:
        raise NotImplementedError(f"unsupported SQL expression: {s!r} ({exc})")
    try:
        return _eval_ast(tree, names, lits)
    except NotImplementedError:
        raise
    except Exception as exc:
        raise NotImplementedError(f"unsupported SQL expression: {s!r} ({exc})")


def _parse_expr(txt: str, t: Table) -> Any:
    txt = txt.strip()
    magg = re.match(r"(?is)^(count|sum|avg|min|max)\s*\((.*)\)$", txt)
    if magg:
        fn = _AGGS[magg.group(1).lower()]
        inner = magg.group(2).strip()
        if inner == "*":
            return reducers.count()
        return fn(_parse_expr(inner, t))
    names = {n: t[n] for n in t.column_names()}
    protected, lits = _quote_split(txt)
    protected = _rewrite_sugar(protected)
    return _parse_bool(protected, names, lits)


# -- SQL-specific sugar rewritten onto the Python-ast grammar --------------

_ATOM_RE = r"(?:[A-Za-z_]\w*(?:\.\w+)*|-?\d+(?:\.\d+)?|__litstr_\d+__)"


def _left_operand(s: str, pos: int) -> tuple[int, str]:
    """Scan BACKWARD from `pos` over one operand: identifier/number/
    placeholder, a parenthesized group, or a call `name(...)`.  Raises if
    the operand is preceded by an arithmetic operator — `a + 1 BETWEEN`
    would otherwise silently bind only the `1` (parenthesize instead)."""
    j = pos
    while j > 0 and s[j - 1].isspace():
        j -= 1
    if j == 0:
        raise NotImplementedError("BETWEEN/IN missing left operand")
    if s[j - 1] == ")":
        depth, i = 1, j - 1
        while i > 0 and depth:
            i -= 1
            if s[i] == ")":
                depth += 1
            elif s[i] == "(":
                depth -= 1
        if depth:
            raise NotImplementedError("unbalanced parens before BETWEEN/IN")
        start = i
        # a call: identifier glued to the group
        while start > 0 and (s[start - 1].isalnum() or s[start - 1] in "_."):
            start -= 1
    else:
        start = j
        while start > 0 and (s[start - 1].isalnum() or s[start - 1] in "_."):
            start -= 1
    k = start
    while k > 0 and s[k - 1].isspace():
        k -= 1
    if k > 0 and s[k - 1] in "+-*/%":
        raise NotImplementedError(
            f"complex operand before BETWEEN/IN near {s[max(0, k - 12): j]!r}"
            " — parenthesize it, e.g. (a + 1) BETWEEN 3 AND 4"
        )
    return start, s[start:j]


_OPERAND_RE = rf"(?:{_ATOM_RE}|[\w.]*\((?:[^()]|\([^()]*\))*\))"


def _rewrite_sugar(s: str) -> str:
    """BETWEEN / [NOT] IN (...) / CASE WHEN -> comparison chains and
    IF().  Operates on quote-protected text (string literals are
    placeholders), BEFORE boolean splitting — BETWEEN's AND must not
    split the clause; BETWEEN/IN run FIRST so they also work inside CASE
    conditions (whose AND/OR are converted to &/| afterwards)."""
    # X [NOT] BETWEEN a AND b
    pat_between = re.compile(
        rf"(?is)\s+(NOT\s+)?BETWEEN\s+({_OPERAND_RE})\s+AND\s+"
        rf"({_OPERAND_RE})"
    )
    while True:
        m = pat_between.search(s)
        if not m:
            break
        start, x = _left_operand(s, m.start())
        neg, lo, hi = m.group(1), m.group(2), m.group(3)
        rep = (f"(({x} < {lo}) | ({x} > {hi}))" if neg
               else f"(({x} >= {lo}) & ({x} <= {hi}))")
        s = s[:start] + rep + s[m.end():]
    # X [NOT] IN (a, b, ...) with a flat literal/atom list
    pat_in = re.compile(r"(?is)\s+(NOT\s+)?IN\s*\(([^()]*)\)")
    while True:
        m = pat_in.search(s)
        if not m:
            break
        start, x = _left_operand(s, m.start())
        neg, items = m.group(1), m.group(2)
        parts = [p.strip() for p in items.split(",") if p.strip()]
        if not parts:
            raise NotImplementedError("empty IN list")
        if neg:
            rep = "(" + " & ".join(f"({x} != {p})" for p in parts) + ")"
        else:
            rep = "(" + " | ".join(f"({x} == {p})" for p in parts) + ")"
        s = s[:start] + rep + s[m.end():]
    return _rewrite_case(s)


def _rewrite_case(s: str) -> str:
    """CASE WHEN c THEN v [WHEN ...] [ELSE e] END -> IF(c, v, IF(..., e));
    nested CASEs recurse through the inner rewrite."""
    pat = re.compile(r"(?is)\bCASE\b")
    while True:
        m = pat.search(s)
        if not m:
            return s
        # find the matching END at the same CASE-nesting depth
        depth, i = 1, m.end()
        tok = re.compile(r"(?is)\b(CASE|END)\b")
        end_start = end_stop = None
        for mt in tok.finditer(s, m.end()):
            depth += 1 if mt.group(1).upper() == "CASE" else -1
            if depth == 0:
                end_start, end_stop = mt.start(), mt.end()
                break
        if end_start is None:
            raise NotImplementedError("CASE without matching END")
        body = _rewrite_case(s[m.end(): end_start])  # inner CASEs first
        arms = re.split(r"(?is)\bWHEN\b", body)
        if arms[0].strip():
            raise NotImplementedError(
                "only searched CASE (CASE WHEN ...) is supported"
            )
        else_expr = "None"
        clauses = []
        for arm in arms[1:]:
            parts = re.split(r"(?is)\bTHEN\b", arm, maxsplit=1)
            if len(parts) != 2:
                raise NotImplementedError("CASE WHEN without THEN")
            cond, rest = parts[0].strip(), parts[1]
            eparts = re.split(r"(?is)\bELSE\b", rest, maxsplit=1)
            clauses.append((cond, eparts[0].strip()))
            if len(eparts) == 2:
                else_expr = eparts[1].strip()
        rep = else_expr
        for cond, val in reversed(clauses):
            rep = f"IF({_boolkw_to_ops(cond)}, ({val}), ({rep}))"
        s = s[: m.start()] + rep + s[end_stop:]


def _boolkw_to_ops(txt: str) -> str:
    """AND/OR/NOT keywords -> explicitly parenthesized &/|/~ — needed
    inside function-call arguments, where the top-level keyword splitter
    cannot reach and Python's &/| precedence would otherwise bind tighter
    than the comparisons.

    KEEP IN SYNC with _parse_bool: both encode the OR < AND < NOT grammar
    (this one as a string rewrite, that one over live expressions); a
    precedence or keyword-splitting change applied to only one of them
    would make the same condition parse differently at top level vs
    inside a CASE/IF argument."""
    ors = _split_keyword(txt, "OR")
    if len(ors) > 1:
        return "(" + " | ".join(_boolkw_to_ops(p) for p in ors) + ")"
    ands = _split_keyword(txt, "AND")
    if len(ands) > 1:
        return "(" + " & ".join(_boolkw_to_ops(p) for p in ands) + ")"
    s2 = txt.strip()
    m = re.match(r"(?is)^NOT\s+(.*)$", s2)
    if m:
        return "(~" + _boolkw_to_ops(m.group(1)) + ")"
    stripped = _strip_outer_parens(s2)
    if stripped is not None:
        return "(" + _boolkw_to_ops(stripped) + ")"
    return "(" + s2 + ")"
