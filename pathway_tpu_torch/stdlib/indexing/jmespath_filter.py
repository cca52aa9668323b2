"""Metadata filtering for index queries: the port's copy of
``pathway_tpu/stdlib/indexing/jmespath_filter.py`` (no JAX there, but the
port imports nothing of the JAX package).

Reference: JMESPath filtering in src/external_integration/mod.rs:13.  Supports
the subset used by DocumentStore filters: `field == 'v'`, `!=`, `contains()`,
globmatch(), comparisons, && / || / parentheses.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any


def _get(metadata: Any, path: str):
    from ...internals.value import Json

    cur = metadata
    if isinstance(cur, Json):
        cur = cur.value
    for part in path.split("."):
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if isinstance(cur, Json):
            cur = cur.value
    return cur


_TOKEN = re.compile(
    r"\s*(?:(?P<lp>\()|(?P<rp>\))|(?P<and>&&)|(?P<or>\|\|)|(?P<not>!(?!=))|"
    r"(?P<op>==|!=|<=|>=|<|>)|(?P<str>`[^`]*`|'[^']*'|\"[^\"]*\")|"
    r"(?P<num>-?\d+(?:\.\d+)?)|(?P<fn>\w+\()|(?P<id>[\w.]+)|(?P<comma>,))"
)


def evaluate_filter(expr: str, metadata: Any) -> bool:
    try:
        tokens = _tokenize(expr)
        val, pos = _parse_or(tokens, 0, metadata)
        return bool(val)
    except Exception:
        return False


def _tokenize(expr: str):
    out = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if not m:
            raise ValueError(f"bad filter at {expr[pos:]}")
        pos = m.end()
        for name, v in m.groupdict().items():
            if v is not None:
                out.append((name, v))
                break
    return out


def _parse_or(toks, i, md):
    val, i = _parse_and(toks, i, md)
    while i < len(toks) and toks[i][0] == "or":
        rhs, i = _parse_and(toks, i + 1, md)
        val = val or rhs
    return val, i


def _parse_and(toks, i, md):
    val, i = _parse_cmp(toks, i, md)
    while i < len(toks) and toks[i][0] == "and":
        rhs, i = _parse_cmp(toks, i + 1, md)
        val = val and rhs
    return val, i


def _parse_cmp(toks, i, md):
    lhs, i = _parse_atom(toks, i, md)
    if i < len(toks) and toks[i][0] == "op":
        op = toks[i][1]
        rhs, i = _parse_atom(toks, i + 1, md)
        if op == "==":
            return lhs == rhs, i
        if op == "!=":
            return lhs != rhs, i
        if lhs is None or rhs is None:
            return False, i
        if op == "<":
            return lhs < rhs, i
        if op == "<=":
            return lhs <= rhs, i
        if op == ">":
            return lhs > rhs, i
        if op == ">=":
            return lhs >= rhs, i
    return lhs, i


def _parse_atom(toks, i, md):
    kind, v = toks[i]
    if kind == "not":
        val, i = _parse_atom(toks, i + 1, md)
        return (not val), i
    if kind == "lp":
        val, i = _parse_or(toks, i + 1, md)
        if i < len(toks) and toks[i][0] == "rp":
            i += 1
        return val, i
    if kind == "str":
        if v[0] == "`":
            # jmespath backticks delimit JSON literals (`1` is the number 1,
            # `"x"` the string x), not strings
            import json as _json

            try:
                return _json.loads(v[1:-1]), i + 1
            except ValueError:
                return v[1:-1], i + 1
        return v[1:-1], i + 1
    if kind == "num":
        return float(v) if "." in v else int(v), i + 1
    if kind == "fn":
        fname = v[:-1]
        args = []
        i += 1
        while toks[i][0] != "rp":
            if toks[i][0] == "comma":
                i += 1
                continue
            a, i = _parse_or(toks, i, md)
            args.append(a)
        i += 1
        if fname == "contains":
            return (args[1] in args[0]) if args[0] is not None else False, i
        if fname == "globmatch":
            # jmespath order: globmatch(pattern, path)
            return fnmatch.fnmatch(str(args[1] or ""), str(args[0])), i
        if fname == "starts_with":
            return str(args[0] or "").startswith(str(args[1])), i
        raise ValueError(f"unknown function {fname}")
    if kind == "id":
        return _get(md, v), i + 1
    raise ValueError(f"unexpected token {v}")
