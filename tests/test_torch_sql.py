"""``pw.sql`` of the port against the JAX package's: every query of
``tests/test_sql_depth.py`` built in both packages from the same rows,
the captures equal key for key (``tests/torch_parity.py``); a query the
JAX dialect rejects raises the same exception type in the port.  Then
TPC-H Q1, Q3 and Q6 at scale factor 0.001 (``chip_smoke.tpch_*``, the
rows of phase 4n) against the JAX package and the stdlib's ``sqlite3``.
"""

import pytest

import chip_smoke as cs

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401


def _t(pw):
    return pw.debug.table_from_markdown("""
        | g | v
      1 | a | 1
      2 | a | 2
      3 | b | 3
      4 | b | 4
      5 | c | 5
    """)


def _abc(pw):
    return pw.debug.table_from_markdown("""
        a | b
        1 | 10
        2 | 20
        3 | 30
    """)


def _xs(pw, *vals):
    body = "\n".join(f"  {i + 1} | {v}" for i, v in enumerate(vals))
    return pw.debug.table_from_markdown("   | x\n" + body)


def _lr(pw, three=False):
    if three:
        left = pw.debug.table_from_markdown("""
        k1 | k2 | k3 | v
        a | 1 | x | 10
        """)
        right = pw.debug.table_from_markdown("""
        k1 | k2 | k3 | w
        a | 1 | x | 100
        """)
    else:
        left = pw.debug.table_from_markdown("""
        k1 | k2 | v
        a | 1 | 10
        b | 2 | 20
        """)
        right = pw.debug.table_from_markdown("""
        k1 | k2 | w
        a | 1 | 100
        b | 9 | 900
        """)
    return left, right


def _sql_t(q):
    return lambda pw: pw.sql(q, t=_t(pw))


def _sql_abc(*qs):
    return lambda pw: tuple(pw.sql(q, t=_abc(pw)) for q in qs)


def _setops(*qs, b=(2, 3), c=None, a=(1, 2)):
    def build(pw):
        tabs = dict(a=_xs(pw, *a), b=_xs(pw, *b))
        if c is not None:
            tabs["c"] = _xs(pw, *c)
        return tuple(pw.sql(q, **tabs) for q in qs)
    return build


def _literal(pw):
    t = pw.debug.table_from_markdown("""
        | s
      1 | x union y
    """)
    return pw.sql("SELECT s FROM t WHERE s = 'x union y'", t=t)


def _shadow(pw):
    a = pw.debug.table_from_markdown("""
        | y
      1 | 1
    """)
    b = _xs(pw, 9)
    return pw.sql(
        "SELECT x FROM (SELECT y AS x FROM a) b UNION ALL SELECT x FROM b",
        a=a, b=b)


def _multi_key(pw):
    left, right = _lr(pw)
    return tuple(pw.sql(q, l=left, r=right) for q in (
        "SELECT v, w FROM l JOIN r ON (l.k1 = r.k1 AND l.k2 = r.k2)",
        "SELECT v, w FROM l JOIN r ON l.k1 = r.k1 AND l.k2 = r.k2",
        'SELECT v, w FROM l JOIN r ON ("l".k1 = "r"."k1") AND '
        '(l.k2 = r.k2)'))


def _nested_and(pw):
    left, right = _lr(pw, three=True)
    return pw.sql("SELECT v, w FROM l JOIN r ON (l.k1 = r.k1) AND "
                  "(l.k2 = r.k2 AND l.k3 = r.k3)", l=left, r=right)


# (test of tests/test_sql_depth.py, build(pw) -> the query's table(s))
CASES = {
    "having": _sql_t(
        "SELECT g, SUM(v) AS s FROM t GROUP BY g HAVING SUM(v) > 3"),
    "having_count_and_compound": _sql_t(
        "SELECT g, COUNT(*) AS c FROM t GROUP BY g "
        "HAVING COUNT(*) > 1 AND SUM(v) < 5"),
    "union_all_and_union": _setops(
        "SELECT x FROM a UNION ALL SELECT x FROM b",
        "SELECT x FROM a UNION SELECT x FROM b"),
    "intersect_except": _setops(
        "SELECT x FROM a INTERSECT SELECT x FROM b",
        "SELECT x FROM a EXCEPT SELECT x FROM b", a=(1, 2, 3), b=(2, 3, 4)),
    "from_subquery": _sql_t(
        "SELECT g, s FROM (SELECT g, SUM(v) AS s FROM t GROUP BY g) sub "
        "WHERE s > 3"),
    "nested_subquery_with_union": _sql_t(
        "SELECT g FROM (SELECT g, SUM(v) AS s FROM t GROUP BY g HAVING "
        "SUM(v) > 3) q UNION SELECT g FROM (SELECT g, COUNT(*) AS c FROM t "
        "GROUP BY g HAVING COUNT(*) > 1) r"),
    "union_keyword_in_literal_not_split": _literal,
    "union_except_left_associative": _setops(
        "SELECT x FROM a UNION SELECT x FROM b EXCEPT SELECT x FROM c",
        b=(2,), c=(1,)),
    "subquery_alias_does_not_shadow_sibling": _shadow,
    "join_on_multi_key_and_parens": _multi_key,
    "join_on_nested_and_groups": _nested_and,
    "case_when_with_boolean_arms": _sql_abc(
        "SELECT a, CASE WHEN a > 2 AND b > 15 THEN 'x' WHEN a = 2 "
        "THEN 'y' ELSE 'z' END AS c FROM t"),
    "nested_case": _sql_abc(
        "SELECT CASE WHEN a > 1 THEN CASE WHEN b > 25 THEN 'hi' "
        "ELSE 'mid' END ELSE 'lo' END AS c FROM t"),
    "between_and_not_between": _sql_abc(
        "SELECT a FROM t WHERE a BETWEEN 1 AND 2",
        "SELECT a FROM t WHERE a NOT BETWEEN 2 AND 3",
        "SELECT a FROM t WHERE a BETWEEN 1 AND 2 AND b > 15"),
    "in_and_not_in": _sql_abc(
        "SELECT a FROM t WHERE a IN (1, 3)",
        "SELECT a FROM t WHERE a NOT IN (2)"),
    "with_ctes_chained": _sql_abc(
        "WITH x AS (SELECT a, b FROM t WHERE a > 1), "
        "y AS (SELECT a FROM x WHERE b > 25) SELECT a FROM y"),
    "scalar_functions": _sql_abc(
        "SELECT IF(a > 1, 'y', 'n') AS f, COALESCE(NULL, b) AS c, "
        "UPPER('ok') AS u, LENGTH('abc') AS l, CONCAT('v', a) AS s "
        "FROM t WHERE a = 2"),
    "between_in_operand_edge_cases": _sql_abc(
        "SELECT a FROM t WHERE (a + 1) BETWEEN 3 AND 4",
        "SELECT a FROM t WHERE ABS(a) IN (1, 3)",
        "SELECT CASE WHEN a BETWEEN 1 AND 2 THEN 'in' ELSE 'out' END "
        "AS c FROM t"),
    "cte_with_paren_in_string_literal": _sql_abc(
        "WITH x AS (SELECT a, CONCAT(a, ')') AS s FROM t) "
        "SELECT s FROM x WHERE a = 1"),
    "round_half_away_from_zero_and_concat_null": _sql_abc(
        "SELECT ROUND(a * 0.5) AS r, ROUND(0 - a * 0.5) AS n, "
        "CONCAT('p', NULL, a) AS s FROM t"),
}

# (test of tests/test_sql_depth.py, the query's build, what it raises)
REJECTED = {
    "having_without_group_by_raises": (
        lambda pw: pw.sql("SELECT v FROM t HAVING SUM(v) > 1", t=_t(pw)),
        NotImplementedError, "HAVING"),
    "unknown_function_raises_clearly": (
        lambda pw: pw.sql("SELECT MEDIAN_XYZ(a) AS m FROM t", t=_abc(pw)),
        NotImplementedError, "unsupported SQL function"),
    "between_unparenthesized_operand_raises": (
        lambda pw: pw.sql("SELECT a FROM t WHERE a + 1 BETWEEN 3 AND 4",
                          t=_abc(pw)),
        NotImplementedError, "parenthesize"),
    "order_by_raises": (
        lambda pw: pw.sql("SELECT a FROM t ORDER BY a", t=_abc(pw)),
        NotImplementedError, "ORDER BY"),
    "unknown_table_raises": (
        lambda pw: pw.sql("SELECT a FROM nowhere", t=_abc(pw)),
        ValueError, "unknown table"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sql_query_equals_the_jax_packages(case, fresh_port, monkeypatch):
    expected = equal_to_jax(CASES[case], monkeypatch,
                            tiers=("numpy", "device"))
    assert all(len(state) > 0 for state in expected), case


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_sql_rejects_what_the_jax_dialect_rejects(case, fresh_port):
    build, exc, match = REJECTED[case]
    for pkg in ("jax", "torch"):
        with pytest.raises(exc, match=match):
            capture(pkg, build)


def test_sql_round_and_concat_match_the_dialect_notes(fresh_port):
    """ROUND rounds halves away from zero, CONCAT reads NULL as ''."""
    [state] = capture("torch", CASES[
        "round_half_away_from_zero_and_concat_null"])
    rows = sorted(state.values())
    assert [r[0] for r in rows] == [1.0, 1.0, 2.0]  # 0.5, 1.0, 1.5
    assert [r[1] for r in rows] == [-1.0, -1.0, -2.0]
    assert [r[2] for r in rows] == ["p1", "p2", "p3"]


# -- TPC-H Q1, Q3, Q6 at scale factor 0.001 ----------------------------------

@pytest.fixture(scope="module")
def tpch_small():
    import numpy as np

    return cs.tpch_data(np, seed=0, sf=0.001)


@pytest.mark.parametrize("query", sorted(cs.TPCH_QUERIES))
def test_tpch_query_equals_jax_and_sqlite(query, tpch_small, fresh_port,
                                          monkeypatch):
    data = tpch_small
    text = cs.TPCH_QUERIES[query]
    want = cs.tpch_sqlite(data, text)
    assert len(want) > 0, query

    def build(pw):
        return pw.sql(text, **cs.tpch_tables(pw, data))

    jax_state = capture("jax", build)[0]
    for tier in ("numpy", "device"):
        got = capture("torch", build, tier=tier, monkeypatch=monkeypatch)[0]
        assert cs.float_sums_close(got, jax_state, 1e-9), (query, tier)
    ok, why = cs.tpch_matches(list(jax_state.values()), want, 1e-9)
    assert ok, (query, why)
