"""Fuzzy join (the port of ``pathway_tpu/stdlib/ml/smart_table_ops.py``;
reference: stdlib/ml/smart_table_ops/_fuzzy_join.py, 470 LoC).

Feature-based similarity matching between two tables:

  row --features--> {token | letter}         (FuzzyJoinFeatureGeneration)
  score(l, r) = sum over shared features f of  w_l(f) * w_r(f) * norm(cnt(f))
  pairs      = mutual-best chain: best right per left, then best left per
               right, with an id-ordered pseudoweight to break ties
               deterministically (the reference's weight_to_pseudoweight)

Rare features dominate via the normalization (count-discretized inverse
weights); `by_hand_match` rows are authoritative: their nodes are excluded
from automatic matching and the given pairs override the output.
"""

from __future__ import annotations

import math
import re
from enum import IntEnum, auto
from typing import Any, Callable

from ...internals import dtype as dt
from ...internals import reducers as R
from ...internals.expression import ApplyExpression
from ...internals.table import Table

_TOKEN = re.compile(r"\S+")


def _tokenize(obj: Any) -> list[str]:
    return [t.lower() for t in _TOKEN.findall(str(obj) or "")]


def _letters(obj: Any) -> list[str]:
    return [c.lower() for c in str(obj) if c.isalnum()]


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self) -> Callable[[Any], list[str]]:
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize  # AUTO defaults to tokenize, as the reference does


def _discrete_weight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1.0 / (2 ** math.ceil(math.log2(cnt)))


def _discrete_logweight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1.0 / math.ceil(math.log2(cnt + 1))


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self) -> Callable[[float], float]:
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return lambda cnt: cnt


def _feature_edges(col, generate) -> Table:
    """(node, feature, weight) edge table: one row per (row, feature), with
    multiplicity folded into the weight."""
    table = col._table if hasattr(col, "_table") else col
    t = table.select(
        _pw_feats=ApplyExpression(
            lambda s: tuple(generate(s)), dt.List(dt.STR), (col,), {}
        )
    )
    t = t.with_columns(_pw_node=t.id)
    t = t.flatten(t._pw_feats)
    per = t.groupby(t._pw_node, t._pw_feats).reduce(
        node=t._pw_node, feature=t._pw_feats, weight=R.count()
    )
    return per.select(node=per.node, feature=per.feature,
                      weight=per.weight * 1.0)


def _pair_scores(el: Table, er: Table, normalization) -> Table:
    """Sum of wl*wr*norm(total feature count) over shared features."""
    both = el.select(feature=el.feature, w=el.weight).concat_reindex(
        er.select(feature=er.feature, w=er.weight)
    )
    cnt = both.groupby(both.feature).reduce(f=both.feature, cnt=R.count())
    cnt = cnt.with_id(cnt.f)
    norm = normalization.normalize
    j = el.join(er, el.feature == er.feature)
    pairs = j.select(
        left=el.node, right=er.node, feature=el.feature,
        wl=el.weight, wr=er.weight,
    )
    looked = cnt.ix(pairs.feature)
    pairs = pairs.with_columns(
        s=pairs.wl * pairs.wr * ApplyExpression(
            lambda c: float(norm(c)), dt.FLOAT, (looked.cnt,), {}
        )
    )
    return pairs.groupby(pairs.left, pairs.right).reduce(
        pairs.left, pairs.right, weight=R.sum(pairs.s)
    )


def _mutual_best(scored: Table) -> Table:
    """Reference pair selection: argmax over rights per left, then argmax
    over lefts per right, with an id-ordered (weight, lo, hi) pseudoweight
    so ties resolve identically from both directions."""
    pseudo = scored.with_columns(
        pw_=ApplyExpression(
            lambda w, l, r: (w, min(str(l), str(r)), max(str(l), str(r))),
            dt.ANY, (scored.weight, scored.left, scored.right), {},
        )
    )
    by_left = pseudo.groupby(pseudo.left).reduce(
        pseudo.left,
        right=R.argmax(pseudo.pw_, pseudo.right),
        weight=R.max(pseudo.pw_),
    )
    by_right = by_left.groupby(by_left.right).reduce(
        left=R.argmax(by_left.weight, by_left.left),
        right=by_left.right,
        weight=R.max(by_left.weight),
    )
    return by_right.select(
        left=by_right.left, right=by_right.right,
        weight=ApplyExpression(
            lambda t: float(t[0]), dt.FLOAT, (by_right.weight,), {}
        ),
    )


def smart_fuzzy_match(
    left_col, right_col, *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    threshold: float = 0.0,
    _append_by_hand: bool = True,
) -> Table:
    """Match rows of two string columns; returns (left, right, weight).
    Reference: smart_fuzzy_match (:199)."""
    generate = FuzzyJoinFeatureGeneration(feature_generation).generate
    normalization = FuzzyJoinNormalization(normalization)
    el = _feature_edges(left_col, generate)
    er = _feature_edges(right_col, generate)
    if by_hand_match is not None:
        # authoritative pairs: their nodes leave the automatic pool
        lh = by_hand_match.groupby(by_hand_match.left).reduce(
            n=by_hand_match.left
        )
        lh = lh.with_id(lh.n)
        rh = by_hand_match.groupby(by_hand_match.right).reduce(
            n=by_hand_match.right
        )
        rh = rh.with_id(rh.n)
        el_n = lh.ix(el.node, optional=True)
        el = el.filter(
            ApplyExpression(lambda v: v is None, dt.BOOL, (el_n.n,), {})
        )
        er_n = rh.ix(er.node, optional=True)
        er = er.filter(
            ApplyExpression(lambda v: v is None, dt.BOOL, (er_n.n,), {})
        )
    scored = _pair_scores(el, er, normalization)
    if threshold > 0:
        scored = scored.filter(scored.weight >= threshold)
    matched = _mutual_best(scored)
    if by_hand_match is not None and _append_by_hand:
        matched = matched.concat_reindex(
            by_hand_match.select(
                left=by_hand_match.left, right=by_hand_match.right,
                weight=by_hand_match.weight,
            )
        )
    return matched


def _concat_desc(table: Table) -> Table:
    cols = [table[n] for n in table.column_names()]
    return table.select(
        desc=ApplyExpression(
            lambda *args: " ".join(str(a) for a in args), dt.STR,
            tuple(cols), {},
        )
    )


def fuzzy_match_tables(
    left: Table, right: Table, *,
    left_column=None, right_column=None,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict[str, str] | None = None,
    right_projection: dict[str, str] | None = None,
    threshold: float = 0.0,
) -> Table:
    """Reference: fuzzy_match_tables (:106).  Without projections, all
    columns concatenate into one description per row; with projections,
    each bucket of columns matches independently and the bucket weights
    sum per (left, right) pair."""
    if left_column is not None or right_column is not None:
        lcol = left_column if left_column is not None else _concat_desc(left).desc
        rcol = right_column if right_column is not None else _concat_desc(right).desc
        return smart_fuzzy_match(
            lcol, rcol, by_hand_match=by_hand_match,
            normalization=normalization,
            feature_generation=feature_generation, threshold=threshold,
        )
    if not left_projection or not right_projection:
        return smart_fuzzy_match(
            _concat_desc(left).desc, _concat_desc(right).desc,
            by_hand_match=by_hand_match, normalization=normalization,
            feature_generation=feature_generation, threshold=threshold,
        )
    buckets: dict[str, tuple[list, list]] = {}
    for col, b in left_projection.items():
        buckets.setdefault(b, ([], []))[0].append(col)
    for col, b in right_projection.items():
        buckets.setdefault(b, ([], []))[1].append(col)
    parts = []
    for lcols, rcols in buckets.values():
        if not lcols or not rcols:
            continue
        lb = left.select(**{c: left[c] for c in lcols})
        rb = right.select(**{c: right[c] for c in rcols})
        parts.append(
            smart_fuzzy_match(
                _concat_desc(lb).desc, _concat_desc(rb).desc,
                by_hand_match=by_hand_match, normalization=normalization,
                feature_generation=feature_generation,
                # exclusion per bucket, but the authoritative rows are
                # appended ONCE after the merge (not summed per bucket)
                _append_by_hand=False,
            )
        )
    if not parts:
        raise ValueError(
            "fuzzy_match_tables projections define no bucket with columns "
            "from BOTH sides; check left_projection/right_projection values"
        )
    merged = parts[0].concat_reindex(*parts[1:]) if len(parts) > 1 else parts[0]
    out = merged.groupby(merged.left, merged.right).reduce(
        merged.left, merged.right, weight=R.sum(merged.weight)
    )
    if threshold > 0:
        # threshold applies to the summed cross-bucket weight
        out = out.filter(out.weight >= threshold)
    if by_hand_match is not None:
        out = out.concat_reindex(
            by_hand_match.select(
                left=by_hand_match.left, right=by_hand_match.right,
                weight=by_hand_match.weight,
            )
        )
    return out


def fuzzy_self_match(
    col, *, normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
) -> Table:
    """Symmetric self-matching (reference :249): pairs within one column,
    self-pairs removed, each undirected pair reported once (left < right)."""
    generate = FuzzyJoinFeatureGeneration(feature_generation).generate
    e = _feature_edges(col, generate)
    scored = _pair_scores(e, e.copy(), FuzzyJoinNormalization(normalization))
    scored = scored.filter(scored.left != scored.right)
    matched = _mutual_best(scored)
    return matched.filter(
        ApplyExpression(
            lambda l, r: str(l) < str(r), dt.BOOL,
            (matched.left, matched.right), {},
        )
    )


fuzzy_self_match_table = fuzzy_self_match
fuzzy_match = smart_fuzzy_match
