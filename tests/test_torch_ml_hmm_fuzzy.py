"""``stdlib.ml``'s fuzzy join and HMM reducer in the port against the JAX
package's: the fuzzy and HMM cases of ``tests/test_ml.py`` built in both
packages from the same rows, captures equal key for key on the port's
numpy and device tiers (``tests/torch_parity.py``), each also checked as
the JAX test checks it; then phase 4n's HMM and fuzzy cases
(``chip_smoke.hmm_case`` / ``fuzzy_names``) at small sizes, the HMM
against numpy's Viterbi."""

from functools import partial

import numpy as np
import pytest

import chip_smoke as cs

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401


def _rows(pw, vals):
    class S(pw.Schema):
        name: str

    return pw.debug.table_from_rows(S, [(v,) for v in vals])


def _basic(pw):
    left = _rows(pw, ["john smith", "anna kowalska", "pablo neruda"])
    right = _rows(pw, ["smith john x", "kowalska anna", "someone else"])
    res = pw.ml.smart_table_ops.fuzzy_match_tables(left, right)
    return res.select(l=left.select(n=left.name).ix(res.left).n,
                      r=right.select(n=right.name).ix(res.right).n,
                      w=res.weight)


def _normalization(pw):
    ops = pw.ml.smart_table_ops
    left = _rows(pw, ["common rare1", "common x1 x2 x3"])
    right = _rows(pw, ["common rare1 zz", "common y1 y2"])
    res = ops.fuzzy_match_tables(
        left, right, normalization=ops.FuzzyJoinNormalization.WEIGHT)
    return res.select(l=left.select(n=left.name).ix(res.left).n,
                      r=right.select(n=right.name).ix(res.right).n,
                      w=res.weight)


def _letters(pw):
    ops = pw.ml.smart_table_ops
    left = _rows(pw, ["abc"])
    right = _rows(pw, ["bca!", "xyz"])
    res = ops.fuzzy_match_tables(
        left, right,
        feature_generation=ops.FuzzyJoinFeatureGeneration.LETTERS)
    return res.select(r=right.select(n=right.name).ix(res.right).n)


def _by_hand(pw):
    left = _rows(pw, ["alpha beta", "gamma delta"])
    right = _rows(pw, ["alpha beta", "gamma delta"])
    lids = left.select(n=left.name)
    rids = right.select(n=right.name)
    hand_src = left.filter(left.name == "alpha beta").select(
        k=1, lid=pw.this.id)
    hand_right = right.filter(right.name == "gamma delta").select(
        k=1, rid=pw.this.id)
    joined = hand_src.join(hand_right, hand_src.k == hand_right.k).select(
        left=hand_src.lid, right=hand_right.rid, weight=99.0)
    res = pw.ml.smart_table_ops.fuzzy_match_tables(left, right,
                                                   by_hand_match=joined)
    return res.select(l=lids.ix(res.left).n, r=rids.ix(res.right).n,
                      w=res.weight)


def _self_match(pw):
    t = _rows(pw, ["data stream engine", "stream data engine",
                   "unrelated words"])
    res = pw.ml.smart_table_ops.fuzzy_self_match(t.name)
    return res.select(l=t.select(n=t.name).ix(res.left).n,
                      r=t.select(n=t.name).ix(res.right).n)


def _projections(pw):
    class Person(pw.Schema):
        first: str
        last: str

    left = pw.debug.table_from_rows(Person, [("john", "smith"),
                                             ("anna", "nowak")])
    right = pw.debug.table_from_rows(Person, [("john", "smith"),
                                              ("anna", "nowak")])
    res = pw.ml.smart_table_ops.fuzzy_match_tables(
        left, right, left_projection={"first": "f", "last": "l"},
        right_projection={"first": "f", "last": "l"})
    return res.select(l=left.select(n=left.first).ix(res.left).n,
                      r=right.select(n=right.first).ix(res.right).n,
                      w=res.weight)


def _pairs(state):
    return {(r[0], r[1]) for r in state.values()}


def _check_basic(state):
    pairs = _pairs(state)
    assert ("john smith", "smith john x") in pairs
    assert ("anna kowalska", "kowalska anna") in pairs
    rights = [r for _l, r in pairs]
    return len(rights) == len(set(rights))


def _check_normalization(state):
    by_left = {l: (r, w) for l, r, w in state.values()}
    assert by_left["common rare1"][0] == "common rare1 zz"
    return by_left["common rare1"][1] > by_left.get(
        "common x1 x2 x3", (None, 0.0))[1]


def _check_by_hand(state):
    rows = list(state.values())
    assert ("alpha beta", "gamma delta", 99.0) in rows
    return all(r == "gamma delta" for l, r, _w in rows if l == "alpha beta")


def _check_self(state):
    pairs = {tuple(sorted(p)) for p in _pairs(state)}
    assert ("data stream engine", "stream data engine") in pairs
    return all("unrelated words" not in p for p in pairs)


FUZZY = {
    "fuzzy_match_tables_basic_and_mutual_best": (_basic, _check_basic),
    "fuzzy_normalization_weights_rare_features": (_normalization,
                                                  _check_normalization),
    "fuzzy_letters_feature_generation": (
        _letters, lambda s: [r[0] for r in s.values()] == ["bca!"]),
    "fuzzy_by_hand_match_overrides": (_by_hand, _check_by_hand),
    "fuzzy_self_match": (_self_match, _check_self),
    "fuzzy_projections_buckets": (
        _projections,
        lambda s: _pairs(s) == {("john", "john"), ("anna", "anna")}),
}


@pytest.mark.parametrize("case", sorted(FUZZY))
def test_fuzzy_case_equals_the_jax_packages(case, fresh_port, monkeypatch):
    build, check = FUZZY[case]
    [state] = equal_to_jax(build, monkeypatch, tiers=("numpy", "device"))
    assert check(state)


# -- HMM -----------------------------------------------------------------------

def _manul_graph():
    import networkx as nx

    def _emis(observation, state):
        table = {("HUNGRY", "GRUMPY"): 0.9, ("HUNGRY", "HAPPY"): 0.1,
                 ("FULL", "GRUMPY"): 0.7, ("FULL", "HAPPY"): 0.3}
        return float(np.log(table[(state, observation)]))

    g = nx.DiGraph()
    g.add_node("HUNGRY", calc_emission_log_ppb=partial(_emis, state="HUNGRY"))
    g.add_node("FULL", calc_emission_log_ppb=partial(_emis, state="FULL"))
    g.add_edge("HUNGRY", "HUNGRY", log_transition_ppb=float(np.log(0.4)))
    g.add_edge("HUNGRY", "FULL", log_transition_ppb=float(np.log(0.6)))
    g.add_edge("FULL", "HUNGRY", log_transition_ppb=float(np.log(0.6)))
    g.add_edge("FULL", "FULL", log_transition_ppb=float(np.log(0.4)))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


def _manul(pw):
    t = pw.debug.table_from_markdown("""
    observation | __time__
     HAPPY      |     2
     HAPPY      |     4
     GRUMPY     |     6
     GRUMPY     |     8
     HAPPY      |     10
     GRUMPY     |     12
    """)
    red = pw.ml.hmm.create_hmm_reducer(_manul_graph(), num_results_kept=3)
    return t.reduce(decoded_state=red(t.observation))


def _beam(pw):
    spec = {
        "states": {
            "A": lambda o: float(np.log(0.9 if o == "a" else 0.1)),
            "B": lambda o: float(np.log(0.9 if o == "b" else 0.1)),
        },
        "transitions": {("A", "A"): float(np.log(0.8)),
                        ("A", "B"): float(np.log(0.2)),
                        ("B", "B"): float(np.log(0.8)),
                        ("B", "A"): float(np.log(0.2))},
        "start": ["A", "B"],
    }
    t = pw.debug.table_from_markdown("""
    observation | __time__
     a          |     2
     a          |     4
     b          |     6
    """)
    red = pw.ml.hmm.create_hmm_reducer(spec, beam_size=1)
    return t.reduce(p=red(t.observation))


def _legacy(pw):
    t = pw.debug.table_from_markdown("""
    observation | __time__
     x          |     2
     y          |     4
    """)
    red = pw.ml.hmm.create_hmm_reducer(
        {"x": {"x": 0.5, "y": 0.5}, "y": {"x": 0.5, "y": 0.5}})
    return t.reduce(p=red(t.observation))


def _final(state):
    [(value,)] = state.values()
    return value


HMM = {
    "hmm_decodes_reference_example": (
        _manul, lambda s: _final(s) == ("HUNGRY", "FULL", "HUNGRY")),
    "hmm_beam_and_dict_spec": (_beam, lambda s: _final(s) == ("A", "A", "B")),
    "hmm_legacy_dict_form_still_works": (
        _legacy, lambda s: _final(s)[-1] == "y"),
}


@pytest.mark.parametrize("case", sorted(HMM))
def test_hmm_case_equals_the_jax_packages(case, fresh_port, monkeypatch):
    build, check = HMM[case]
    [state] = equal_to_jax(build, monkeypatch, tiers=("numpy", "device"))
    assert check(state)


def test_hmm_most_likely_state_in_both_packages():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    for pw in (jpw, tpw):
        mls = pw.ml.hmm.most_likely_state
        assert mls(("a", "b")) == "b"
        assert mls({"x": 0.2, "y": 0.8}) == "y"
        assert mls(()) is None


# -- phase 4n's cases, small ---------------------------------------------------

def test_the_hmm_reducer_gives_numpys_viterbi_path(fresh_port):
    lt, le, obs = cs.hmm_case(np, 4, 8, 2048)
    spec = {
        "states": {f"s{i}": (lambda o, i=i: float(le[i, o]))
                   for i in range(8)},
        "transitions": {(f"s{a}", f"s{b}"): float(lt[a, b])
                        for a in range(8) for b in range(8)},
        "start": [f"s{i}" for i in range(8)],
    }

    def build(pw):
        class O(pw.Schema):
            observation: int

        t = pw.debug.table_from_rows(
            O, [(o, 2 * (i + 1), 1) for i, o in enumerate(obs)],
            is_stream=True)
        return t.reduce(path=pw.ml.hmm.create_hmm_reducer(spec)(
            t.observation))

    # 2,048 observations of this seed hold an exact tie (step 365): the
    # reducer takes the higher predecessor, and so does chip_smoke.viterbi
    [(path,)] = capture("torch", build)[0].values()
    assert path == cs.viterbi(np, lt, le, obs)


def test_phase_4n_fuzzy_names_match_their_copies_in_both_packages(
        fresh_port, monkeypatch):
    left, right = cs.fuzzy_names(np, 5, 128)

    def build(pw):
        class N(pw.Schema):
            i: int = pw.column_definition(primary_key=True)
            name: str

        lt = pw.debug.table_from_rows(N, list(enumerate(left)))
        rt = pw.debug.table_from_rows(N, list(enumerate(right)))
        res = pw.ml.smart_table_ops.fuzzy_match_tables(
            lt.select(name=lt.name), rt.select(name=rt.name))
        return res.select(li=lt.ix(res.left).i, ri=rt.ix(res.right).i,
                          w=res.weight)

    [state] = equal_to_jax(build, monkeypatch, tiers=("numpy", "device"))
    own = sum(1 for li, ri, _w in state.values() if li == ri)
    assert own > len(left) // 2
