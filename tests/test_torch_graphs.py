"""``stdlib.graphs`` of the port against the JAX package's: the five cases
of ``tests/test_graphs.py`` built in both packages from the same rows,
captures equal key for key on the port's numpy and device tiers
(``tests/torch_parity.py``), plus a small R-MAT graph (``chip_smoke.
rmat_edges``, phase 4n's generator) through pagerank and Bellman-Ford in
both packages and against their plain references."""

import math

import numpy as np
import pytest

import chip_smoke as cs

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401


def _vertices(pw, names):
    rows = "\n".join(f"{n} | {str(n == names[0])}" for n in names)
    return pw.debug.table_from_markdown(f"""
        n | is_source
        {rows}
        """, id_from=["n"])


def _bellman_ford(pw):
    v = _vertices(pw, ["a", "b", "c", "d"])
    e = pw.debug.table_from_markdown("""
        | su | sv | dist
      1 | a  | b  | 1.0
      2 | b  | c  | 2.0
      3 | a  | c  | 5.0
    """)
    e2 = e.select(u=v.pointer_from(e.su), v=v.pointer_from(e.sv),
                  dist=e.dist)
    return pw.graphs.bellman_ford(v, e2)


def _bellman_ford_relaxation(pw):
    v = _vertices(pw, ["a", "b", "c", "d"])
    e = pw.debug.table_from_markdown("""
        | su | sv | dist
      1 | a  | b  | 10.0
      2 | a  | c  | 2.0
      3 | c  | b  | 3.0
    """)
    e2 = e.select(u=v.pointer_from(e.su), v=v.pointer_from(e.sv),
                  dist=e.dist)
    return pw.graphs.bellman_ford(v, e2)


def _two_cliques(pw):
    names = ["a", "b", "c", "x", "y", "z"]
    v = pw.debug.table_from_markdown("\n".join(["n"] + names),
                                     id_from=["n"])
    edges = [("a", "b"), ("b", "c"), ("a", "c"), ("x", "y"), ("y", "z"),
             ("x", "z"), ("c", "x")]
    lines = (["su | sv"] + [f"{u} | {w}" for u, w in edges]
             + [f"{w} | {u}" for u, w in edges])
    e = pw.debug.table_from_markdown("\n".join(lines))
    e2 = e.select(u=v.pointer_from(e.su), v=v.pointer_from(e.sv),
                  weight=1.0)
    return pw.graphs.louvain_level(v, e2)


def _multilevel(pw):
    n_cliques = 10

    class VS(pw.Schema):
        n: int

    V = pw.debug.table_from_rows(VS, [(i,) for i in range(3 * n_cliques)])
    edges = []
    for c in range(n_cliques):
        base = 3 * c
        edges += [(base, base + 1, 1.0), (base + 1, base + 2, 1.0),
                  (base, base + 2, 1.0)]
        edges.append((base + 2, (base + 3) % (3 * n_cliques), 1.0))

    class ES(pw.Schema):
        ui: int
        vi: int
        weight: float

    Eraw = pw.debug.table_from_rows(
        ES, edges + [(v, u, w) for u, v, w in edges])
    j1 = Eraw.join(V, Eraw.ui == V.n).select(u=V.id, vi=Eraw.vi,
                                             weight=Eraw.weight)
    E = j1.join(V, j1.vi == V.n).select(u=j1.u, v=V.id, weight=j1.weight)
    out = pw.graphs.louvain_communities(V, E, levels=2, iteration_limit=12)
    return V.select(n=V.n, community=out.ix(V.id).community)


def _streaming_update(pw):
    names = ["a", "b", "c", "x", "y", "z", "w"]
    v = pw.debug.table_from_markdown("\n".join(["n"] + names),
                                     id_from=["n"])
    e = pw.debug.table_from_markdown("""
        | su | sv | weight | __time__ | __diff__
      1 | a  | b  | 1.0 | 2 | 1
      2 | b  | c  | 1.0 | 2 | 1
      3 | a  | c  | 1.0 | 2 | 1
      4 | x  | y  | 1.0 | 2 | 1
      5 | y  | z  | 1.0 | 2 | 1
      6 | x  | z  | 1.0 | 2 | 1
      7 | w  | x  | 5.0 | 4 | 1
      8 | w  | y  | 5.0 | 4 | 1
    """)
    e2 = e.select(u=v.pointer_from(e.su), v=v.pointer_from(e.sv),
                  weight=e.weight)
    return pw.graphs.louvain_level(v, e2)


def _check_bf(state, want):
    assert sorted(r[0] for r in state.values()) == want


def _check_two_cliques(state):
    comms = {}
    for _k, (c,) in state.items():
        comms.setdefault(c, 0)
        comms[c] += 1
    assert sorted(comms.values()) == [3, 3]


def _check_multilevel(state):
    comm = {n: c for n, c in state.values()}
    for c in range(10):
        assert len({comm[3 * c], comm[3 * c + 1], comm[3 * c + 2]}) == 1
    assert len(set(comm.values())) < 10


def _check_streaming(state):
    comms = {}
    for _k, (c,) in state.items():
        comms[c] = comms.get(c, 0) + 1
    assert sorted(comms.values()) == [3, 4]


# (case of tests/test_graphs.py, build(pw), check of the JAX test)
CASES = {
    "bellman_ford": (_bellman_ford,
                     lambda s: _check_bf(s, [0.0, 1.0, 3.0, math.inf])),
    "bellman_ford_unreachable_and_relaxation": (
        _bellman_ford_relaxation,
        lambda s: _check_bf(s, [0.0, 2.0, 5.0, math.inf])),
    "louvain_two_cliques": (_two_cliques, _check_two_cliques),
    "louvain_communities_multilevel": (_multilevel, _check_multilevel),
    "louvain_streaming_update_moves_vertex": (_streaming_update,
                                              _check_streaming),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_case_equals_the_jax_packages(case, fresh_port, monkeypatch):
    build, check = CASES[case]
    [state] = equal_to_jax(build, monkeypatch, tiers=("numpy", "device"))
    check(state)


@pytest.fixture(scope="module")
def rmat():
    _n, pairs = cs.rmat_edges(np, 7, 7, 16)
    w = np.random.default_rng(8).integers(1, 65, len(pairs)).astype(float)
    return pairs, w.tolist()


def test_rmat_pagerank_equals_jax_and_the_integer_reference(rmat,
                                                            fresh_port):
    pairs, _w = rmat

    def build(pw):
        return pw.graphs.pagerank(cs._edge_table(pw, pairs), steps=5)

    state = capture("torch", build)[0]
    assert state == capture("jax", build)[0]
    from pathway_tpu_torch.internals.value import ref_scalar

    want = cs.pagerank_reference(np, pairs, 5)
    assert state == {ref_scalar(x): (r,) for x, r in want.items()}


def test_rmat_bellman_ford_equals_jax_and_dijkstra(rmat, fresh_port):
    import scipy.sparse
    import scipy.sparse.csgraph

    pairs, w = rmat
    n = 1 << 7
    src = int(np.bincount(pairs[:, 0]).argmax())

    def build(pw):
        return pw.graphs.bellman_ford(cs._vertex_tables(pw, n, src),
                                      cs._edge_table(pw, pairs, w))

    state = capture("torch", build)[0]
    assert state == capture("jax", build)[0]
    from pathway_tpu_torch.internals.value import ref_scalar

    csr = scipy.sparse.csr_matrix((w, (pairs[:, 0], pairs[:, 1])),
                                  shape=(n, n))
    ref = scipy.sparse.csgraph.dijkstra(csr, directed=True, indices=src)
    assert state == {ref_scalar(i): (float(ref[i]),) for i in range(n)}


def test_graph_and_weighted_graph_dataclasses():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    for pw in (jpw, tpw):
        assert pw.graphs.WeightedGraph.from_vertices_and_weighted_edges(
            "V", "E") == pw.graphs.WeightedGraph("V", "E", "E")
        assert pw.graphs.Graph("V", "E").E == "E"
