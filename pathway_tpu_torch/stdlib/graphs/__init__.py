"""Graph algorithms on tables (the port of ``pathway_tpu/stdlib/graphs``;
reference: stdlib/graphs/ — Bellman-Ford, Louvain communities, pagerank,
graph utilities).  They run on ``pw.iterate``, whose body re-runs as a
whole batch at every iteration."""

from __future__ import annotations

import dataclasses
import math

from ...internals import reducers as R
from ...internals.iterate import iterate
from ...internals.table import Table


@dataclasses.dataclass
class Graph:
    """Vertex + edge tables; edges have columns u, v (vertex pointers)."""

    V: Table
    E: Table


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """Shortest distances from rows with is_source=True.

    vertices: columns [is_source]; edges: columns [u, v, dist] with u/v vertex
    pointers.  Returns a table with dist_from_source per vertex
    (reference: stdlib/graphs/bellman_ford).
    """
    from ... import coalesce, if_else

    init = vertices.select(dist=if_else(vertices.is_source, 0.0, math.inf))

    def step(state: Table) -> Table:
        relaxed = edges.join(state, edges.u == state.id).select(
            v=edges.v, d=state.dist + edges.dist
        )
        best = relaxed.groupby(relaxed.v).reduce(relaxed.v, d=R.min(relaxed.d))
        best = best.with_id(best.v)
        looked = best.ix(state.id, optional=True)
        cand = coalesce(looked.d, math.inf)
        return state.select(dist=if_else(cand < state.dist, cand, state.dist))

    return iterate(lambda state: step(state), state=init)


def louvain_level(vertices: Table, edges: Table, iteration_limit: int = 20) -> Table:
    """One Louvain level: each vertex joins the neighbor community with the
    best modularity gain, iterated to stability.

    vertices: any columns (ids used); edges: columns [u, v, weight] with u/v
    vertex pointers (symmetric edge list).  Returns a table keyed by vertex
    with a `community` column.

    Reference: stdlib/graphs/louvain_communities/impl.py (385 LoC).  This is
    the synchronous (parallel-update) variant — all vertices re-evaluate
    against the previous assignment each round, the dataflow-friendly
    formulation (the reference randomizes move order instead).
    """
    from ... import coalesce
    from ...internals import reducers as R
    from ...internals.iterate import iterate

    m2 = edges.reduce(w=R.sum(edges.weight))  # single row: 2m for symmetric edges

    init = vertices.select(community=vertices.id)

    n_phases = 4

    def step(state: Table) -> Table:
        # phased updates (vertices move only on their id-hash phase):
        # sequential-like ordering avoids both the 2-cycle oscillation of
        # fully synchronous label moves and the shallow local optima that
        # same-phase simultaneous moves create (the reference randomizes
        # move order for the same reason)
        s = state
        for ph in range(n_phases):
            s = _half_step(s, ph)
        return s

    def _half_step(state: Table, parity: int) -> Table:
        from ... import if_else as _ie

        cv = state.ix(edges.v)  # community of each edge target
        cu = state.ix(edges.u)  # vertex's own community
        contrib = edges.select(
            u=edges.u, com=cv.community, w=edges.weight, ucom=cu.community,
            is_self=edges.u == edges.v,
        )
        # edge mass from each vertex into each neighboring community.
        # Self-loops (contracted-graph intra mass) count toward the degree
        # but NOT toward w(u -> own community \ u) — a vertex's own loop is
        # not an edge to the other members, so it must not inflate the
        # stay score (this is what makes multi-level contraction correct).
        # An explicit zero-weight row per vertex keeps the stay option
        # available even for communities the vertex has no non-self edge to.
        stay0 = state.select(
            u=state.id, com=state.community, w=0.0, ucom=state.community,
            is_self=False,
        )
        contrib2 = contrib.concat_reindex(stay0)
        per = contrib2.groupby(contrib2.u, contrib2.com).reduce(
            contrib2.u, contrib2.com,
            w=R.sum(_ie(contrib2.is_self, 0.0, contrib2.w)),
            ucom=R.any(contrib2.ucom),
        )
        # weighted degree per vertex (self-loops included), keyed by pointer
        deg = contrib.groupby(contrib.u).reduce(contrib.u, k=R.sum(contrib.w))
        deg = deg.with_id(deg.u)
        # total degree per community
        com_k = state.select(
            community=state.community,
            k=coalesce(deg.ix(state.id, optional=True).k, 0.0),
        )
        sigma = com_k.groupby(com_k.community).reduce(
            com_k.community, tot=R.sum(com_k.k)
        )
        sigma = sigma.with_id(sigma.community)
        perk = per.with_columns(
            ku=coalesce(deg.ix(per.u, optional=True).k, 0.0),
            sig=coalesce(sigma.ix(per.com, optional=True).tot, 0.0),
            m2=coalesce(m2.ix(per.pointer_from(), optional=True, context=per).w, 1.0),
        )
        # modularity gain of joining community C: w(u->C) - k_u*sigma_{C\u}/2m.
        # For the vertex's own community, sigma must exclude k_u (standard
        # Louvain: the vertex is removed before evaluating moves); a tiny
        # stay-bonus breaks exact ties toward not moving.
        from ... import if_else as _if_else

        perk = perk.with_columns(
            gain=perk.w
            - perk.ku
            * (perk.sig - _if_else(perk.com == perk.ucom, perk.ku, 0.0))
            / (perk.m2 + 1e-12)
            + _if_else(perk.com == perk.ucom, 1e-9, 0.0)
        )
        best = perk.groupby(perk.u).reduce(
            perk.u,
            best_com=R.argmax(perk.gain, perk.com),
        )
        best = best.with_id(best.u)
        looked = best.ix(state.id, optional=True)
        from ... import apply_with_type, if_else
        from ...internals import dtype as dt

        my_parity = apply_with_type(lambda p: int(p) % n_phases, dt.INT, state.id)
        return state.select(
            community=if_else(
                my_parity == parity,
                coalesce(looked.best_com, state.community),
                state.community,
            )
        )

    return iterate(lambda state: step(state), iteration_limit=iteration_limit,
                   state=init)


def louvain_communities(vertices: Table, edges: Table, *, levels: int = 2,
                        iteration_limit: int = 20) -> Table:
    """Multi-level Louvain: run a level, contract communities into a
    super-graph, and repeat — the full hierarchy of the reference's
    louvain_communities (stdlib/graphs/louvain_communities/impl.py, 385 LoC),
    with a static level count (the dataflow graph is built once; levels is
    the standard <=2-5 in practice — modularity gains vanish quickly).

    Returns the finest-level vertices with their final (top-level) community.
    """
    assignment = louvain_level(vertices, edges, iteration_limit)
    total = assignment  # community per ORIGINAL vertex
    for _ in range(1, levels):
        # contract to the super-graph of the current top-level communities
        # (projecting the ORIGINAL edges through the composed labels yields
        # exactly the contracted graph's edge weights)
        cu = total.ix(edges.u)
        cv = total.ix(edges.v)
        proj = edges.select(cu=cu.community, cv=cv.community,
                            w=edges.weight)
        grouped = proj.groupby(proj.cu, proj.cv).reduce(
            cu=proj.cu, cv=proj.cv, weight=R.sum(proj.w)
        )
        super_vertices = (
            total.groupby(total.community).reduce(c=total.community)
        )
        super_vertices = super_vertices.with_id(super_vertices.c)
        super_edges = grouped.select(
            u=grouped.cu, v=grouped.cv, weight=grouped.weight
        )
        # cluster the super-graph, then push the coarser labels down to the
        # original vertices (label composition)
        super_assign = louvain_level(super_vertices, super_edges,
                                     iteration_limit)
        lifted = super_assign.ix(total.community)
        total = total.select(community=lifted.community)
    return total


class Vertex:
    """Vertex schema marker (reference: stdlib/graphs/common.py:10)."""


class Edge:
    """Edge schema marker: columns u, v point at the endpoint vertices
    (reference: stdlib/graphs/common.py:14)."""


@dataclasses.dataclass
class WeightedGraph(Graph):
    """Graph whose edges carry weights (reference: graphs/graph.py:121)."""

    WE: Table | None = None

    @staticmethod
    def from_vertices_and_weighted_edges(V: Table, WE: Table) -> "WeightedGraph":
        return WeightedGraph(V, WE, WE)


def pagerank(edges: Table, steps: int = 5) -> Table:
    """Integer-arithmetic PageRank over an edge table with columns u, v
    (reference: stdlib/graphs/pagerank/impl.py:18 — same fixed-point
    scheme: rank starts at 6000 per vertex, each step flows
    rank*5/(6*degree) along edges plus a 1000 base; incremental by
    construction, so edge updates revise ranks)."""
    from ... import if_else
    from ...internals.table import Table as _Table

    # vertex tables keyed by the vertex pointer itself
    inv0 = edges.groupby(edges.v).reduce(edges.v)
    inv = inv0.with_id(inv0.v)
    inv = inv.select(degree=0)
    outv0 = edges.groupby(edges.u).reduce(edges.u, degree=R.count())
    outv = outv0.with_id(outv0.u)
    outv = outv.select(degree=outv.degree)
    degrees = _Table.update_rows(inv, outv)
    base = outv.difference(inv).select(rank=1_000)  # pure sources
    ranks = degrees.select(rank=6_000)
    for _ in range(steps):
        outflow = degrees.select(
            flow=if_else(
                degrees.degree == 0, 0,
                (ranks.rank * 5) // (degrees.degree * 6),
            ),
        )
        per_edge = edges.select(edges.v, f=outflow.ix(edges.u).flow)
        inflows0 = per_edge.groupby(per_edge.v).reduce(
            per_edge.v, rank0=R.sum(per_edge.f)
        )
        inflows = inflows0.with_id(inflows0.v)
        inflows = inflows.select(rank=inflows.rank0 + 1_000)
        ranks = _Table.concat(base, inflows).with_universe_of(degrees)
    return ranks
