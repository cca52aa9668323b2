"""Phase 4k of ``chip_smoke.py`` on the CPU at 4,096 events: its Nexmark
generator, its queries through both packages and its plain reference,
all three equal — the check that makes the reference a yardstick on the
card, where there is no JAX.

Each query's capture from the port (its numpy and device tiers, the
crossovers pinned low for the latter) equals the JAX package's key for
key, and its values equal the reference's; each windowby and join
operator's ``state_size()`` equals the JAX package's and stays within
the reference's bound.  The phase's streaming run, async UDFs, iterate
and gradual broadcast run here too, on the CPU, at small sizes.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke as cs
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine.runner import GraphRunner as JRunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine.gradual_broadcast import _threshold_key
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import fresh_port  # noqa: F401

N_EVENTS = 4096
QUERIES = ("q7", "q5", "q4", "q8", "interval", "asof", "diff")


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def ev():
    return cs.nexmark_events(np, 0, N_EVENTS)


@pytest.fixture(scope="module")
def ref(ev):
    return cs.nexmark_reference(ev)


def test_the_generator_follows_the_nexmark_defaults(ev):
    n = {k: len(ev[k]) for k in ("persons", "auctions", "bids")}
    # 1 person, 3 auctions and 46 bids of every 50 events
    assert n == {"persons": 82, "auctions": 246, "bids": 3768}
    assert sorted(set(ev["bid_times"])) == [2 * (b + 1) for b in range(16)]
    person_ids = {p[0] for p in ev["persons"]}
    auction_ids = {a[0] for a in ev["auctions"]}
    assert min(person_ids) == min(auction_ids) == cs.NX_FIRST_ID
    assert all(b[0] in auction_ids and b[1] in person_ids for b in ev["bids"])
    assert all(a[7] in person_ids for a in ev["auctions"])
    opened = [a[5] for a in ev["auctions"]]
    assert opened == sorted(opened)
    assert all(0 <= p[6] < cs.NX_SPAN_MS for p in ev["persons"])
    per_auction = collections.Counter((b[0], b[5]) for b in ev["bids"])
    assert max(per_auction.values()) == 1  # the diff's order has no ties
    late = collections.Counter(ev["lateness"])
    assert 0.04 < late[1] / n["bids"] < 0.065
    assert 0.001 < late[2] / n["bids"] < 0.01


def test_the_reference_drops_exactly_the_bids_past_the_cutoff(ref):
    assert cs.nexmark_late_ok(ref["late"])
    assert ref["late"][(1, "kept")] > 0 and ref["late"][(2, "dropped")] > 0


def _jax_state(q):
    jpg.G.clear()
    try:
        ev = cs.nexmark_events(np, 0, N_EVENTS)
        queries, parts = cs.nexmark_queries(jpw, *cs.nexmark_tables(jpw, ev))
        sink = queries[q]._materialize_capture()
        graph = JRunner([sink])
        state = graph.run_batch()[sink.id].squash()
        return state, graph, queries, parts
    finally:
        jpg.G.clear()


@pytest.mark.parametrize("q", QUERIES)
def test_the_query_gives_the_jax_capture_and_the_reference(q, ev, ref,
                                                           monkeypatch):
    want, jgraph, jq, jparts = _jax_state(q)
    assert cs.values_counter(want) == ref[q]
    for pin in (64, cs.DP_NEVER):
        tpg.G.clear()
        queries, parts = cs.nexmark_queries(tpw, *cs.nexmark_tables(tpw, ev))
        run = cs.nexmark_run(torch, queries[q], pin, device="cpu")
        assert run["state"] == want, pin
    sizes = {}
    for name, (table, kind) in {
            "q7_groupby": (("q7", None), "groupby"),
            "q5_groupby": (("q5", "q5_counts"), "groupby"),
            "q5_top_groupby": (("q5", "q5_top"), "groupby"),
            "q5_join": (("q5", None), "join"),
            "q4_join": (("q4", None), "join"),
            "q8_join": (("q8", None), "join"),
            "interval_join": (("interval", None), "join"),
            "asof_join": (("asof", None), "asof_join")}.items():
        if table[0] != q:
            continue
        t_port = parts[table[1]] if table[1] else queries[q]
        t_jax = jparts[table[1]] if table[1] else jq[q]
        size = cs.upstream_op(run["graph"], t_port, kind).state_size()
        assert size == cs.upstream_op(jgraph, t_jax, kind).state_size()
        assert size <= ref["bounds"][name], name
        sizes[name] = size
    assert sizes or q == "diff"


def test_streaming_nets_to_the_batch_capture(ev):
    tpg.G.clear()
    queries, _parts = cs.nexmark_queries(tpw, *cs.nexmark_tables(tpw, ev))
    want = {q: cs.values_counter(cs.nexmark_run(
        torch, queries[q], cs.DP_NEVER, device="cpu")["state"])
        for q in ("q7", "q5")}
    tpg.G.clear()
    line = cs.nexmark_streaming(ev, want, device="cpu")
    assert len(line["lag_ms"]) == cs.NX_BATCHES
    assert 0 < line["lag_p50_ms"] <= line["lag_p99_ms"]


def test_the_async_udfs_give_embed_batch_rows(ev):
    small = dict(vocab_size=2048, d_model=48, n_layers=2, n_heads=4,
                 d_ff=96, max_len=48)
    line = cs.nexmark_async(np, ev, 0, device="cpu", rows=24, config=small)
    assert line["fully_async"]["pending_rows"] == 24
    assert line["async"]["max_err"] <= cs.NX_ASYNC_TOL


def test_iterate_and_gradual_broadcast(ev):
    it = cs.nexmark_iterate(ev, device="cpu")
    assert it["vertices"] > 10 and it["components"] >= 1
    bc = cs.nexmark_broadcast(ev, device="cpu")
    assert 0 < bc["upper"] < bc["rows"] == len(ev["auctions"])


@pytest.mark.parametrize("trip", [(0.0, 0.375, 1.0), (1.0, 2.0, 9.0),
                                  (3.0, 3.0, 3.0), (0.0, -1.0, 1.0)])
def test_the_broadcast_rule_is_the_operators(trip):
    rng = np.random.default_rng(1)
    for key in [0, (1 << 128) - 1] + [int(x) << 64 for x in
                                      rng.integers(0, 1 << 62, 32)]:
        lower, value, upper = trip
        want = upper if key < _threshold_key(*trip) else lower
        assert cs.broadcast_rule(key, *trip) == want


def test_min_label_propagation_equals_union_find(ev):
    edges = cs.nexmark_edges(ev, 2048)
    tpg.G.clear()
    [cap] = tpw.engine.runner.run_tables(
        cs.min_label_components(tpw, edges), device="cpu")
    tpg.G.clear()
    assert {n: lab for n, lab in cap.squash().values()} == cs.union_find(
        edges)
