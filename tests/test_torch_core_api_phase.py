"""Phase 4n of ``chip_smoke.py`` on the CPU at small sizes (counts divided
by 64): TPC-H through ``pw.sql`` = ``sqlite3``, pagerank and Bellman-Ford
= their plain references, Louvain, the transformer, the HMM = Viterbi,
the fuzzy join, and the native hash = its mirror, each data-plane part on
both tiers with equal captures."""

import types

import numpy as np
import torch

import chip_smoke as cs


def test_chip_smoke_phase_4n_runs_on_the_cpu():
    s = types.SimpleNamespace(smi="cpu", seed=0, device="cpu",
                              sizes=cs.core_sizes(64))
    line = cs.phase4n(torch, np, s)
    z = s.sizes
    assert set(line["sql"]["queries"]) == {"q1", "q3", "q6"}
    assert all(q["groups"] > 0 for q in line["sql"]["queries"].values())
    assert line["graphs"]["pagerank"]["vertices"] > 0
    assert line["graphs"]["louvain"]["vertices"] == z["louvain_n"] == 32
    assert line["transformer"]["nodes"] == z["tree_nodes"] == 256
    assert line["hmm"]["observations"] == z["hmm_obs"] == 32
    assert line["fuzzy"]["pairs"] > 0
    assert line["native"]["rows_checked"] == z["hash_rows_py"] == 1024
    assert line["native"]["jsonlines"]["lines"] == 1024
    assert line["reduced"]["tpch_sf"] == [z["tpch_sf"], 0.1]
    assert line["reduced"]["louvain_n"] == [32, 4096]
    # the tiers: the numpy run never reaches the device tier; the device
    # run of each part that vectorizes sends it at least one batch
    assert line["pin_device"] == z["pin"] == 32
    runs = [q for q in line["sql"]["queries"].values()]
    runs += [line["graphs"][k] for k in ("pagerank", "bellman_ford",
                                         "louvain")]
    runs += [line[k] for k in ("transformer", "hmm", "fuzzy")]
    assert all(r["numpy"]["tiers"]["device"] == 0 for r in runs)
    on_card = list(line["sql"]["queries"].values()) + [
        line["graphs"]["pagerank"], line["fuzzy"]]
    assert all(r["device"]["tiers"]["device"] > 0 for r in on_card)
    lv = line["graphs"]["louvain"]
    assert lv["modularity"] >= 0.9 * lv["modularity_planted"]


def test_the_full_sizes_are_graph500_and_tpch_and_the_cuts_are_listed():
    z = cs.core_sizes()
    assert cs.CORE_FULL["tpch_sf"] == 0.1
    assert cs.CORE_FULL["rmat_scale"] == 14
    assert (cs.CORE_FULL["louvain_n"], cs.CORE_FULL["louvain_groups"]) == (
        4096, 64)
    assert z["hash_rows"] == cs.CORE_FULL["hash_rows"] == 1 << 20
    assert z["jsonl_lines"] == 65536 and z["tree_nodes"] == 16384
    assert set(cs.CORE_CUT) <= set(cs.CORE_FULL)
    assert z["pin"] == cs.CORE_PIN < 1024
    assert z["louvain_iterations"] == cs.CORE_FULL["louvain_iterations"]


def test_core_graph_costs_runs_on_the_cpu():
    """``--core-graph-costs`` at small sizes: each graph algorithm built,
    one body run of each iterate, and the limit it lowered put back."""
    from pathway_tpu_torch.internals import iterate as it

    limit = it._DEFAULT_LIMIT
    z = dict(cs.CORE_FULL, rmat_scale=6, louvain_n=64, louvain_groups=4)
    line = cs.core_graph_costs(torch, np, 0, "cpu", device="cpu", sizes=z)
    assert it._DEFAULT_LIMIT == limit
    assert line["iterations"] == 1 and line["rmat_scale"] == 6
    assert line["pagerank"]["rows"] > 0
    assert line["bellman_ford"]["rows"] == 64
    assert line["louvain_level"]["rows"] == line["louvain_communities"][
        "rows"] == 64
    assert all(line[k]["wall_s"] > 0 for k in (
        "pagerank", "bellman_ford", "louvain_level", "louvain_communities"))
