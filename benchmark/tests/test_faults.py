"""A run with its timed path broken underneath comes out not correct.

Each test skips the look for a card, drives the rest of a run on the CPU
at a tiny size (set-up, the window, the check against the reference and
the judgement by the cell's own limits) and plants a fault that a
serving cell can have: a token or an answer altered where it is
produced, or K/V read from another row's block (``faults.py``)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.tests import faults, tiny

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def _limits(workload):
    return json.loads((LIMITS / f"{workload}.json").read_text())


def _serve(cell_cls, cfg, mix, seed):
    cell = cell_cls(cfg, mix, seed, torch.device("cpu"))
    cell.setup()
    result = cell.run_window(1.0, lambda: None, lambda: None)
    cell.stop_program()
    return {n: v for n, v, _w in cell.check(result)}, cell


def _broken(cell_cls, cfg, mix, seed, fault):
    cell = cell_cls(cfg, mix, seed, torch.device("cpu"))
    with faults.planted(fault, cell):
        cell.setup()
        result = cell.run_window(1.0, lambda: None, lambda: None)
    cell.stop_program()
    return {n: v for n, v, _w in cell.check(result)}


@pytest.mark.parametrize("fault", ["token", "kv"])
@pytest.mark.parametrize("workload,mix", [
    ("gpt2xl.rag_answer", tiny.rag_mix), ("gpt2xl.long_decode", tiny.decode_mix)])
def test_planted_fault_fails_the_decoder_cells(workload, mix, fault):
    """An altered token at the configuration's own weight scale
    (initializer_range 0.02).  A foreign K/V block at a tenfold scale:
    the tiny model's flat logits at 0.02 barely depend on the context
    (its reading at the cell's own size and scale is in PERF.md)."""
    from benchmark.systems import paged_engine

    cfg, mix = tiny.gpt2(), mix()
    if fault == "kv":
        cfg["initializer_range"] = 0.2
    limits = _limits(workload)
    sound, _c = _serve(paged_engine.Cell, cfg, mix, 11)
    assert run.judge([(n, v, "") for n, v in sound.items()], limits)[0]
    broken = _broken(paged_engine.Cell, cfg, mix, 11, fault)
    ok, checks = run.judge([(n, v, "") for n, v in broken.items()], limits)
    assert not ok, checks


def test_foreign_block_takes_the_next_rows_column():
    bt = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    assert faults.foreign_block(bt, 1).tolist() == [[1, 5, 3], [4, 8, 6],
                                                    [7, 2, 9]]
    assert faults.foreign_block(bt[:1], 1) is not None
    assert faults.foreign_block(bt, 3).tolist() == bt.tolist()


def test_altered_answer_fails_the_retrieval_cell(monkeypatch):
    from pathway_tpu_torch.stdlib.indexing import inner_index

    from benchmark.systems import retrieval

    limits = _limits("minilm.retrieve_nq")
    cfg, mix = tiny.minilm(), tiny.retrieve_mix()
    sound, _c = _serve(retrieval.Cell, cfg, mix, 12)
    for name in ("rank_score_err", "id_score_err"):
        assert sound[name] <= limits[name]
    search = inner_index.BruteForceKnn.search

    def altered(self, query, k, *a, **kw):
        res = search(self, query, k, *a, **kw)
        key, score = res[0]
        return [((key + 1) % self.n, score)] + res[1:]

    monkeypatch.setattr(inner_index.BruteForceKnn, "search", altered)
    broken, _c = _serve(retrieval.Cell, cfg, mix, 12)
    ok, checks = run.judge([(n, v, "") for n, v in broken.items()], limits)
    assert not ok
    assert checks["id_score_err"]["value"] > checks["id_score_err"]["limit"]
