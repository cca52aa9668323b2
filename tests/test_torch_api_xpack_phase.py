"""``chip_smoke.py``'s phase 4s run on the CPU at a 64th of its files,
with a one-layer encoder of width 64, a two-layer decoder and short
transcripts: audio and video files parsed by ``AudioParser`` and
``TwelveLabsVideoParser`` over HTTP stand-ins on 127.0.0.1, indexed,
and questions answered on the scheduled, expression and Bedrock routes,
each answer held to the same prompt answered alone.
"""

import types

import numpy as np
import torch

import chip_smoke
from pathway_tpu_torch.models import decoder as dec


def test_chip_smoke_phase_4s_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    sizes = chip_smoke.api_sizes(64)
    s = types.SimpleNamespace(
        smi="cpu", seed=0, device="cpu",
        engine_sizes=dict(num_blocks=64, block_size=16, max_batch_size=4,
                          chain_steps=4, max_restarts=0), **sizes)
    line, launches = chip_smoke.phase4s(torch, np, dec, s)
    assert line["audio"] == 32 and line["videos"] == 1 and line["docs"] == 33
    assert line["stand_ins"]["whisper"] == {"wav": 11, "mp3": 11, "flac": 10}
    assert line["stand_ins"]["twelvelabs"] == dict(tasks=1, polls=2,
                                                   generates=1)
    assert line["stand_ins"]["converse"] == 2
    routes = line["routes"]
    assert [routes[r]["questions"] for r in ("scheduled", "expression",
                                             "bedrock")] == [4, 2, 2]
    assert line["topk_checked"] == 4
    assert line["retrieve_scores_err"] <= chip_smoke.KNN_TOL
    # the CPU launches no kernel; the index still ran its passes
    assert set(launches.values()) == {0} and line["index_query_batches"]
    assert line["engine_rounds"]["mixed"] + line["engine_rounds"].get(
        "prefill", 0) > 0
    assert line["reduced"]["audio"] == [32, chip_smoke.AX_AUDIO]
    assert set(line["cpu_only"]) == set(chip_smoke.AX_CPU_ONLY)
