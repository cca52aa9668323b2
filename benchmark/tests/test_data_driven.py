"""A cell, a configuration, a traffic mix and a per-layer metric can be
added as files alone: a throwaway cell in a temporary directory is found
by name and run on the CPU with the files that are there."""

import json
import shutil
from pathlib import Path

import torch

from benchmark import run
from benchmark.harness.stats import Run
from benchmark.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_throwaway_cell_from_files(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / sub, here / sub)
    (here / "configs" / "gpt2-tiny.json").write_text(json.dumps(tiny.gpt2()))
    (here / "traffic" / "tiny_decode.json").write_text(
        json.dumps(tiny.decode_mix()))
    (here / "limits" / "gpt2tiny.tiny_decode.json").write_text(
        json.dumps({"logit_gap": 1e-3}))
    (here / "metrics" / "answered_share.tiny.py").write_text(
        '"""Share of the window\'s requests answered."""\n\n'
        "def read(run):\n"
        "    due = [r for r in run.result['requests']\n"
        "           if run.result['t_open'] <= r.due < run.result['t_close']]\n"
        "    return 100.0 * sum(bool(r.tokens) for r in due) / len(due)\n")
    bench["configs"].append({"name": "gpt2-tiny", "source": "test",
                             "file": "benchmark/configs/gpt2-tiny.json",
                             "reduced": ["n_embd"], "why": "test"})
    bench["workloads"].append({"name": "gpt2tiny.tiny_decode",
                               "config": "gpt2-tiny", "traffic": "tiny_decode",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "answer_tokens_per_s":
            m["workloads"].append("gpt2tiny.tiny_decode")
    bench["per_layer"].append({"name": "answered_share.tiny", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve", "moves": "answer_tokens_per_s",
                               "workloads": ["gpt2tiny.tiny_decode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = run.load_cell("gpt2tiny.tiny_decode", root=tmp_path, here=here)
    cell = run.system(spec["config"]).Cell(spec["config"], spec["mix"], 3,
                                           torch.device("cpu"))
    cell.setup()
    result = cell.run_window(1.0, lambda: None, lambda: None)
    r = Run(spec["config"], spec["mix"], result, None,
            result["t_close"] - result["t_open"], 0.0)
    name = "gpt2tiny.tiny_decode"
    e2e = [m for m in bench["end_to_end"]
           if run.applies(m, name, bench["end_to_end"])]
    layer = [m for m in bench["per_layer"]
             if run.applies(m, name, bench["end_to_end"])]
    assert {m["name"] for m in e2e} == {"answer_tokens_per_s", "setup_s"}
    assert [m["name"] for m in layer] == ["answered_share.tiny"]
    values = run.read_metrics(e2e + layer, r, here)
    assert values["answered_share.tiny"]["value"] == 100.0
    assert values["answer_tokens_per_s"]["value"] > 0
    cell.stop_program()
    ok, checks = run.judge(cell.check(result), spec["limits"])
    assert ok and set(checks) == {"logit_gap"}
