"""On the card: each cell's control (the program on its own path one
precision step down: the engine's int8 weights) fails the cell's limits
on three seeds, at the cell's own size.  Run there with ``python -m
pytest -m gpu benchmark/tests``; it skips where no card is present."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
# the cells of BENCHMARK.json, each with a window that finishes enough of
# its requests to sample
CELLS = [("gpt2xl.long_decode", 25)]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,seconds", CELLS)
def test_control_fails_the_limits(cuda_device, workload, seconds):
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", workload,
         "--seconds", str(seconds), "--control", "1",
         "--readings", "7000000001,7000000002,7000000003"],
        capture_output=True, text=True, timeout=1800, check=True)
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert any(row["readings"][n] > lim for n, lim in limits.items()), row
