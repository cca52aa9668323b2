"""``chip_smoke.py``'s phase 4p run on the CPU at 8,192 updates: the
wordcount in this process, at ``PATHWAY_THREADS=4`` and under ``spawn
-n 2 -t 2`` with each sink equal to a plain count; under the same
supervisor the cluster streaming under ``Backend.filesystem``, process 1
killed at its third exchange mark and relaunched, the sinks exactly
once; then the single-process program without and with the metrics
server, the progress reporter, the OTLP export and the recorder.
"""

import types

import numpy as np
import torch

import chip_smoke


def test_chip_smoke_phase_4p_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    line = chip_smoke.phase4p(torch, np, types.SimpleNamespace(
        smi="cpu", seed=0, device="cpu", rows=8192,
        metrics_port=chip_smoke.free_port()))
    assert line["rows"] == 8192 and line["reduced"]["rows"] == [
        8192, chip_smoke.DP_ROWS_FULL]
    spawned = line["shapes"]["spawned"]
    assert set(spawned["run_s"]) == {0, 1}
    # the fabric carried the exchange, and every process's cost-store key
    # survived the other's flushes
    assert spawned["fabric_bytes"] > 0 and spawned["data_frames"] > 0
    assert spawned["costdb_keys"] >= chip_smoke.CL_PROCS
    assert spawned["mesh_s"] > 0
    kill = line["kill"]
    assert kill["fault"] == "fabric.mark:kill:3:1"
    assert kill["rows"] == line["reduced"]["kill_rows"][0] > 0
    assert set(kill["relaunch_run_s"]) == {0, 1}
    assert kill["recovery_s"] > 0 and kill["remesh_s"] > 0
    mon = line["monitoring"]["runs"]["monitored"][-1]
    assert mon["scrapes"] >= 3 and mon["progress_lines"] >= 1
    assert mon["otlp_posts"] == {"/v1/traces": 1, "/v1/metrics": 1}
    assert mon["recorder_rows"] > 0
