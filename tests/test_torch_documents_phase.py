"""``chip_smoke.py``'s phase 4r run on the CPU at a 32nd of its sizes,
with a one-layer encoder of width 64: files of a Drive stand-in, a
SharePoint library and a filesystem read streaming, changed in four
rounds while the run goes on, parsed, embedded and indexed, with a
brute-force index's top-10 equal to numpy's over the rows it holds and
every unchanged file read once; the host tier against the encoder's
rows; then the fake Airbyte connector's syncs counted on the device tier
(pinned low) and with numpy pinned into DuckDB's two output modes, the
device run also into Slack and the live view, and a run resumed from its
saved state re-reading no user.
"""

import types

import numpy as np
import torch

import chip_smoke


def test_chip_smoke_phase_4r_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    sizes = chip_smoke.doc_sizes(32)
    line = chip_smoke.phase4r(torch, np, types.SimpleNamespace(
        smi="cpu", seed=0, device="cpu", **sizes))
    doc, ab = line["documents"], line["airbyte"]
    assert doc["docs"] == 96 and doc["per_source"] == 32
    assert doc["live"] == 96 and doc["unchanged_read_once"] > 0
    # the changes race the scans: what failed was retried and counted
    assert doc["failed_polls"] >= 0 and doc["failed_downloads"] >= 0
    assert doc["indexed_vs_embed_batch_max_abs"] <= chip_smoke.DB_EMB_TOL
    assert doc["changes"] == 3 * 4 * 3
    assert set(doc["sources"]) == {"gdrive", "sharepoint", "pyfilesystem"}
    host = doc["host_tier"]
    assert host["max_abs_vs_card"] <= chip_smoke.DC_HOST_TOL
    assert host["mirror_max_abs_vs_card"] <= chip_smoke.DC_HOST_TOL
    planted = host["planted_max_abs_vs_card"]
    assert planted["ln_eps_1e-3"] > chip_smoke.DC_HOST_TOL
    assert planted["last_layer_dropped"] > chip_smoke.DC_HOST_TOL
    assert ab["users"] == chip_smoke.DC_USERS // 32 and ab["resumed_rows"] == 0
    assert ab["device"]["tiers"]["vecplan"] + ab["device"]["tiers"][
        "segment"] > 0
    assert len(ab["device"]["sync_out_s"]) == chip_smoke.DC_SYNCS
    slack = ab["device"]["slack"]
    assert slack["posts"] == slack["alert_rows_added"] > 0
    assert slack["alert_rows_retracted"] > 0
    assert line["reduced"]["docs"] == [96, chip_smoke.DC_DOCS]
    assert line["reduced"]["users"] == [256, chip_smoke.DC_USERS]
