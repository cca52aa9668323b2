"""``chip_smoke.py``'s phase 4q run on the CPU at a 32nd of its sizes,
with a one-layer encoder of width 64: MySQL rows read streaming,
updated and deleted while the run goes on, embedded and kept in the
Pinecone, Qdrant, Chroma, Milvus and Weaviate stand-ins (HTTP on
127.0.0.1) and LEANN's index, with a brute-force index's top-10 equal to
numpy's over the stores' vectors; then a SQL Server snapshot and its CDC
transactions counted on the device tier (pinned low) and with numpy
pinned, into nine sinks that each hold the numpy count, and three of
them read back.
"""

import types

import numpy as np
import torch

import chip_smoke


def test_chip_smoke_phase_4q_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    sizes = chip_smoke.db_sizes(32)
    line = chip_smoke.phase4q(torch, np, types.SimpleNamespace(
        smi="cpu", seed=0, device="cpu", **sizes))
    vec, cdc = line["vectors"], line["cdc"]
    docs = chip_smoke.DB_DOCS // 32
    assert vec["docs"] == docs and vec["live"] == docs - vec["deleted"] > 0
    assert vec["updated"] > 0 and vec["failed_polls"] == 0
    assert vec["stored_vs_embed_batch_max_abs"] <= chip_smoke.DB_EMB_TOL
    assert set(vec["store_requests"]) == set(chip_smoke.DB_STORES)
    assert cdc["rows"] == chip_smoke.DB_WC_ROWS // 32 and cdc["rekeyed"] > 0
    assert cdc["device"]["tiers"]["vecplan"] > 0
    assert cdc["device"]["read_back_rows"]["clickhouse"] == cdc["words"]
    assert line["reduced"]["docs"] == [docs, chip_smoke.DB_DOCS_FULL]
    assert line["reduced"]["wc_rows"][1] == chip_smoke.DB_WC_ROWS_FULL
