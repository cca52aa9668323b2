"""``chip_smoke.py``'s phase 4o run on the CPU at a 16th of its sizes
(its least: ``queue_sizes``):
Nexmark events over the stand-in Kafka, registry, NATS, MQTT, AMQP and
Kinesis with the bids and auctions in one synchronization group, on the
device tier (pinned low) and with numpy pinned, every sink equal to its
query's capture and the tiers to each other and to the in-memory
queries; then the Kafka wordcount crashed after its third journal commit
into the in-memory S3 store and restarted, reading no message again.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke


def test_chip_smoke_phase_4o_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    sizes = chip_smoke.queue_sizes(16)
    line = chip_smoke.phase4o(torch, np, types.SimpleNamespace(
        smi="cpu", seed=0, device="cpu", **sizes))
    wire, restart = line["wire"], line["restart"]
    assert wire["events"] == sizes["events"] == 2048
    for tier in ("device", "numpy"):
        r = wire[tier]
        assert r["registry"]["gets"] == 1
        assert r["messages"]["kafka_avro"] == wire["rows"]["bids"]
        assert r["sync_gap_ms"] <= (chip_smoke.NX_WINDOW_MS
                                    + chip_smoke.NX_SPAN_MS
                                    // chip_smoke.NX_BATCHES)
        assert sum(r["sync_parked"].values()) > 0
    assert wire["device"]["tiers"]["vec"]["device_batches"] > 0
    assert wire["numpy"]["tiers"]["vec"]["device_batches"] == 0
    assert restart["reread"] == 0 and restart["journal_objects"] > 0
    assert restart["journalled_offset"] > 0
    assert line["reduced"]["events"] == [2048, chip_smoke.NX_EVENTS_FULL]
    with pytest.raises(ValueError, match="cycle"):
        chip_smoke.queue_sizes(32)
