"""The port's documents and apps connectors held to the JAX package's:
Google Drive, SharePoint, Slack and Airbyte.  Each test runs one program
through the JAX connector and through the port's (``device="cpu"``), on
two fresh copies of a stand-in of ``tests/torch_doc_fakes.py`` (Airbyte:
the fake connector of ``tests/airbyte_fake_connector.py``, run as
``python -S``), and holds the port to the JAX package: the downloads,
payloads and protocol calls that reach the stand-ins are equal, and so
are the rows a source reads, keys included.  The tests of the port's
decisions on the JAX package's quiet fallbacks come last.
"""

from __future__ import annotations

import json
import logging
import sys

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

from . import torch_doc_fakes as fakes
from .test_torch_io_databases import PKGS, both, run

LIVE = dict(idle_stop_s=0.5, timeout_s=20.0, autocommit_duration_ms=20)


def stopped(t):
    """A run's end does not reach a subject (in either package): the
    Drive and Airbyte subjects poll until told to stop, as here."""
    return t._node.params["source"].subject.on_stop


# -- Google Drive ---------------------------------------------------------------


def drive() -> fakes.DriveStandIn:
    d = fakes.DriveStandIn()
    d.add_folder("root")
    d.add_folder("sub", parent="root")
    d.put("f1", "a.txt", b"alpha", parent="root")
    d.put("f2", "b.txt", b"beta", parent="sub")
    d.put("f3", "notes.md", b"gamma", parent="sub")
    return d


@pytest.mark.parametrize("root,limit,pattern,want", [
    ("root", None, "*.txt", ["f1", "f2"]),
    ("root", 4, None, ["f2"]),          # only len <= 4 (beta)
    ("f3", None, None, ["f3"]),         # a single-file root
])
def test_gdrive_tree_snapshot_equals_the_jax_packages(root, limit, pattern,
                                                      want):
    from pathway_tpu.io.gdrive import _GDriveTree as JTree
    from pathway_tpu_torch.io.gdrive import _GDriveTree as TTree

    got = TTree(drive(), limit, pattern).snapshot(root)
    assert got == JTree(drive(), limit, pattern).snapshot(root)
    assert sorted(got) == want


def test_gdrive_streaming_diffs_equal_the_jax_packages():
    """A deletion retracts the exact old row, a new file adds, a changed
    file retracts and re-adds; an unchanged file is downloaded once."""

    def build(pw):
        d = drive()
        seen: list = []
        t = pw.io.gdrive.read("root", refresh_interval=0.05,
                              with_metadata=True, _client=d)
        stops.append(stopped(t))

        def mutate():
            d.remove("f1", "root")
            d.put("f4", "d.txt", b"delta", parent="root")
            d.put("f2", "b.txt", b"BETA2", parent="sub")

        def on_change(key, row, time, is_addition):
            seen.append((key, bytes(row["data"]), row["_metadata"].value,
                         is_addition))
            if len(seen) == 1:
                mutate()

        pw.io.subscribe(t, on_change=on_change)
        return d, seen

    stops: list = []
    (dt, got), (dj, want) = both(build, **LIVE)
    for stop in stops:
        stop()
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert dt.downloads == dj.downloads
    assert dt.downloads["f3"] == 1
    net: dict = {}
    for _k, data, meta, add in got:
        net[(meta["name"], data)] = net.get((meta["name"], data), 0) + (
            1 if add else -1)
    assert {k for k, v in net.items() if v > 0} == {
        ("b.txt", b"BETA2"), ("notes.md", b"gamma"), ("d.txt", b"delta")}
    assert all(v in (0, 1) for v in net.values())


def test_gdrive_requires_credentials_or_a_client():
    for pw, pg in PKGS.values():
        pg.G.clear()
        with pytest.raises(ValueError, match="credentials"):
            pw.io.gdrive.read("root")


# -- SharePoint -----------------------------------------------------------------


def test_sharepoint_poller_equals_the_jax_packages():
    """The Graph poller over folders: an added file, a changed one
    (eTag) and a deleted one, with their metadata."""

    def build(pw):
        g = fakes.GraphStandIn()
        g.put("f1", "a.txt", b"hello")
        g.put("f2", "c.txt", b"same", folder="docs/sub")
        seen: list = []
        t = pw.io.sharepoint.read(root_path="docs", refresh_interval=0.05,
                                  _client=g)

        def mutate():
            g.put("f3", "b.txt", b"zz")
            g.put("f1", "a.txt", b"hello2")
            g.remove("f2")

        def on_change(key, row, time, is_addition):
            seen.append((key, bytes(row["data"]), row["_metadata"].value,
                         is_addition))
            if len(seen) == 1:
                mutate()

        pw.io.subscribe(t, on_change=on_change)
        return g, seen

    (gt, got), (gj, want) = both(build, **LIVE)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert gt.downloads == gj.downloads
    flat = {(d, m["name"], a) for _k, d, m, a in got}
    assert {(b"hello", "a.txt", True), (b"zz", "b.txt", True),
            (b"hello", "a.txt", False), (b"hello2", "a.txt", True),
            (b"same", "c.txt", False)} <= flat


# -- Slack ----------------------------------------------------------------------


def test_slack_alerts_equal_the_jax_packages():
    """One post a row added, none for a retraction."""

    def build(pw):
        rec = fakes.SlackRecorder()

        class Msg(pw.Schema):
            msg: str

        t = pw.debug.table_from_rows(
            Msg, [("deploy_failed", 0, 1), ("disk_full", 2, 1),
                  ("deploy_failed", 4, -1)], is_stream=True)
        pw.io.slack.send_alerts(t.msg, "C012345", "xoxb-token", _http=rec)
        return rec

    got, want = both(build)
    assert got.posts == want.posts
    assert [(u, p) for u, p, _h in got.posts] == [
        ("https://slack.com/api/chat.postMessage",
         {"channel": "C012345", "text": "deploy_failed"}),
        ("https://slack.com/api/chat.postMessage",
         {"channel": "C012345", "text": "disk_full"})]
    assert got.posts[0][2]["Authorization"] == "Bearer xoxb-token"


def test_slack_takes_a_column_reference():
    for pw, pg in PKGS.values():
        pg.G.clear()
        with pytest.raises(ValueError, match="column reference"):
            pw.io.slack.send_alerts("msg", "C1", "x")


# -- Airbyte --------------------------------------------------------------------


def _source(mod, data, streams):
    return mod.ExecutableAirbyteSource(fakes.airbyte_command(),
                                       {"data_path": str(data)}, streams)


@pytest.fixture(params=["torch", "jax"])
def airbyte(request):
    if request.param == "torch":
        from pathway_tpu_torch.io import airbyte as mod
    else:
        from pathway_tpu.io import airbyte as mod
    return mod


def test_airbyte_check_discover_and_incremental_resume(tmp_path, airbyte):
    """The protocol verbs; an incremental sync from a saved state reads
    only what is new (``tests/test_airbyte.py``'s first two cases, each
    package on its own run of the connector)."""
    data = tmp_path / "d.json"
    fakes.write_airbyte_data(data, users=[{"id": 1, "name": "a"},
                                          {"id": 2, "name": "b"}])
    src = _source(airbyte, data, ["users"])
    src.check()
    catalog = src.configured_catalog
    assert [s["stream"]["name"] for s in catalog["streams"]] == ["users"]
    assert catalog["streams"][0]["sync_mode"] == "incremental"
    with pytest.raises(airbyte.AirbyteError, match="not found"):
        _source(airbyte, data, ["nope"]).configured_catalog
    msgs = list(src.extract())
    assert [m["record"]["data"]["id"] for m in msgs
            if m["type"] == "RECORD"] == [1, 2]
    state = [[m for m in msgs if m["type"] == "STATE"][-1]["state"]]
    fakes.write_airbyte_data(data, users=[{"id": i, "name": "abc"[i - 1]}
                                          for i in (1, 2, 3)])
    assert [m["record"]["data"]["id"] for m in src.extract(state)
            if m["type"] == "RECORD"] == [3]


def test_airbyte_record_keys_equal_the_jax_packages():
    from pathway_tpu.io.airbyte import _record_key as jkey
    from pathway_tpu_torch.io.airbyte import _record_key as tkey

    for stream, data in (("colors", {"color": "red"}),
                         ("users", {"id": 1, "name": "a", "x": [1, 2.5]})):
        assert tkey(stream, data) == jkey(stream, data)


def test_airbyte_read_streaming_equals_the_jax_packages(tmp_path):
    """``pw.io.airbyte.read`` over the fake connector: the incremental
    users stream picks up an appended row, the full-refresh colors stream
    retracts a removed value; the protocol calls, rows and keys are the
    JAX package's."""

    def build(pw):
        root = tmp_path / pw.__name__
        root.mkdir()
        data = root / "d.json"
        fakes.write_airbyte_data(data, users=[{"id": 1, "name": "a"}],
                                 colors=["red", "green"])
        t = pw.io.airbyte.read(fakes.airbyte_yaml(root / "conn.yaml", data),
                               ["users", "colors"], refresh_interval_ms=50)
        stops.append(stopped(t))
        calls: list = []
        src = t._node.params["source"].subject.source
        stream = src._stream

        def recorded(args, files):
            calls.append((list(args), sorted(files)))
            return stream(args, files)

        src._stream = recorded
        seen: list = []

        def mutate():
            fakes.write_airbyte_data(
                data, users=[{"id": 1, "name": "a"}, {"id": 2, "name": "b"}],
                colors=["green"])

        def on_change(key, row, time, is_addition):
            seen.append((key, row["stream"], json.dumps(
                row["data"].value, sort_keys=True), is_addition))
            if len(seen) == 1:
                mutate()

        pw.io.subscribe(t, on_change=on_change)
        return calls, seen

    stops: list = []
    (tcalls, got), (jcalls, want) = both(
        build, idle_stop_s=1.0, timeout_s=30.0, autocommit_duration_ms=20)
    for stop in stops:
        stop()
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert tcalls[:2] == jcalls[:2] == [
        (["discover"], ["config"]), (["read"], ["catalog", "config"])]
    assert (["read"], ["catalog", "config", "state"]) in tcalls
    net: dict = {}
    for _k, s, d, add in got:
        net[(s, d)] = net.get((s, d), 0) + (1 if add else -1)
    assert {k for k, v in net.items() if v > 0} == {
        ("users", '{"id": 1, "name": "a"}'), ("users", '{"id": 2, "name": "b"}'),
        ("colors", '{"color": "green"}')}


def test_airbyte_subject_offsets_roundtrip(tmp_path, airbyte):
    data = tmp_path / "d.json"
    fakes.write_airbyte_data(data, users=[{"id": 5}])
    subj = airbyte._AirbyteSubject(_source(airbyte, data, ["users"]),
                                   "static", 1.0)
    subj.state = [{"type": "STREAM", "stream": {
        "stream_descriptor": {"name": "users"},
        "stream_state": {"cursor": 5}}}]
    subj2 = airbyte._AirbyteSubject(_source(airbyte, data, ["users"]),
                                    "static", 1.0)
    subj2.seek(subj.get_offsets())
    assert subj2.state == subj.state


# -- the port's decisions on the JAX package's quiet fallbacks ------------------


def test_airbyte_a_state_that_does_not_parse_raises(tmp_path):
    """The JAX subject drops a persisted state that is not JSON and
    re-syncs from the start; the port's raises."""
    from pathway_tpu.io import airbyte as jab
    from pathway_tpu_torch.io import airbyte as tab

    data = tmp_path / "d.json"
    bad = {"airbyte_state": "{not json"}
    subj = jab._AirbyteSubject(_source(jab, data, ["users"]), "static", 1.0)
    subj.seek(bad)
    assert subj.state == []
    subj = tab._AirbyteSubject(_source(tab, data, ["users"]), "static", 1.0)
    with pytest.raises(ValueError):
        subj.seek(bad)


def test_airbyte_plain_text_lines_are_skipped(airbyte):
    """Connectors log plain text; the parser keeps only JSON lines (the
    reference's policy, kept)."""
    code = ("import json; print('starting up'); "
            "print(json.dumps({'type': 'LOG', 'log': {}})); print('done')")
    src = airbyte.ExecutableAirbyteSource([sys.executable, "-S", "-c", code])
    assert src._run([], {}) == [{"type": "LOG", "log": {}}]


def _pushes(subject):
    out: list = []

    class Handle:
        def push(self, row, diff, key=None):
            out.append((key, diff))

        def close(self):
            pass

    subject._run(Handle())
    return out


def test_gdrive_a_failed_download_is_logged_counted_and_retried(caplog):
    """The JAX subject skips a failed download without a word and retries
    it at the next poll; the port's does the same, logs it and counts it
    in ``n_failed_downloads``."""
    from pathway_tpu.io.gdrive import _GDriveSubject as JSubject
    from pathway_tpu_torch.io.gdrive import _GDriveSubject as TSubject

    got = {}
    for name, cls in (("torch", TSubject), ("jax", JSubject)):
        d = drive()
        d.fail_downloads.add("f2")
        subj = cls(d, "root", "static", 0.0, False, None, None)
        with caplog.at_level(logging.WARNING):
            first = _pushes(subj)
        assert sorted(k for k, _d in first) == ["f1", "f3"]
        subj.mode = "static"
        assert _pushes(subj) == [("f2", 1)]  # retried at the next poll
        got[name] = subj
    assert got["torch"].n_failed_downloads == 1
    assert "download failed" in caplog.text


def test_sharepoint_failed_poll_and_download_are_counted_and_retried(caplog):
    from pathway_tpu_torch.io.sharepoint import SharePointSource

    g = fakes.GraphStandIn()
    g.put("f1", "a.txt", b"hello")
    g.put("f2", "b.txt", b"world")
    src = SharePointSource(g, "docs", "streaming", 0.0, None, None, False)
    g.fail_lists = 1
    with caplog.at_level(logging.WARNING):
        assert src.poll() == []
    assert src.n_failed_polls == 1
    g.fail_downloads.add("f2")
    first = src.poll()
    assert [bytes(r[0]) for _t, _k, r, _d in first] == [b"hello"]
    assert src.n_failed_downloads == 1
    retry = src.poll()
    assert [bytes(r[0]) for _t, _k, r, _d in retry] == [b"world"]
    assert src.poll() == [] and g.downloads == {"f1": 1, "f2": 1}
    assert "poll failed" in caplog.text and "download failed" in caplog.text


def test_sharepoint_read_is_gated_on_the_license(monkeypatch):
    from pathway_tpu.internals.config import pathway_config as jconf
    from pathway_tpu.internals.licensing import MissingLicenseError as JMiss
    from pathway_tpu_torch.internals.config import pathway_config as tconf
    from pathway_tpu_torch.internals.licensing import (
        MissingLicenseError as TMiss)

    for pw, conf, err in ((tpw, tconf, TMiss), (jpw, jconf, JMiss)):
        monkeypatch.setattr(conf, "license_key", None)
        with pytest.raises(err):
            pw.io.sharepoint.read(root_path="docs",
                                  _client=fakes.GraphStandIn())
