"""Input synchronization groups of ``pathway_tpu_torch`` held to the JAX
package's (``tests/test_synchronization.py``): the group's algorithm
gives the same answers step for step, two sources with skewed timelines
advance within ``max_difference`` of each other end to end in both
packages with the same rows delivered, and the port's groups live with
its parse graph, so ``G.clear()`` drops them (the conftest clears only
the JAX package's module-level list; the JAX tests below clear it too).
"""

import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.io import _synchronization as jsync
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.io import _synchronization as tsync

PKGS = {"jax": (jpw, jpg, jsync), "torch": (tpw, tpg, tsync)}


@pytest.fixture(autouse=True)
def _no_groups_left():
    jsync.clear_groups()
    tpg.G.clear()
    yield
    jsync.clear_groups()
    tpg.G.clear()
    jpg.G.clear()


# (call, source, value) steps of test_synchronization.py's bounds test
STEPS = [("can_send", "a", 0), ("can_send", "b", 3), ("can_send", "a", 0),
         ("report", "a", 0), ("can_send", "b", 3), ("report", "b", 3),
         ("can_send", "a", 13), ("report", "a", 13), ("can_send", "a", 14),
         ("report", "b", 9), ("can_send", "a", 14), ("report", "a", 14),
         ("set_idle", "b", None), ("can_send", "a", 1000)]


def _replay(mod, steps, max_difference=10):
    g = mod.SynchronizationGroup(max_difference=max_difference)
    ids = {"a": g.register_source(), "b": g.register_source()}
    out = []
    for call, src, value in steps:
        if call == "set_idle":
            out.append(g.set_idle(ids[src]))
        else:
            out.append(getattr(g, call)(ids[src], value))
    return out


def test_group_algorithm_bounds():
    got = _replay(tsync, STEPS)
    assert got == _replay(jsync, STEPS)
    can = [r for (call, _s, _v), r in zip(STEPS, got) if call == "can_send"]
    assert can == [False, False, True, True, True, False, True, True]


def test_group_algorithm_matches_on_random_schedules():
    """Seeded random schedules of three-source groups: every answer of the
    port's group equals the JAX package's."""
    import numpy as np

    rng = np.random.default_rng(7)
    for _ in range(20):
        groups = [mod.SynchronizationGroup(max_difference=int(
            rng.integers(1, 20))) for mod in (jsync, tsync)]
        groups[1].max_difference = groups[0].max_difference
        ids = [[g.register_source() for _ in range(3)] for g in groups]
        clocks = [0, 0, 0]
        for _step in range(60):
            s = int(rng.integers(0, 3))
            op = rng.random()
            if op < 0.1:
                answers = [g.set_idle(i[s]) for g, i in zip(groups, ids)]
            else:
                value = clocks[s] + int(rng.integers(0, 8))
                answers = [g.can_send(i[s], value)
                           for g, i in zip(groups, ids)]
                if answers[0] and op < 0.8:
                    clocks[s] = value
                    for g, i in zip(groups, ids):
                        g.report(i[s], value)
            assert answers[0] == answers[1]


class _Feeder:
    def __init__(self, name, times, delay):
        self.name, self.times, self.delay = name, times, delay

    def _run(self, handle):
        for t in self.times:
            handle.push((t, self.name), 1, None)
            time.sleep(self.delay)
        handle.close()


def _skewed_run(pkg: str) -> tuple[list, list, dict]:
    """test_synchronization.py's end-to-end scenario in ``pkg``: a fast
    source racing to 100 and a slow one crawling to 40, grouped at
    ``max_difference=20``; the delivered rows, the violations of the
    bound while the slow source runs, and each source's furthest time."""
    pw, pg, _sync = PKGS[pkg]
    if pkg == "jax":
        from pathway_tpu.internals.datasource import SubjectDataSource
        from pathway_tpu.io._utils import make_input_table
    else:
        from pathway_tpu_torch.internals.datasource import SubjectDataSource
        from pathway_tpu_torch.io._utils import make_input_table

    class S(pw.Schema):
        t: int
        src: str

    pg.G.clear()
    tf = make_input_table(S, SubjectDataSource(
        _Feeder("fast", list(range(0, 101, 20)), 0.01), ["t", "src"], None),
        name="fast")
    ts = make_input_table(S, SubjectDataSource(
        _Feeder("slow", list(range(0, 41, 10)), 0.15), ["t", "src"], None),
        name="slow")
    pw.io.register_input_synchronization_group(tf.t, ts.t, max_difference=20)
    seen, violations = [], []
    seen_max = {"fast": -1, "slow": -1}
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            seen.append((row["src"], row["t"]))
            seen_max[row["src"]] = max(seen_max[row["src"]], row["t"])
            # the bound of tests/test_synchronization.py:38
            if (row["src"] == "fast" and seen_max["slow"] < 40
                    and row["t"] > seen_max["slow"] + 20):
                violations.append((row["t"], seen_max["slow"]))

    pw.io.subscribe(tf.concat_reindex(ts), on_change=on_change)
    kw = dict(timeout_s=5.0, autocommit_duration_ms=20,
              monitoring_level=pw.MonitoringLevel.NONE)
    if pkg == "torch":
        kw["device"] = "cpu"
    try:
        pw.run(**kw)
    finally:
        pg.G.clear()
        if pkg == "jax":
            jsync.clear_groups()
    return seen, violations, seen_max


def test_sources_advance_together_e2e():
    got = _skewed_run("torch")
    want = _skewed_run("jax")
    for seen, violations, seen_max in (got, want):
        assert not violations, violations
        assert seen_max == {"fast": 100, "slow": 40}
    assert sorted(got[0]) == sorted(want[0])


def test_the_port_keeps_its_groups_with_its_parse_graph():
    pw = tpw
    t = pw.debug.table_from_markdown("t | u\n1 | 2")
    pw.io.register_input_synchronization_group(t.t, t.u, max_difference=3)
    assert len(tpg.G.sync_groups) == 1
    assert jsync._groups == []  # nothing left in the JAX package's list
    tpg.G.clear()
    assert tpg.G.sync_groups == []
    with pytest.raises(ValueError, match="at least two"):
        pw.io.register_input_synchronization_group(t.t, max_difference=3)


def test_a_group_over_a_derived_table_raises_in_both():
    for pkg in ("jax", "torch"):
        pw, pg, _sync = PKGS[pkg]
        pg.G.clear()
        t = pw.debug.table_from_markdown("t | u\n1 | 2")
        d = t.select(t.t, u=t.u + 1)
        pw.io.register_input_synchronization_group(t.t, d.u, max_difference=3)
        pw.io.subscribe(d, on_change=lambda **kw: None)
        kw = dict(monitoring_level=pw.MonitoringLevel.NONE)
        if pkg == "torch":
            kw["device"] = "cpu"
        with pytest.raises(ValueError, match="input"):
            pw.run(**kw)
        pg.G.clear()
        jsync.clear_groups()


@pytest.mark.parametrize("end", ["stop", "crash"])
def test_a_restart_re_offers_what_the_gate_parked(tmp_path, end):
    """Two Kafka topics grouped under persistence: run 1 ends (cleanly, or
    by a fault after its third journal commit) while the fast topic's gate
    parks the events past the slow topic's bound, though the consumer has
    read them.  Run 2, after the slow topic's remaining messages arrive,
    gets every message of both topics exactly once: the parked events
    travel in the journal with the offsets that already cover them."""
    import json

    import chip_smoke
    from pathway_tpu_torch import faults

    pw = tpw
    log = chip_smoke.KafkaLog()
    for t in range(60):
        log.append("fast", json.dumps({"t": t}).encode())
    for t in range(10):
        log.append("slow", json.dumps({"t": t}).encode())
    store = str(tmp_path / "journal")

    def run(expect_fault: bool) -> list:
        tpg.G.clear()
        seen = []

        class S(pw.Schema):
            t: int

        tables = {name: pw.io.kafka.read(
            {"_consumer": log.consumer(name)}, name, schema=S)
            for name in ("fast", "slow")}
        pw.io.register_input_synchronization_group(
            tables["fast"].t, tables["slow"].t, max_difference=5)
        for name, table in tables.items():
            pw.io.subscribe(table, on_change=lambda key, row, time,
                            is_addition, name=name: seen.append(
                                (name, row["t"], is_addition)))
        kw = dict(timeout_s=10.0, idle_stop_s=0.5, autocommit_duration_ms=20,
                  device="cpu", persistence_config=pw.persistence.Config(
                      pw.persistence.Backend.filesystem(store)))
        try:
            if expect_fault:
                with pytest.raises(faults.InjectedFault):
                    pw.run(**kw)
            else:
                pw.run(**kw)
        finally:
            faults.clear()
            tpg.G.clear()
        return seen

    if end == "crash":
        faults.install("persistence.commit", "raise", nth=3)
    first = run(expect_fault=end == "crash")
    assert max((t for name, t, _add in first if name == "fast"),
               default=0) <= 14
    for t in range(10, 60):
        log.append("slow", json.dumps({"t": t}).encode())
    second = run(expect_fault=False)
    assert all(add for _name, _t, add in second)
    for name in ("fast", "slow"):
        assert sorted(t for n, t, _add in second if n == name) == list(
            range(60)), name
