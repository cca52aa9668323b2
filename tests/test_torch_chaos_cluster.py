"""Failure domains of the port's cluster: ``tests/test_chaos_cluster.py``'s
cases against the port.

  - the chaos matrix — {delay, drop, close, kill} x {ctl lane, data lane}
    injected into a real 2-process spawn through ``PW_FAULT``; every cell
    ends in either byte-identical output or a clean typed abort
    (``PeerLostError`` / ``ClusterAborted`` / the ctl deadline) within the
    wait deadline, never a hang (SIGALRM-bounded).  The identity oracle is
    the port's 1-process x 2-thread walk in this interpreter, whose
    squashed sink equals the JAX package's single-process run;
  - kill-and-recover — a worker killed mid-ingest, mid-exchange and after
    a journal commit under ``spawn --restart``; the journal resumes the
    mesh and the squashed sink equals the JAX package's (exactly once);
  - elastic restart: a crash relaunch under ``PW_ELASTIC_PLAN=1`` moves
    to the process count the planner's seeded epochs favour;
  - units of the fault registry (spec parsing, nth counting, the pid
    filter, stamp-dir once semantics, the obs event) and of the fabric's
    liveness (``PeerLostError`` from a silent peer or a wait deadline,
    ``ClusterAborted`` from a poison frame).
"""

import os
import textwrap
import threading
import time
from pathlib import Path

import pytest

from .torch_cluster import (
    bare_fabric,
    fabric_mesh_flake,
    fabric_port_block,
    hard_alarm,
    run_in_process,
    spawn_cluster,
    squash_jsonl,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


@pytest.fixture(autouse=True)
def _hard_timeout():
    with hard_alarm(150):
        yield


@pytest.fixture(autouse=True)
def _clean_faults():
    from pathway_tpu_torch import faults

    faults.clear()
    yield
    faults.clear()


# tight deadlines so a typed abort lands in seconds, not the default 120 s
_CHAOS_ENV = {
    "PW_FABRIC_WAIT_TIMEOUT_S": "4",
    "PW_FABRIC_HEARTBEAT_S": "0.5",
    "PW_FABRIC_PEER_TIMEOUT_S": "3",
}

# stderr markers of a clean typed abort (not a hang, a pickle crash or a
# deadlock): the typed error names, the poison path, the deadlined ctl
# recv, or the injected kill itself
_TYPED_ABORT_MARKERS = (
    "PeerLostError",
    "ClusterAborted",
    "cluster aborted",
    "ctl recv timeout",
    "fault.injected kill",
)


def _wordcount_script(tmp: Path, out: Path, inp: Path) -> Path:
    # row keys derive from (content, source path): every byte-compared run
    # reads the same input file
    if not inp.exists():
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
        lines = [" ".join(words[(i + j) % len(words)] for j in range(3))
                 for i in range(240)]
        inp.write_text("line\n" + "\n".join(f'"{l}"' for l in lines) + "\n")
    script = tmp / f"app_{out.stem}.py"
    script.write_text(textwrap.dedent(f"""
        import pathway_tpu_torch as pw

        class S(pw.Schema):
            line: str

        t = pw.io.csv.read({str(inp)!r}, schema=S, mode="static")
        words = t.select(word=pw.apply(lambda s: s.split(), t.line)).flatten(
            pw.this.word
        )
        counts = words.groupby(words.word).reduce(
            words.word, count=pw.reducers.count()
        )
        pw.io.jsonlines.write(counts, {str(out)!r})
        pw.run(device="cpu")
    """))
    return script


@pytest.fixture(scope="module")
def serial_baseline(tmp_path_factory):
    """The port's 1-process x 2-thread walk's bytes (the identity oracle),
    held against the JAX package's single-process run."""
    tmp = tmp_path_factory.mktemp("chaos_baseline")
    inp = tmp / "input.csv"
    out = tmp / "serial.jsonl"
    run_in_process(_wordcount_script(tmp, out, inp), "torch", threads=2)
    ref = tmp / "ref.jsonl"
    run_in_process(_wordcount_script(tmp, ref, inp), "jax")
    assert squash_jsonl(out, ("word", "count")) == squash_jsonl(
        ref, ("word", "count"))
    data = out.read_bytes()
    assert data
    return tmp, data


@pytest.mark.parametrize("action", ["delay", "drop", "close", "kill"])
@pytest.mark.parametrize("lane", ["ctl", "data"])
def test_chaos_matrix_cell(serial_baseline, tmp_path, action, lane):
    """Every {action} x {lane} cell ends in byte-identical output or a
    clean typed abort within the deadline — never a hang."""
    tmp, serial = serial_baseline
    out = tmp_path / f"cell_{action}_{lane}.jsonl"
    script = _wordcount_script(tmp_path, out, tmp / "input.csv")
    arg_ms = 30 if action == "delay" else 0
    nth = 0 if action == "delay" else 2  # delay every frame; fail the 2nd
    env = dict(_CHAOS_ENV)
    env["PW_FAULT"] = f"fabric.send.{lane}:{action}:{nth}:{arg_ms}:1"
    t0 = time.monotonic()
    res = spawn_cluster(script, processes=2, threads=1, timeout=90,
                        extra_env=env, check=False)
    elapsed = time.monotonic() - t0
    if action == "delay":
        # a pure delay must not change one byte of output
        assert res.returncode == 0, res.stderr[-3000:]
        assert out.read_bytes() == serial
        return
    # self-healing is legal (the dropped frame was a heartbeat, or a later
    # coalesced mark re-announced the counts): identical output
    if res.returncode == 0:
        assert out.read_bytes() == serial
        return
    # otherwise a clean typed abort within the deadline budget; a
    # mesh-formation flake means the chaos path never ran: fail it
    blob = res.stderr + res.stdout
    assert not fabric_mesh_flake(res.stderr), (
        f"mesh never formed, cell not exercised:\n{res.stderr[-2000:]}")
    assert any(m in blob for m in _TYPED_ABORT_MARKERS), blob[-3000:]
    assert elapsed < 80, f"cell took {elapsed:.0f}s — not a bounded abort"


# -- kill-and-recover ---------------------------------------------------------

_WORDS = ["red", "green", "blue", "cyan", "plum"]


def _streaming_app(tmp_path: Path, label: str):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    for f in range(4):
        (data / f"part{f:02d}.txt").write_text(
            "\n".join(_WORDS[(f + i) % len(_WORDS)] for i in range(20))
            + "\n")

    def make(out: Path, pdir: Path) -> Path:
        script = tmp_path / f"app_{out.stem}.py"
        script.write_text(textwrap.dedent(f"""
            import pathway_tpu_torch as pw

            t = pw.io.plaintext.read({str(data)!r} + "/*.txt",
                                     mode="streaming")
            counts = t.groupby(t.data).reduce(
                word=t.data, count=pw.reducers.count()
            )
            pw.io.jsonlines.write(counts, {str(out)!r})
            pw.run(persistence_config=pw.persistence.Config(
                pw.persistence.Backend.filesystem({str(pdir)!r})),
                idle_stop_s=1.5, device="cpu")
        """))
        return script

    ref = tmp_path / f"ref_{label}.jsonl"
    run_in_process(make(ref, tmp_path / f"jax_store_{label}"), "jax")
    want = squash_jsonl(ref, ("word", "count"))
    expect = {}
    for f in range(4):
        for i in range(20):
            w = _WORDS[(f + i) % len(_WORDS)]
            expect[w] = expect.get(w, 0) + 1
    assert {w: c for (w, c) in want} == expect
    return make, want


@pytest.mark.parametrize("point,nth,label", [
    ("persistence.append", 1, "mid_ingest"),
    ("fabric.mark", 3, "mid_exchange"),
    ("persistence.commit", 1, "post_commit"),
])
def test_kill_and_recover_exactly_once_2proc(tmp_path, point, nth, label):
    """A worker killed at three points (before its journal append, at an
    exchange mark, after a journal commit) under the restart supervisor:
    the relaunched mesh resumes from the journal and the squashed sink
    equals the JAX package's uninterrupted run."""
    make, want = _streaming_app(tmp_path, label)
    out = tmp_path / f"out_{label}.jsonl"
    stamp = tmp_path / f"stamps_{label}"
    env = dict(_CHAOS_ENV)
    env["PW_FAULT"] = f"{point}:kill:{nth}:0:1"
    env["PW_FAULT_STAMP_DIR"] = str(stamp)
    res = spawn_cluster(make(out, tmp_path / f"pstore_{label}"),
                        processes=2, timeout=150, extra_env=env, restart=2)
    # the fault fired, once
    assert len(list(stamp.glob("*.fired"))) == 1, (
        f"{point} fault never fired — the kill point was not exercised")
    assert "fault.injected kill" in res.stderr
    assert squash_jsonl(out, ("word", "count")) == want, (
        f"exactly-once violated at {label}")


def test_elastic_restart_replans_process_count_exactly_once(tmp_path):
    """A crash relaunch under PW_ELASTIC_PLAN=1 consults the planner's
    measured epochs and relaunches at 1 process (seeded faster than 2);
    the 2-process journal re-partitions under the new membership and the
    squashed sink stays exactly-once."""
    import json

    from pathway_tpu_torch.obs.costdb import backend_fingerprint

    make, want = _streaming_app(tmp_path, "elastic")
    # the fingerprint the spawned supervisor computes: same host, no card
    fp = backend_fingerprint()
    dbpath = tmp_path / "costdb.json"
    entries = {}
    for bucket, ms in (("p1", 900.0), ("p2", 5000.0)):
        entries[f"pw.cluster.epoch|{bucket}|{fp}"] = {
            "program": "pw.cluster.epoch", "bucket": bucket,
            "fingerprint": fp, "n": 3, "ms_best": ms, "ms_avg": ms,
            "ms_last": ms,
        }
    dbpath.write_text(json.dumps({"version": 1, "entries": entries}))
    out = tmp_path / "out_elastic.jsonl"
    stamp = tmp_path / "stamps_elastic"
    env = dict(_CHAOS_ENV)
    env["PW_FAULT"] = "persistence.commit:kill:1:0:1"
    env["PW_FAULT_STAMP_DIR"] = str(stamp)
    env["PW_COSTDB_PATH"] = str(dbpath)
    env["PW_ELASTIC_PLAN"] = "1"
    res = spawn_cluster(make(out, tmp_path / "pstore_elastic"), processes=2,
                        timeout=110, extra_env=env, restart=2)
    assert list(stamp.glob("*.fired")), (
        "kill fault never fired — the elastic path was not exercised")
    assert "elastic membership: 2 -> 1" in res.stderr, res.stderr[-3000:]
    assert squash_jsonl(out, ("word", "count")) == want


# -- the fault registry --------------------------------------------------------


def test_fault_spec_parsing_and_nth_counting():
    from pathway_tpu_torch import faults

    spec = faults.parse_spec("fabric.send.data:drop:3:0:1")
    assert (spec.point, spec.action, spec.nth, spec.pid) == (
        "fabric.send.data", "drop", 3, 1)
    with pytest.raises(ValueError):
        faults.parse_spec("no-action-here")
    with pytest.raises(ValueError):
        faults.parse_spec("x:explode")

    faults.install("p.q", "drop", nth=3)
    assert faults.fire("p.q") is None
    assert faults.fire("p.q") is None
    assert faults.fire("p.q") == "drop"
    assert faults.fire("p.q") is None  # one-shot once nth passed


def test_fault_env_arming_and_pid_filter(monkeypatch):
    from pathway_tpu_torch import faults

    monkeypatch.setenv("PW_FAULT", "a.b:drop:1:0:7")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "3")
    faults.clear()  # re-read env
    assert faults.fire("a.b") is None  # wrong pid: never fires
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "7")
    faults.clear()
    assert faults.fire("a.b") == "drop"


def test_fault_raise_and_obs_event():
    from pathway_tpu_torch import faults, obs

    faults.install("engine.dispatch.chain", "raise", nth=1)
    with pytest.raises(faults.InjectedFault):
        faults.fire("engine.dispatch.chain")
    names = [s.name for s in obs.recorder().snapshot()]
    assert "fault.injected" in names


def test_fault_stamp_dir_once_semantics(tmp_path, monkeypatch):
    """The stamp disarms a spec across process incarnations — the
    supervisor's restart must not re-kill forever."""
    from pathway_tpu_torch import faults

    monkeypatch.setenv("PW_FAULT_STAMP_DIR", str(tmp_path))
    faults.install("x.y", "drop", nth=1)
    assert faults.fire("x.y") == "drop"
    assert list(tmp_path.glob("*.fired"))
    # a "new process": the same spec re-armed, but the stamp exists
    faults.clear()
    faults.install("x.y", "drop", nth=1)
    assert faults.fire("x.y") is None


# -- the fabric's liveness -----------------------------------------------------


def test_wait_marks_deadline_raises_typed_peer_lost():
    """A peer whose frames never arrive turns the wait deadline into a
    typed PeerLostError naming the peer and the barrier."""
    from pathway_tpu_torch.parallel.comm import PeerLostError

    f = bare_fabric(pid=0, peers=(1,))
    with pytest.raises(PeerLostError) as ei:
        f.wait_marks(4, 2, timeout_s=0.3)
    assert ei.value.peer == 1
    assert "marks(t=4, pos=2)" in ei.value.waiting_on


def test_wait_marks_heartbeat_silence_raises_before_deadline():
    """With heartbeats on, a peer silent past PW_FABRIC_PEER_TIMEOUT_S
    aborts the wait long before the barrier deadline."""
    from pathway_tpu_torch.parallel.comm import PeerLostError

    f = bare_fabric(pid=0, peers=(1,))
    f._hb_interval = 0.1
    f._peer_timeout_s = 0.25
    f._last_seen[1] = time.monotonic() - 1.0  # long silent
    t0 = time.monotonic()
    with pytest.raises(PeerLostError) as ei:
        f.wait_marks(7, 1, timeout_s=30.0)
    assert time.monotonic() - t0 < 2.0
    assert "no frames for" in str(ei.value)


def test_poison_frame_aborts_blocking_waits():
    """A poison landing mid-wait raises ClusterAborted at once."""
    from pathway_tpu_torch.parallel.comm import ClusterAborted

    f = bare_fabric(pid=0, peers=(1,))

    def poison_late():
        time.sleep(0.1)
        with f._cond:
            f._poisoned = "pid 1: InjectedFault: boom"
            f._cond.notify_all()

    th = threading.Thread(target=poison_late)
    th.start()
    t0 = time.monotonic()
    with pytest.raises(ClusterAborted, match="boom"):
        f.wait_marks(3, 1, timeout_s=30.0)
    th.join()
    assert time.monotonic() - t0 < 2.0


def test_recv_ctl_surfaces_poison_and_peer_loss():
    import queue

    from pathway_tpu_torch.parallel.comm import ClusterAborted, PeerLostError

    f = bare_fabric(pid=1, peers=(0,))
    f._ctl = queue.Queue()
    f._ctl.put(("__poison__", "pid 0: dead"))
    with pytest.raises(ClusterAborted, match="dead"):
        f.recv_ctl(timeout_s=1.0)
    f._ctl.put(("__peer_lost__", 0))
    with pytest.raises(PeerLostError) as ei:
        f.recv_ctl(timeout_s=1.0)
    assert ei.value.peer == 0


def test_peer_death_detected_over_real_sockets(monkeypatch):
    """Over a real loopback pair, closing one side's sockets abruptly
    surfaces a typed PeerLostError on the survivor's next blocking
    wait."""
    from pathway_tpu_torch.parallel.comm import Fabric, PeerLostError

    monkeypatch.setenv("PATHWAY_FABRIC_SECRET", "test-run-secret")
    for attempt in range(4):
        port = fabric_port_block(2)
        fabrics: dict = {}
        errs: dict = {}

        def mk(pid):
            try:
                fabrics[pid] = Fabric(pid, 2, port, connect_timeout_s=8.0)
            except Exception as exc:  # noqa: BLE001
                errs[pid] = exc

        ts = [threading.Thread(target=mk, args=(p,)) for p in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        if not errs:
            break
        if attempt == 3:
            raise AssertionError(f"mesh formation failed: {errs}")
    f0, f1 = fabrics[0], fabrics[1]
    # pid 1 dies abruptly (sockets closed without the shutdown barrier —
    # what an os._exit looks like from outside)
    f1.close()
    with pytest.raises(PeerLostError) as ei:
        f0.wait_marks(2, 1, timeout_s=10.0)
    assert ei.value.peer == 1
    f0.close()
