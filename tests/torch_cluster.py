"""Multi-process test plumbing of the port's cluster: the port's copies of
``tests/utils.py``'s ``fabric_port_block``, ``fabric_mesh_flake``,
``spawn_cluster``, ``hard_alarm`` and ``bare_fabric``.

``spawn_cluster`` runs a script under ``python -m pathway_tpu_torch
spawn`` (the scripts call ``pw.run(device="cpu")``), retrying a
mesh-formation flake on a fresh port block and surfacing any other
failure.  Ports come from the fixed 21000-28000 range with a
bindability check: a bind-to-0 anchor can race the host's own outbound
connections.  Each spawned run points ``PW_COSTDB_PATH`` at a file
beside its script, so no run writes the user's cost store.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def fabric_port_block(n: int = 4) -> int:
    """Bindable anchor from the fixed 21000-28000 range; the fabric uses
    anchor..anchor+nprocs-1."""
    import random
    import socket

    rng = random.Random()
    for _ in range(64):
        base = 21000 + rng.randrange(0, 6800)
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                s.close()
            return base
        except OSError:
            continue
    raise RuntimeError("no bindable port block in 21000-28000")


def fabric_mesh_flake(stderr: str) -> bool:
    """True when a failed spawn's stderr shows a mesh-formation flake
    (retry with a fresh port block) rather than a real failure."""
    return ("cannot reach peer" in stderr
            or "peers connected" in stderr
            or "cannot bind fabric port" in stderr)


def spawn_env(script, extra_env: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.setdefault("PW_FABRIC_CONNECT_TIMEOUT_S", "8")  # cheap mesh retries
    env.setdefault("PW_COSTDB_PATH", str(Path(script).parent / "costdb.json"))
    env.pop("PATHWAY_THREADS", None)
    env.pop("PATHWAY_PROCESSES", None)
    env.pop("PATHWAY_PROCESS_ID", None)
    if extra_env:
        env.update(extra_env)
    return env


def spawn_cluster(script, processes: int, threads: int = 1,
                  timeout: int = 150, extra_env: dict | None = None,
                  attempts: int = 4, restart: int = 0, check: bool = True,
                  extra_args: tuple = (), bare: bool = False):
    """Run ``script`` under the port's supervisor and return the final
    ``CompletedProcess``; a mesh-formation flake retries on a fresh port
    block, a real failure is raised (``check``) or returned for the
    caller to assert on.  ``bare``: the command names the script alone
    (``spawn -n 2 app.py``), not ``-- python app.py``."""
    env = spawn_env(script, extra_env)
    res = None
    for _attempt in range(attempts):
        cmd = [
            sys.executable, "-m", "pathway_tpu_torch", "spawn",
            "--threads", str(threads), "--processes", str(processes),
            "--first-port", str(fabric_port_block(processes)),
            *extra_args,
        ]
        if restart:
            cmd += ["--restart", str(restart)]
        cmd += [str(script)] if bare else ["--", sys.executable, str(script)]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode == 0:
            return res
        if not fabric_mesh_flake(res.stderr):
            break  # a real failure: surface it, never retry it away
    if check:
        raise AssertionError(
            f"spawn failed (rc={res.returncode}):\n"
            f"stdout={res.stdout[-1500:]}\nstderr={res.stderr[-3000:]}"
        )
    return res


class hard_alarm:
    """SIGALRM-based hard timeout (context manager): a wedged
    multi-process rendezvous fails the test, never the whole run."""

    def __init__(self, seconds: int = 180):
        self.seconds = int(seconds)
        self._old = None

    def __enter__(self):
        import signal

        def boom(_sig, _frm):
            raise TimeoutError(
                f"test exceeded its {self.seconds}s hard timeout")

        self._old = signal.signal(signal.SIGALRM, boom)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        import signal

        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def bare_fabric(pid: int = 0, peers=(1,)):
    """A port ``Fabric`` with no sockets or threads — just the shared
    state the counted-mark and liveness waits read."""
    import threading
    from collections import defaultdict

    from pathway_tpu_torch import obs
    from pathway_tpu_torch.parallel.comm import Fabric

    f = Fabric.__new__(Fabric)
    f.pid = pid
    f.peers = list(peers)
    f._cond = threading.Condition()
    f._marks = defaultdict(dict)
    f._announced = {}
    f._recv_pos_counts = defaultdict(int)
    f._eot = set()
    f._done_peers = set()
    f._dead = None
    f._dead_peer = None
    f._poisoned = None
    f._closed = False
    # liveness defaults: heartbeats off (no threads here), generous wait
    f._hb_interval = 0.0
    f._peer_timeout_s = 0.0
    f._wait_timeout_s = 120.0
    f._last_seen = {p: 0.0 for p in peers}
    f.stats = {"wait_marks_s": 0.0, "wait_eot_s": 0.0}
    for p in peers:
        f.stats[f"wait_marks_s_p{p}"] = 0.0
    f._obs_ctx = (obs.new_trace_id(), 0)
    return f


def squash_jsonl(path, key_cols) -> dict:
    """Net multiset of ``key_cols`` tuples of a sink's jsonlines update
    stream (rows whose diffs cancel are dropped)."""
    import json

    net: dict = {}
    for line in Path(path).read_text().splitlines():
        if not line:
            continue
        obj = json.loads(line)
        key = tuple(obj[c] for c in key_cols)
        net[key] = net.get(key, 0) + obj["diff"]
    return {k: m for k, m in net.items() if m}


def run_in_process(script, package: str = "jax", threads: int = 1) -> None:
    """Run a spawn script's program in this interpreter: with the JAX
    package (the import swapped) as the single-process reference, or
    with the port on ``threads`` local shards."""
    import contextlib

    src = Path(script).read_text()
    if package == "jax":
        from pathway_tpu.internals import parse_graph as pg

        src = src.replace("pathway_tpu_torch", "pathway_tpu")
        patch = contextlib.nullcontext()
    else:
        from pathway_tpu_torch.internals import parse_graph as pg
        from pathway_tpu_torch.internals.config import pathway_config

        @contextlib.contextmanager
        def patch():
            old = pathway_config.threads
            pathway_config.threads = threads
            try:
                yield
            finally:
                pathway_config.threads = old

        patch = patch()
    pg.G.clear()
    try:
        with patch:
            # dont_inherit: this module's `from __future__ import
            # annotations` would turn the script's schema types to strings
            exec(compile(src, str(script), "exec", dont_inherit=True),
                 {"__name__": "__main__"})
    finally:
        pg.G.clear()
