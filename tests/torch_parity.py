"""Shared harness of the port's parity tests: the same program built in
the JAX package and in ``pathway_tpu_torch`` from the same rows, run by
each package's ``run_tables`` (the port's with ``device="cpu"``), and the
captures compared.

``capture`` returns each output's squashed state, or with
``stream=True`` its update stream as a multiset of (key, row, time,
diff): times included, so behaviors (buffers, forgetting) are compared
and not only final states.  ``Error`` and ``Pending`` cells compare by
name (each package has its own singletons).  The port runs on its numpy
tier (both crossovers pinned high) or its device tier (pinned low).
"""

from __future__ import annotations

import collections
import contextlib

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.engine import vectorize as tvec
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.parallel import mapreduce as tmr

PACKAGES = {"jax": (jpw, jrunner, jpg), "torch": (tpw, trunner, tpg)}


@pytest.fixture
def fresh_port(tmp_path, monkeypatch):
    """A cost store in ``tmp_path`` and both parse graphs empty."""
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    tpg.G.clear()
    jpg.G.clear()
    yield
    tpg.G.clear()
    jpg.G.clear()
    costdb.shutdown()
    planner.invalidate_cache()


def named(v):
    name = type(v).__name__
    if name in ("Error", "Pending"):
        return f"<{name}>"
    if isinstance(v, tuple):
        return tuple(named(x) for x in v)
    return v


def _state(cap, stream: bool):
    if stream:
        return collections.Counter(
            (k, named(tuple(r)), t, d) for k, r, t, d in cap.as_list())
    return {k: named(tuple(r)) for k, r in cap.squash().items()}


@contextlib.contextmanager
def tier_pins(monkeypatch, tier: str):
    """The port's vectorized and segment crossovers pinned for ``tier``:
    ``"device"`` low (every batch of 64+ rows reaches the device
    programs), ``"numpy"`` never."""
    with monkeypatch.context() as m:
        low = 64 if tier == "device" else 1 << 40
        m.setattr(tvec, "DEVICE_THRESHOLD", low)
        m.setattr(tmr, "_JIT_MIN_ELEMENTS", low)
        yield


def capture(pkg: str, build, *, stream: bool = False, tier: str = "numpy",
            monkeypatch=None, **run_kw) -> list:
    """``build(pw)`` in package ``pkg``; its output table(s) run through
    ``run_tables``: one state a table."""
    pw, runner, pg = PACKAGES[pkg]
    with contextlib.ExitStack() as stack:
        if pkg == "torch":
            run_kw["device"] = "cpu"
            if monkeypatch is not None:
                stack.enter_context(tier_pins(monkeypatch, tier))
        pg.G.clear()
        try:
            out = build(pw)
            outs = out if isinstance(out, tuple) else (out,)
            caps = runner.run_tables(*outs, **run_kw)
        finally:
            pg.G.clear()
    return [_state(c, stream) for c in caps]


def equal_to_jax(build, monkeypatch=None, *, stream: bool = False,
                 tiers=("numpy",)) -> list:
    """The port's captures on each tier equal the JAX package's; returns
    the JAX package's."""
    expected = capture("jax", build, stream=stream)
    for tier in tiers:
        got = capture("torch", build, stream=stream, tier=tier,
                      monkeypatch=monkeypatch)
        assert got == expected, tier
    return expected
