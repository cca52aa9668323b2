"""Shared harness of the port's persistence tests: one scenario run in
the JAX package and in ``pathway_tpu_torch``, each against its own
storage under ``tmp_path``, and the outcomes compared.

``run(pkg, ...)`` is ``pw.run`` of that package (the port's on the CPU);
``journal_events`` reads a backend's input journals back as a multiset
of (row, diff): a file row without a primary key is keyed by its file's
path, among others (``io/_utils._auto_keys``), and each package reads
its own copy under its own root, so journals compare by value (the keys
of one file are equal in both packages:
``tests/test_torch_io_csv_jsonlines.py``).  ``squash_jsonl`` nets a JSON-lines sink.
"""

from __future__ import annotations

import collections
import json
import pickle

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import named

PKGS = {"jax": (jpw, jpg), "torch": (tpw, tpg)}


def run(pkg: str, **kw) -> None:
    pw, _pg = PKGS[pkg]
    if pkg == "torch":
        kw["device"] = "cpu"
    kw.setdefault("monitoring_level", pw.MonitoringLevel.NONE)
    pw.run(**kw)


def backend(pkg: str, path) -> object:
    return PKGS[pkg][0].persistence.Backend.filesystem(str(path))


def journal_events(be, prefix: str = "input_") -> collections.Counter:
    """Every journaled event of the input streams as (row, diff)."""
    out = collections.Counter()
    for stream in be.list_streams(prefix):
        for rec in be.read_all(stream):
            for _t, _key, row, diff in pickle.loads(rec)[1]:
                out[(named(tuple(row)), diff)] += 1
    return out


def squash_jsonl(path, cols) -> collections.Counter:
    """Net multiset of a JSON-lines sink's rows (the columns ``cols``)."""
    net = collections.Counter()
    if not path.exists():
        return net
    for ln in path.read_text().splitlines():
        if ln:
            e = json.loads(ln)
            net[tuple(e[c] for c in cols)] += e["diff"]
    return +net


def sink_lines(path, cols) -> collections.Counter:
    """Every written line of a JSON-lines sink, as (row, time, diff)."""
    out = collections.Counter()
    for ln in path.read_text().splitlines():
        e = json.loads(ln)
        out[(tuple(e[c] for c in cols), e["time"], e["diff"])] += 1
    return out


def both(scenario, root) -> dict:
    """``scenario(pkg, root / pkg)`` for both packages at once, on two
    threads (the packages share no state: each has its own parse graph,
    runner and sources); each package's result, or the first error."""
    import threading

    out, errors = {}, []

    def one(pkg):
        try:
            out[pkg] = scenario(pkg, root / pkg)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(pkg,)) for pkg in PKGS]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        assert not th.is_alive(), "a scenario did not end"
    if errors:
        raise errors[0]
    return out
