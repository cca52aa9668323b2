"""Cost-model-driven planner: each knob chosen from recorded costs (the
port of ``pathway_tpu/obs/planner.py``).

A cost model — the *measured* per-program store in
:mod:`~pathway_tpu_torch.obs.costdb` plus the *computed*
:class:`~pathway_tpu_torch.obs.memory.HbmPlan` ledger — arbitrates each
configuration knob, and each choice is recorded with its inputs and
rationale (:meth:`Plan.render` prints the table).

Knobs:

  - the jit/numpy crossover of the data plane's dual-path primitives
    (``pw.reduce.segment_sum``, ``pw.map.vecplan``), read from recorded
    ``<program>.jit`` / ``<program>.numpy`` rows.  The port has no data
    plane yet, so on a host that recorded none these report their
    documented ``default`` (or an ``env`` pin); the measuring half
    (``calibrate_mapreduce``) waits for the data plane;
  - cluster process count (:func:`choose_process_count`);
  - tp/dp degree (:func:`choose_tp`, counting ``torch.cuda
    .device_count()``);
  - the engine shapes (delegating to ``memory.choose_engine_config``).

Decision sources, in the order a reader should trust them:

  ``env``      an explicit operator override (always wins; reported),
  ``costdb``   a measured cost recorded on THIS backend fingerprint,
  ``hbm_plan`` a computed memory-ledger fit (provable, not measured),
  ``default``  the documented fallback on a fresh host (reported as
               such — a fresh host is visibly untuned).

Unlike the reference, nothing here swallows an error: a store that
cannot be read, or a budget that cannot be resolved, raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from ..parallel.mesh import legal_tp_values

# sentinel crossover meaning "the jit path never wins on this backend"
NEVER = 1 << 62


@dataclass
class Decision:
    """One planned knob: what was chosen, from which evidence, and why."""

    knob: str
    value: Any
    source: str  # "env" | "costdb" | "hbm_plan" | "measured" | "default"
    why: str
    candidates: dict | None = None

    def as_dict(self) -> dict:
        d = {"knob": self.knob, "value": self.value, "source": self.source,
             "why": self.why}
        if self.candidates:
            d["candidates"] = self.candidates
        return d


@dataclass
class Plan:
    """The full set of planned knobs for one host/backend."""

    decisions: list[Decision] = field(default_factory=list)
    fingerprint: str = ""

    def add(self, d: Decision) -> Decision:
        self.decisions.append(d)
        return d

    def get(self, knob: str) -> Decision | None:
        for d in self.decisions:
            if d.knob == knob:
                return d
        return None

    def value(self, knob: str, default: Any = None) -> Any:
        d = self.get(knob)
        return default if d is None else d.value

    def as_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "decisions": [d.as_dict() for d in self.decisions],
        }

    def render(self) -> str:
        """The ``pathway-tpu plan`` table: knob / value / source / why."""
        cols = ("knob", "value", "source", "why")
        rows = [
            (d.knob, "never" if d.value == NEVER else str(d.value),
             d.source, d.why)
            for d in self.decisions
        ]
        widths = [
            max(len(cols[i]), *(len(r[i]) for r in rows)) if rows
            else len(cols[i])
            for i in range(3)
        ]
        lines = [
            "  ".join(c.ljust(widths[i]) for i, c in enumerate(cols[:3]))
            + "  why",
            "  ".join("-" * w for w in widths) + "  ---",
        ]
        for r in rows:
            lines.append(
                "  ".join(r[i].ljust(widths[i]) for i in range(3))
                + "  " + r[3]
            )
        lines.append("")
        lines.append(f"backend: {self.fingerprint}")
        return "\n".join(lines)


def _db(db=None):
    if db is not None:
        return db
    from . import costdb

    return costdb.default_db()


# -- jit/numpy crossover ----------------------------------------------------

def _bucket_sizes(store, program: str, prefix: str = "n") -> dict[int, float]:
    """bucket "<prefix><int>" -> ms_best for one program's entries under
    the store's OWN backend fingerprint (a cost measured on another
    machine must not steer planning on this one)."""
    out: dict[int, float] = {}
    for e in store.entries(program):
        if e.get("fingerprint") != store.fingerprint:
            continue
        b = e.get("bucket") or ""
        ms = e.get("ms_best")
        if ms is None or not b.startswith(prefix):
            continue
        try:
            out[int(b[len(prefix):])] = float(ms)
        except ValueError:
            continue
    return out


def jit_crossover(program: str, *, default: int = 65536,
                  db=None) -> Decision:
    """The element count above which ``<program>``'s jitted path beats its
    numpy twin, from recorded ``<program>.jit`` / ``<program>.numpy``
    costdb rows at matching ``n<size>`` buckets (both sides record their
    wall time per call; ``ms_best`` converges to the warm cost, washing
    out compiles).  The rule: the smallest measured size where jit wins
    and KEEPS winning at every larger common bucket — a single lucky
    window must not drag the crossover down.  :data:`NEVER` when jit
    never wins; the documented ``default`` when no common bucket has
    been measured (a fresh host is visibly untuned, not mistuned)."""
    store = _db(db)
    jit = _bucket_sizes(store, f"{program}.jit")
    npy = _bucket_sizes(store, f"{program}.numpy")
    common = sorted(set(jit) & set(npy))
    if not common:
        return Decision(
            knob=f"{program}.jit_min", value=default, source="default",
            why="no measured jit/numpy pair in costdb "
                f"(calibrate the dual path on this host, e.g. "
                "`pathway-tpu plan --calibrate`); default {default}",
        )
    cand = {f"n{n}": {"jit_ms": jit[n], "numpy_ms": npy[n]} for n in common}
    crossover: int | None = None
    # walk from the largest bucket down: the crossover is the smallest
    # size below which jit stops winning
    for n in reversed(common):
        if jit[n] <= npy[n]:
            crossover = n
        else:
            break
    if crossover is None:
        return Decision(
            knob=f"{program}.jit_min", value=NEVER, source="costdb",
            why=f"jit slower than numpy at every measured size "
                f"({len(common)} buckets, up to n{common[-1]}); "
                "numpy path pinned",
            candidates=cand,
        )
    return Decision(
        knob=f"{program}.jit_min", value=crossover, source="costdb",
        why=f"measured crossover: jit wins from n{crossover} up "
            f"({len(common)} buckets compared)",
        candidates=cand,
    )


_CROSSOVER_CACHE: dict[str, int] = {}


def cached_crossover(program: str, *, default: int = 65536) -> int:
    """Hot-path accessor: one costdb consult per process per program
    (a data-plane consumer calls it per batch, so it must cost a dict
    lookup)."""
    v = _CROSSOVER_CACHE.get(program)
    if v is None:
        v = int(jit_crossover(program, default=default).value)
        _CROSSOVER_CACHE[program] = v
    return v


def invalidate_cache() -> None:
    """Drop memoized crossovers (tests; post-calibration refresh)."""
    _CROSSOVER_CACHE.clear()


# -- cluster process count (elastic membership) -----------------------------

def choose_process_count(current: int, *, db=None,
                         max_procs: int | None = None) -> Decision:
    """Process count for the next cluster incarnation, from recorded
    ``pw.cluster.epoch`` rows (``p<n>`` buckets; the cluster runner
    records every completed streaming epoch's wall clock).  Argmin of
    measured epoch ms, ties to FEWER processes (same speed for less
    memory and fewer fabric links); the current count — reported as the
    documented default — when nothing is recorded yet."""
    store = _db(db)
    cores = os.cpu_count() or 1
    cap = max_procs if max_procs is not None else max(cores, current, 1)
    cand = {
        f"p{n}": ms
        for n, ms in _bucket_sizes(store, "pw.cluster.epoch", "p").items()
        if 1 <= n <= cap
    }
    if not cand:
        return Decision(
            knob="processes", value=current, source="default",
            why=f"no recorded cluster epochs; keeping current {current} "
                f"(host has {cores} cores)",
        )
    best = min(cand.items(), key=lambda kv: (kv[1], int(kv[0][1:])))
    n_best = int(best[0][1:])
    return Decision(
        knob="processes", value=n_best, source="costdb",
        why=f"measured epoch ms_best {best[1]:.0f} at {best[0]} "
            f"(candidates within {cap}-proc cap: "
            + ", ".join(f"{k}={v:.0f}ms" for k, v in sorted(
                cand.items(), key=lambda kv: int(kv[0][1:]))) + ")",
        candidates={"epochs_ms": cand, "cap": cap},
    )


# -- tp/dp degree over the shared mesh --------------------------------------

def _device_count() -> int:
    """CUDA devices visible to this process; a host without a card is
    one device (the CPU)."""
    import torch

    return torch.cuda.device_count() or 1


def choose_tp(*, cfg=None, n_devices: int | None = None, db=None,
              budget_bytes: int | None = None, device="cuda") -> Decision:
    """Tensor-parallel degree.  Measured ``pw.engine.tp`` rows
    (``tp<n>`` buckets) win; otherwise, with a model config and an HBM
    budget, the SMALLEST legal tp whose per-shard ledger (at the
    documented engine shapes) fits; tp=1 on a fresh single-device host.
    The reference calls the ledger without a pool shape, which raises
    and is swallowed, so it never takes the ledger branch; the port
    builds the ledger at :data:`~.memory.ENGINE_DEFAULTS`."""
    if n_devices is None:
        n_devices = _device_count()
    store = _db(db)
    measured = {
        n: ms
        for n, ms in _bucket_sizes(store, "pw.engine.tp", "tp").items()
        if n <= n_devices
    }
    if measured:
        best = min(measured.items(), key=lambda kv: (kv[1], kv[0]))
        return Decision(
            knob="tp", value=best[0], source="costdb",
            why=f"measured step ms_best {best[1]:.2f} at tp{best[0]} "
                f"({len(measured)} degrees recorded)",
            candidates={f"tp{n}": ms for n, ms in measured.items()},
        )
    legal = [1]
    if cfg is not None:
        # the KV heads: a config's ``n_kv_heads`` where it has one, else
        # its ``n_heads`` (the decoder's KV heads; the reference reads
        # ``n_kv_heads`` alone, which a DecoderConfig lacks, so it never
        # leaves tp = 1)
        heads = getattr(cfg, "n_kv_heads", None) or getattr(cfg, "n_heads", 1)
        legal = legal_tp_values(
            heads, getattr(cfg, "vocab_size", 0), n_devices,
            getattr(cfg, "d_ff", 0),
        ) or [1]
        if budget_bytes is not None:
            from .memory import ENGINE_DEFAULTS, hbm_plan

            for tp in sorted(legal):
                plan = hbm_plan(
                    cfg, num_blocks=ENGINE_DEFAULTS["num_blocks"],
                    block_size=ENGINE_DEFAULTS["block_size"], tp=tp,
                    budget_bytes=budget_bytes, device=device)
                if plan.fits:
                    return Decision(
                        knob="tp", value=tp, source="hbm_plan",
                        why=f"smallest legal tp whose per-shard ledger "
                            f"fits the {budget_bytes} B budget "
                            f"(legal: {sorted(legal)})",
                    )
    return Decision(
        knob="tp", value=min(legal), source="default",
        why=f"no measured tp rows and no fitting ledger; tp={min(legal)} "
            f"of legal {sorted(legal)} on {n_devices} device(s)",
    )


# -- the aggregate plan -----------------------------------------------------

def plan(*, cfg=None, db=None, current_processes: int | None = None,
         n_devices: int | None = None, budget_bytes: int | None = None,
         max_procs: int | None = None, device="cuda") -> Plan:
    """Every knob the planner owns, as one recorded Plan.

    With a model ``cfg`` the engine shapes come from
    ``choose_engine_config`` (HBM-ledger what-ifs); without one they
    are reported as the documented defaults.  Explicit env overrides
    (``PW_MAPREDUCE_JIT_MIN``, ``PW_VECTORIZE_JIT_MIN``) surface as
    ``env``-sourced decisions so an operator's pin is never silently
    re-planned."""
    store = _db(db)
    p = Plan(fingerprint=store.fingerprint)

    # dual-path crossovers (env pin wins, reported as such)
    for prog, env_var in (
        ("pw.reduce.segment_sum", "PW_MAPREDUCE_JIT_MIN"),
        ("pw.map.vecplan", "PW_VECTORIZE_JIT_MIN"),
    ):
        pin = os.environ.get(env_var)
        if pin:
            p.add(Decision(
                knob=f"{prog}.jit_min", value=int(pin), source="env",
                why=f"pinned by {env_var}",
            ))
        else:
            p.add(jit_crossover(prog, db=store))

    # cluster membership
    cur = current_processes if current_processes is not None else int(
        os.environ.get("PATHWAY_PROCESSES", "1")
    )
    p.add(choose_process_count(cur, db=store, max_procs=max_procs))

    # mesh degree
    tp_d = p.add(choose_tp(cfg=cfg, n_devices=n_devices, db=store,
                           budget_bytes=budget_bytes, device=device))
    if n_devices is None:
        n_devices = _device_count()
    dp = max(1, n_devices // max(1, int(tp_d.value)))
    p.add(Decision(
        knob="dp", value=dp, source=tp_d.source,
        why=f"{n_devices} device(s) // tp={tp_d.value}",
    ))

    # engine shapes: HBM-ledger what-ifs when a model config is given
    from .memory import ENGINE_DEFAULTS

    if cfg is not None:
        from .memory import choose_engine_config

        try:
            res = choose_engine_config(cfg, tp=int(tp_d.value),
                                       budget_bytes=budget_bytes,
                                       device=device)
            src = "hbm_plan" if "budget" in str(res.get("source")) else \
                "default"
            for k in ("num_blocks", "block_size", "max_batch_size",
                      "chain_steps"):
                p.add(Decision(
                    knob=k, value=res[k],
                    source=src if k in res.get("chosen", ()) else "default",
                    why=str(res.get("source")),
                ))
            p.add(Decision(
                knob="prefill_chunk",
                value=2 * int(res["block_size"]), source="default",
                why="2 x block_size (engine admission tiling rule)",
            ))
        except ValueError as exc:  # an unfittable config is a reported
            p.add(Decision(            # decision
                knob="engine_shapes", value=None, source="hbm_plan",
                why=f"no configuration fits: {exc}",
            ))
    else:
        for k, v in ENGINE_DEFAULTS.items():
            p.add(Decision(
                knob=k, value=v, source="default",
                why="no model config provided; documented engine default",
            ))
        p.add(Decision(
            knob="prefill_chunk",
            value=2 * int(ENGINE_DEFAULTS["block_size"]), source="default",
            why="2 x block_size (engine admission tiling rule)",
        ))
    return p
