"""HBM ledger and pre-flight fit checks for the decode engines (the port
of ``pathway_tpu/obs/memory.py``, with the same arithmetic).

An engine configuration that cannot fit device memory would otherwise
fail at its first dispatch, mid-request, with an allocator error that
names no knob.  The ledger accounts for the three consumers UP FRONT, so
an unfittable ``(num_blocks, chain_steps, max_batch)`` is rejected at
CONSTRUCTION with the budget and the largest fitting alternative named:

- **params**: the decode plan's tensors, each at its own element size
  (an int8 plan's weights count one byte each);
- **KV pool**: ``BlockPool``'s stacked K/V tensors (or, for the state
  engine, ``num_blocks`` slots of a fixed per-sequence state);
- **step temps**: the transient working set of the largest step
  program.  When the program registry (``obs/profiler.py``) holds a
  MEASURED temp watermark for a program whose bucket carries this pool's
  shape, the larger of it and the analytic estimate is used; otherwise
  the analytic estimate (the plain attention path's gathered K/V copy
  and score matrix, the packed activation stream, the logits head).

The budget resolves from (in order) an explicit argument, the
``PW_HBM_BUDGET_BYTES`` env, or, on a CUDA device, what this process can
hold: ``free + torch.cuda.memory_reserved`` from
``torch.cuda.mem_get_info`` (source ``device:mem_get_info``).  On the CPU
no budget resolves and ``hbm_plan`` reports the ledger without enforcing
it, as the reference does on its CPU fallback.  A failure to read the
card's memory raises (the reference swallows it into "unenforced").
"""

from __future__ import annotations

import dataclasses
import os


def resolve_budget(explicit: int | None = None,
                   device="cuda") -> tuple[int | None, str]:
    """(budget_bytes | None, source): ``explicit``, else
    ``PW_HBM_BUDGET_BYTES``, else on a CUDA ``device`` the bytes this
    process can hold (``free`` from ``mem_get_info`` plus what its
    caching allocator already reserved), else None on the CPU."""
    import torch

    if explicit:
        return int(explicit), "explicit"
    env = os.environ.get("PW_HBM_BUDGET_BYTES")
    if env:
        return int(float(env)), "env:PW_HBM_BUDGET_BYTES"
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free + torch.cuda.memory_reserved(dev)), \
            "device:mem_get_info"
    return None, "none"


def _dtype_itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def tensors(tree) -> list:
    """The tensor leaves of a nested dict/list/tuple, in order."""
    import torch

    from .profiler import _leaves

    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _params_bytes(cfg, params, tp: int, itemsize: int) -> int:
    """Per-shard parameter bytes: exact when the live plan is given,
    each tensor at its OWN element size (an int8 plan's weights count one
    byte each, so the ledger the engine builds from its dispatch plan is
    the true resident footprint; a sharded plan, one dict a shard, is
    every shard's bytes over ``tp``), analytic from the config
    otherwise."""
    if params is not None:
        total = sum(t.numel() * t.element_size() for t in tensors(params))
        return int(total // max(tp, 1))
    d, v, ff, ln = cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.n_layers
    n = v * d + cfg.max_len * d + ln * (4 * d * d + 2 * d * ff + 9 * d) \
        + 2 * d
    return int(n * itemsize // max(tp, 1))


def kv_pool_bytes(cfg, *, num_blocks: int, block_size: int, tp: int,
                  itemsize: int) -> int:
    """K + V bytes held by EACH shard — BlockPool.per_shard_bytes
    computed from the configuration before the pool exists."""
    hd = cfg.d_model // cfg.n_heads
    heads = max(cfg.n_heads // max(tp, 1), 1)
    return 2 * cfg.n_layers * num_blocks * block_size * heads * hd * itemsize


def _temp_bytes(cfg, *, num_blocks: int, block_size: int,
                max_batch_size: int, chain_steps: int, prefill_chunk: int,
                tp: int, itemsize: int, reference_attn: bool) -> int:
    """Analytic transient working set of the LARGEST step program (the
    ragged mixed step, or the chained program when its scan carries
    dominate).  Used when the registry has no measured watermark yet —
    construction time, before anything compiled."""
    B = max_batch_size
    C = max(prefill_chunk, 1)
    T = B + C
    d = cfg.d_model
    hd = d // cfg.n_heads
    heads = max(cfg.n_heads // max(tp, 1), 1)
    vocab = cfg.vocab_size // max(tp, 1)
    # a sequence's table can span at most the pool (minus the null block)
    nb_seq = min(-(-cfg.max_len // block_size),
                 max(num_blocks - 1, 1))
    ctx = nb_seq * block_size
    # the plain attention path materializes the gathered K/V copy
    # (B, NB*BS, H, hd) x2 per layer plus the (B, H, C, NB*BS) scores;
    # the paged kernels keep both on chip (no HBM temps)
    gather = (
        2 * B * ctx * heads * hd * itemsize + B * heads * C * ctx * 4
        if reference_attn else 0
    )
    acts = 6 * T * max(d, cfg.d_ff) * itemsize  # packed stream residuals
    logits = B * vocab * 4  # f32 head output
    chain = B * max(chain_steps, 1) * 4 * 2  # [B, K] ids carry + stack
    return int(gather + acts + logits + chain)


@dataclasses.dataclass
class HbmPlan:
    """The ledger for one engine configuration.  ``fits`` is only
    meaningful when ``budget_bytes`` resolved; ``fits_with`` re-plans
    with overrides (the pre-flight what-if the auto-planner queries)."""

    params_bytes: int
    kv_bytes: int
    temp_bytes: int
    temp_source: str
    budget_bytes: int | None
    budget_source: str
    num_blocks: int
    block_size: int
    max_batch_size: int
    chain_steps: int
    prefill_chunk: int
    tp: int
    # the state backend: when set, the cache term is num_blocks
    # SLOTS x this constant (per sequence, global across shards) instead
    # of the paged K/V pool formula — the number the constant-memory
    # capacity headline is computed from
    state_bytes_per_seq: int | None = None
    _replan: "object" = dataclasses.field(default=None, repr=False)

    @property
    def total_bytes(self) -> int:
        return self.params_bytes + self.kv_bytes + self.temp_bytes

    @property
    def fits(self) -> bool:
        return self.budget_bytes is None or \
            self.total_bytes <= self.budget_bytes

    @property
    def per_block_bytes(self) -> int:
        return self.kv_bytes // max(self.num_blocks, 1)

    def fits_with(self, *, num_blocks: int | None = None,
                  chain_steps: int | None = None,
                  max_batch_size: int | None = None) -> bool:
        """Would ``(num_blocks, chain_steps, max_batch)`` fit the same
        budget? — the check PagedDecodeEngine runs before allocating."""
        return self.with_(
            num_blocks=num_blocks, chain_steps=chain_steps,
            max_batch_size=max_batch_size,
        ).fits

    def with_(self, *, num_blocks: int | None = None,
              chain_steps: int | None = None,
              max_batch_size: int | None = None) -> "HbmPlan":
        return self._replan(
            num_blocks=(self.num_blocks if num_blocks is None
                        else int(num_blocks)),
            chain_steps=(self.chain_steps if chain_steps is None
                         else int(chain_steps)),
            max_batch_size=(self.max_batch_size if max_batch_size is None
                            else int(max_batch_size)),
        )

    def max_fitting_num_blocks(self) -> int | None:
        """Largest ``num_blocks`` that fits at the current chain/batch
        (temp depends weakly on num_blocks through the max table span,
        so the closed form is verified and walked down if needed)."""
        if self.budget_bytes is None:
            return self.num_blocks
        per_block = max(self.per_block_bytes, 1)
        nb = (self.budget_bytes - self.params_bytes - self.temp_bytes) \
            // per_block
        nb = min(int(nb), self.num_blocks)
        while nb >= 2 and not self.with_(num_blocks=nb).fits:
            nb -= max(nb // 8, 1)
        return nb if nb >= 2 else None

    def largest_fitting(self) -> dict | None:
        """The largest fitting alternative the rejection message names:
        first shrink ``num_blocks``; if even a minimal pool cannot fit,
        shrink ``max_batch_size`` then ``chain_steps`` too."""
        nb = self.max_fitting_num_blocks()
        if nb is not None:
            return {"num_blocks": nb, "chain_steps": self.chain_steps,
                    "max_batch_size": self.max_batch_size,
                    "total_bytes": self.with_(num_blocks=nb).total_bytes}
        for batch in (self.max_batch_size // 2, 2, 1):
            if batch < 1:
                continue
            for k in (self.chain_steps, 1):
                alt = self.with_(max_batch_size=batch, chain_steps=k)
                nb = alt.max_fitting_num_blocks()
                if nb is not None:
                    return {"num_blocks": nb, "chain_steps": k,
                            "max_batch_size": batch,
                            "total_bytes":
                                alt.with_(num_blocks=nb).total_bytes}
        return None

    def reject_message(self) -> str:
        mb = 1024 * 1024
        alt = self.largest_fitting()
        alt_txt = (
            f"largest fitting alternative: num_blocks={alt['num_blocks']} "
            f"(chain_steps={alt['chain_steps']}, "
            f"max_batch_size={alt['max_batch_size']}) at "
            f"{alt['total_bytes'] / mb:.1f}MB"
            if alt else
            "no (num_blocks, chain_steps, max_batch) configuration fits"
        )
        return (
            f"engine configuration cannot fit HBM: params "
            f"{self.params_bytes / mb:.1f}MB + KV pool "
            f"{self.kv_bytes / mb:.1f}MB ({self.num_blocks} blocks x "
            f"{self.block_size} tokens, tp={self.tp}) + step temps "
            f"{self.temp_bytes / mb:.1f}MB ({self.temp_source}) = "
            f"{self.total_bytes / mb:.1f}MB > HBM budget "
            f"{self.budget_bytes / mb:.1f}MB ({self.budget_source}); "
            f"{alt_txt}"
        )

    def as_dict(self) -> dict:
        return {
            "params_bytes": self.params_bytes,
            "kv_bytes": self.kv_bytes,
            "temp_bytes": self.temp_bytes,
            "temp_source": self.temp_source,
            "total_bytes": self.total_bytes,
            "budget_bytes": self.budget_bytes,
            "budget_source": self.budget_source,
            "fits": self.fits,
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "max_batch_size": self.max_batch_size,
            "chain_steps": self.chain_steps,
            "tp": self.tp,
            "state_bytes_per_seq": self.state_bytes_per_seq,
        }


def hbm_plan(cfg, *, num_blocks: int, block_size: int,
             max_batch_size: int = 8, chain_steps: int = 8,
             prefill_chunk: int | None = None, tp: int = 1, dtype=None,
             params=None, budget_bytes: int | None = None,
             reference_attn: bool = True,
             state_bytes_per_seq: int | None = None,
             device="cuda") -> HbmPlan:
    """Build the HBM ledger for one engine configuration.

    ``params`` (the live plan) makes the weights term exact; ``dtype``
    (a torch dtype) defaults to float32; ``device`` is where the budget
    is read (:func:`resolve_budget`).  The temp watermark prefers a
    MEASURED value from the program registry when one is recorded (a
    warmed engine re-planning), else the analytic estimate.

    ``state_bytes_per_seq`` switches the cache term to the
    constant-memory state backend: ``num_blocks`` is then the SLOT
    count and the cache charge is ``num_blocks x state_bytes_per_seq /
    tp`` per shard — context length does not appear, which is the whole
    point.  Every fit-check helper (``fits_with``,
    ``max_fitting_num_blocks``, ``largest_fitting``) works unchanged
    because the term stays linear in ``num_blocks``."""
    import torch

    itemsize = _dtype_itemsize(dtype if dtype is not None
                               else torch.float32)
    budget, budget_source = resolve_budget(budget_bytes, device)
    pchunk = int(prefill_chunk) if prefill_chunk else 2 * int(block_size)
    pb = _params_bytes(cfg, params, tp, itemsize)

    def _measured_temp(num_blocks: int) -> int | None:
        """Registry watermark restricted to THIS geometry: the step
        programs' buckets carry the pool shape, so another model's (or
        pool size's) measured temps never inflate this fit check."""
        from . import profiler as _profiler

        hd = cfg.d_model // cfg.n_heads
        pool_sig = (
            f"[{cfg.n_layers},{num_blocks},{int(block_size)},"
            f"{cfg.n_heads},{hd}]"
        )
        return _profiler.registry().max_temp_bytes(
            prefix="pw.", bucket_contains=pool_sig,
        )

    def _build(*, num_blocks: int, chain_steps: int,
               max_batch_size: int) -> HbmPlan:
        measured = _measured_temp(num_blocks)
        if state_bytes_per_seq is not None:
            # state backend: per-shard charge for num_blocks SLOTS of
            # the fixed per-sequence state (sharded on the head axis)
            kv = num_blocks * int(state_bytes_per_seq) // max(tp, 1)
        else:
            kv = kv_pool_bytes(cfg, num_blocks=num_blocks,
                               block_size=int(block_size), tp=tp,
                               itemsize=itemsize)
        analytic = _temp_bytes(
            cfg, num_blocks=num_blocks, block_size=int(block_size),
            max_batch_size=max_batch_size, chain_steps=chain_steps,
            prefill_chunk=pchunk, tp=tp, itemsize=itemsize,
            reference_attn=reference_attn,
        )
        temp, source = (
            (max(measured, analytic), "measured+analytic")
            if measured else (analytic, "analytic")
        )
        plan = HbmPlan(
            params_bytes=pb, kv_bytes=kv, temp_bytes=temp,
            temp_source=source, budget_bytes=budget,
            budget_source=budget_source, num_blocks=int(num_blocks),
            block_size=int(block_size),
            max_batch_size=int(max_batch_size),
            chain_steps=int(chain_steps), prefill_chunk=pchunk, tp=tp,
            state_bytes_per_seq=state_bytes_per_seq,
        )
        plan._replan = _build
        return plan

    return _build(num_blocks=int(num_blocks),
                  chain_steps=max(1, int(chain_steps)),
                  max_batch_size=int(max_batch_size))


# documented shapes for hosts where NO budget resolves (the CPU with no
# env override): with nothing to fit against, the what-if ladder has no
# signal, so the choice is these (reported as such)
ENGINE_DEFAULTS = {
    "num_blocks": 256, "block_size": 16,
    "max_batch_size": 8, "chain_steps": 8,
}

_BATCH_LADDER = (16, 8, 4, 2, 1)
_CHAIN_LADDER = (16, 8, 4, 1)


def choose_engine_config(cfg, *, params=None, tp: int = 1, dtype=None,
                         budget_bytes: int | None = None,
                         reference_attn: bool = True,
                         prefill_chunk: int | None = None,
                         num_blocks: int | None = None,
                         block_size: int | None = None,
                         max_batch_size: int | None = None,
                         chain_steps: int | None = None,
                         device="cuda") -> dict:
    """Pick the engine shapes the caller left as ``None`` from HBM-ledger
    what-ifs (:meth:`HbmPlan.fits_with`) instead of hand-set defaults
    .  Explicit values are honored verbatim — only the Nones
    are chosen.  The rule, in order:

    - ``block_size``: the pool granularity every kernel/chunk rule is
      tiled for — not a fit question; 16 unless overridden.
    - ``max_batch_size``: the widest rung of (16, 8, 4, 2, 1) whose
      ledger fits with a one-sequence pool (batch width costs step
      temps and logits rows, not pool blocks).
    - ``chain_steps``: the longest rung of (16, 8, 4, 1) still fitting
      at that batch (the chain term is bytes-cheap: a [B, K] ids carry).
    - ``num_blocks``: full coverage — every batch row able to span
      ``cfg.max_len`` (plus the null block) — when that fits, else the
      ledger's ``max_fitting_num_blocks`` at the chosen batch/chain.

    With no budget resolvable the ladder has no signal and the choice
    falls back to :data:`ENGINE_DEFAULTS` (reported as such).

    Returns a dict of the four resolved ints plus ``plan`` (a FRESH
    ledger built from the final values — the re-constructibility
    guarantee: anyone re-running ``hbm_plan`` with these numbers gets
    the same fitting verdict), ``chosen`` (which names were auto-picked)
    and ``source``.  Raises ``ValueError`` when a budget resolves but no
    configuration fits, mirroring the construction rejection path."""
    chosen = [name for name, v in (
        ("num_blocks", num_blocks), ("block_size", block_size),
        ("max_batch_size", max_batch_size), ("chain_steps", chain_steps),
    ) if v is None]
    bs = int(block_size) if block_size else ENGINE_DEFAULTS["block_size"]
    budget, budget_source = resolve_budget(budget_bytes, device)

    def ledger(nb: int, k: int, b: int) -> HbmPlan:
        return hbm_plan(
            cfg, num_blocks=nb, block_size=bs, max_batch_size=b,
            chain_steps=k, prefill_chunk=prefill_chunk, tp=tp,
            dtype=dtype, params=params, budget_bytes=budget_bytes,
            reference_attn=reference_attn, device=device,
        )

    if budget is None:
        nb = int(num_blocks) if num_blocks else \
            ENGINE_DEFAULTS["num_blocks"]
        b = int(max_batch_size) if max_batch_size else \
            ENGINE_DEFAULTS["max_batch_size"]
        k = max(1, int(chain_steps) if chain_steps else
                ENGINE_DEFAULTS["chain_steps"])
        return {
            "num_blocks": nb, "block_size": bs, "max_batch_size": b,
            "chain_steps": k, "plan": ledger(nb, k, b), "chosen": chosen,
            "source": "defaults (no HBM budget resolved)",
        }

    blocks_per_seq = -(-cfg.max_len // bs)
    min_nb = blocks_per_seq + 1  # one full-length sequence + null block
    if max_batch_size is None:
        max_batch_size = next(
            (b for b in _BATCH_LADDER if ledger(min_nb, 1, b).fits), 1
        )
    b = int(max_batch_size)
    if chain_steps is None:
        chain_steps = next(
            (k for k in _CHAIN_LADDER if ledger(min_nb, k, b).fits), 1
        )
    k = max(1, int(chain_steps))
    if num_blocks is None:
        want = b * blocks_per_seq + 1
        probe = ledger(want, k, b)
        if probe.fits:
            num_blocks = want
        else:
            num_blocks = probe.max_fitting_num_blocks()
            if num_blocks is None or num_blocks < 2:
                raise ValueError(probe.reject_message())
    nb = int(num_blocks)
    final = ledger(nb, k, b)
    if chosen and not final.fits:
        # an auto-chosen shape must never need the clamp/reject path —
        # the what-ifs above already proved it against the same ledger
        raise AssertionError(
            "auto-chosen engine config failed its own re-constructed "
            "fit check: " + final.reject_message()
        )
    return {
        "num_blocks": nb, "block_size": bs, "max_batch_size": b,
        "chain_steps": k, "plan": final, "chosen": chosen,
        "source": f"hbm_plan.fits_with what-ifs ({budget_source})",
    }
