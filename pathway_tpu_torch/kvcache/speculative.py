"""Speculative decoding for the paged engine (the port of
``pathway_tpu/kvcache/speculative.py``).

A cheap DRAFTER proposes up to K continuation tokens per row; the TARGET
model checks all of them (and the row's last emitted token) in ONE ragged
``paged_mixed_step`` dispatch, C = k+1 query columns a row; the greedy
accept rule emits the longest prefix where the draft equals the target's
argmax, plus the free bonus token of the first mismatching position.
Attention is causal, so a wrong later draft cannot perturb an earlier
position's logits: the emitted stream is TOKEN-IDENTICAL to
non-speculative decode, and a bad drafter costs acceptance rate only.

Drafters:

- :class:`NGramDrafter`, on the host with no device memory: the row's own
  recent window (the longest suffix n-gram seen earlier in it), then a
  table of continuations learned from released sequences, keyed by the
  prefix cache's chain hashes;
- :class:`DraftModelDrafter`, a small decoder (``draft_propose``) over a
  short window of each row's context.

:class:`SpecController` wraps a drafter with an EWMA accept rate: a
drafter that keeps being refuted cools off (empty proposals, so the
engine falls back to the chained decode) and re-probes later.  At each
batch's end the controller records its measured (drafter, K) row in the
cost store (``pw.spec_tier``), and ``speculative="auto"`` builds the
drafter of the store's recorded ``pick`` row on this backend
(:func:`_auto_drafter`).  A draft model is billed against its engine's
HBM ledger at bind time (:class:`SpecResourceError` when it does not
fit; the engine then falls back, logged, to the zero-HBM n-gram
drafter).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from .prefix_cache import chain_hashes

logger = logging.getLogger(__name__)


class SpecResourceError(RuntimeError):
    """A drafter cannot be bound: its draft model does not fit the HBM
    budget beside the engine."""


class Drafter:
    """The drafter contract: propose up to ``k`` continuation tokens for
    a row's context.  Proposals are advisory (the verify step accepts or
    rejects each against the target's argmax).  A drafter is a pure
    function of the tokens it is shown, plus what it learned from
    released tokens, so a restart replays its proposals."""

    name = "drafter"
    k = 4

    def bind(self, engine) -> None:
        """Attach to an engine (sizes, device, weights)."""

    def propose(self, ctx_tokens, k: int) -> list[int]:
        """Up to ``k`` proposed continuation tokens for one row."""
        raise NotImplementedError

    def propose_batch(self, ctxs, ks) -> list[list[int]]:
        """Row-wise proposals; a device drafter overrides this with one
        batched dispatch."""
        return [self.propose(c, k) if k > 0 else [] for c, k in zip(ctxs, ks)]

    def note_release(self, tokens) -> None:
        """A sequence finished with this token stream (a learning hook)."""


class NGramDrafter(Drafter):
    """Host-side drafter.  Sources, in order: the longest suffix n-gram
    (``max_n`` down to 1) of the row's recent ``window`` that occurred
    earlier in it, the most recent occurrence winning; then the
    continuation a released sequence took after the same chain-hashed
    prefix."""

    name = "ngram"

    def __init__(self, k: int = 4, max_n: int = 4, window: int = 256,
                 table_size: int = 512):
        self.k = int(k)
        self.max_n = int(max_n)
        self.window = int(window)
        self._table_size = int(table_size)
        self._table: OrderedDict[bytes, list[int]] = OrderedDict()
        self._block_size = 16
        self._lock = threading.Lock()

    def bind(self, engine) -> None:
        self._block_size = int(engine.pool.block_size)

    def propose(self, ctx_tokens, k: int) -> list[int]:
        if k <= 0 or len(ctx_tokens) < 2:
            return []
        ctx = [int(t) for t in ctx_tokens]
        return self._self_match(ctx, k) or self._hash_match(ctx, k)

    def _self_match(self, ctx: list[int], k: int) -> list[int]:
        w = ctx[-self.window:]
        for n in range(min(self.max_n, len(w) - 1), 0, -1):
            suffix = w[-n:]
            for i in range(len(w) - n - 1, -1, -1):
                if w[i:i + n] == suffix:
                    cont = w[i + n:i + n + k]
                    if cont:
                        return cont
        return []

    def _hash_match(self, ctx: list[int], k: int) -> list[int]:
        bs = self._block_size
        nb = len(ctx) // bs
        if nb == 0:
            return []
        key = chain_hashes(ctx[:nb * bs], bs)[-1]
        with self._lock:
            cont = self._table.get(key)
            if cont is not None:
                self._table.move_to_end(key)
        if cont is None:
            return []
        r = len(ctx) - nb * bs  # tokens already past the hashed blocks
        if cont[:r] != ctx[nb * bs:]:
            return []
        return cont[r:r + k]

    def note_release(self, tokens) -> None:
        toks = [int(t) for t in tokens]
        bs = self._block_size
        keep = self.k + self.max_n + 8  # enough for a proposal past the tail
        with self._lock:
            for bi, key in enumerate(chain_hashes(toks, bs)):
                cont = toks[(bi + 1) * bs:(bi + 1) * bs + keep]
                if cont:
                    self._table[key] = cont
                    self._table.move_to_end(key)
            while len(self._table) > self._table_size:
                self._table.popitem(last=False)


class DraftModelDrafter(Drafter):
    """A small draft MODEL on the engine's device: its own decode plan
    (``plan_decode_params``) and one batched :func:`draft_propose` per
    round over a ``(max_batch_size, window + k)`` buffer of each row's
    most recent tokens.  ``quantize="int8"`` plans the draft model's
    products on int8 weights (resident in int8 on the card)."""

    name = "draft_model"

    def __init__(self, cfg, params, *, k: int = 4, window: int = 32,
                 quantize: str | None = None):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} is not None or 'int8'")
        self.cfg = cfg
        self.base_params = params
        self.k = int(k)
        self.window = int(window)
        self.quantize = quantize
        self.params = None
        self._B = 1
        self._device = None
        self._prog = None

    def bind(self, engine) -> None:
        """Plan the draft model onto the engine's device, billed against
        the engine's HBM ledger first: its bytes, as pool-block
        equivalents, must fit beside the engine's own pool."""
        from .._device import resolve_dtype
        from ..models.decoder import (draft_propose, int8_device_native,
                                      params_to, plan_decode_params)
        from ..obs.memory import tensors
        from ..obs.profiler import profiled

        # the draft model stays tp = 1 on the engine's (shard 0's)
        # device, as in the JAX package; only the verify runs sharded
        plan = plan_decode_params(
            self.cfg, self.base_params, tp=1, quantize=self.quantize,
            native=int8_device_native(None, engine.device))
        dtype = resolve_dtype(self.cfg.dtype, engine.device)
        # billed at the width each tensor will be resident at
        width = torch.empty((), dtype=dtype).element_size()
        draft_bytes = sum(
            t.numel() * (width if t.is_floating_point() else t.element_size())
            for t in tensors(plan))
        hp = engine.hbm_plan
        if hp.budget_bytes is not None:
            extra = -(-int(draft_bytes) // max(hp.per_block_bytes, 1))
            if not hp.fits_with(num_blocks=hp.num_blocks + extra):
                raise SpecResourceError(
                    f"draft model ({draft_bytes / 1048576:.1f}MB ~ {extra} "
                    f"pool blocks) does not fit the HBM budget next to the "
                    f"engine")
        self._device = engine.device
        self.params = params_to(plan, engine.device, dtype)
        self._B = int(engine.max_batch_size)
        cfg, k = self.cfg, self.k

        def _fn(p, buf, nv):
            return draft_propose(p, cfg, buf.long(), nv.long(), k=k)

        sfx = "_i8" if self.quantize == "int8" else ""
        self._prog = profiled(f"pw.prefill_draft{sfx}", _fn)

    def propose(self, ctx_tokens, k: int) -> list[int]:
        return self.propose_batch([ctx_tokens], [k])[0]

    def propose_batch(self, ctxs, ks) -> list[list[int]]:
        if self._prog is None:
            raise SpecResourceError("draft model drafter is not bound")
        if not any(k > 0 for k in ks):
            return [[] for _ in ctxs]
        W = self.window + self.k  # context window + proposal headroom
        B = max(self._B, len(ctxs))
        buf = np.zeros((B, W), np.int32)
        nv = np.ones(B, np.int32)
        for i, ctx in enumerate(ctxs):
            tail = [int(t) for t in ctx[-self.window:]] or [0]
            buf[i, :len(tail)] = tail
            nv[i] = len(tail)
        ids = self._prog(
            self.params, torch.from_numpy(buf).to(self._device),
            torch.from_numpy(nv).to(self._device),
        ).cpu().numpy()
        return [[int(t) for t in ids[i, :k]] if k > 0 else []
                for i, k in enumerate(ks)]


class SpecController:
    """Measured arbitration around one drafter.

    Per verify round the engine reports (proposed, accepted, emitted,
    ms); the controller keeps an EWMA accept rate and COOLS OFF (empty
    proposals for ``cooloff_rounds`` rounds) when it falls under
    ``accept_floor``, then re-probes with an optimistic slate.  The
    running totals (``proposed``, ``accepted``, ``emitted``,
    ``dispatches``, ``ms_total``) are the port's speculation counters;
    :meth:`flush` records the rounds since the last flush in the cost
    store as a ``pw.spec_tier`` row."""

    def __init__(self, drafter: Drafter, *, accept_floor: float = 0.15,
                 cooloff_rounds: int = 32, ewma_alpha: float = 0.2):
        self.drafter = drafter
        self.k = int(drafter.k)
        self.accept_floor = float(accept_floor)
        self.cooloff_rounds = int(cooloff_rounds)
        self.ewma_alpha = float(ewma_alpha)
        self._ewma = 1.0  # optimistic start: probe before judging
        self._cooloff = 0
        self.proposed = 0
        self.accepted = 0
        self.emitted = 0
        self.dispatches = 0
        self.ms_total = 0.0
        # the totals at the last flush (flush records the difference)
        self._flushed = (0, 0, 0, 0, 0.0)
        self._lock = threading.Lock()

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    def bind(self, engine) -> None:
        self.drafter.bind(engine)

    def propose_batch(self, ctxs, ks) -> list[list[int]]:
        with self._lock:
            if self._cooloff > 0:
                self._cooloff -= 1
                if self._cooloff == 0:
                    self._ewma = 1.0  # re-probe with a clean slate
                return [[] for _ in ctxs]
        return self.drafter.propose_batch(ctxs, ks)

    def note_round(self, proposed: int, accepted: int, emitted: int,
                   ms: float) -> None:
        with self._lock:
            self.proposed += proposed
            self.accepted += accepted
            self.emitted += emitted
            self.dispatches += 1
            self.ms_total += ms
            if proposed > 0:
                rate = accepted / proposed
                self._ewma = ((1.0 - self.ewma_alpha) * self._ewma
                              + self.ewma_alpha * rate)
                if self._ewma < self.accept_floor:
                    self._cooloff = self.cooloff_rounds

    def note_release(self, tokens) -> None:
        try:
            self.drafter.note_release(tokens)
        except Exception:  # noqa: BLE001 - learning is best-effort
            logger.warning("drafter note_release failed", exc_info=True)

    def flush(self, db=None) -> None:
        """Record the rounds since the last flush as this backend's
        measured (drafter, K) row in the cost store (``db``, default the
        process store): the substrate ``speculative="auto"`` reads."""
        with self._lock:
            now = (self.proposed, self.accepted, self.emitted,
                   self.dispatches, self.ms_total)
            proposed, accepted, emitted, dispatches, ms_total = (
                a - b for a, b in zip(now, self._flushed))
            self._flushed = now
        if dispatches == 0:
            return
        if db is None:
            from ..obs.costdb import default_db

            db = default_db()
        db.observe(
            "pw.spec_tier", f"{self.drafter.name}|k{self.k}",
            ms=ms_total / dispatches,
            extra={
                "drafter": self.drafter.name, "k": self.k,
                "accept_rate": round(accepted / max(proposed, 1), 4),
                "accepted_per_dispatch": round(emitted / dispatches, 3),
            },
        )


def _auto_drafter(db=None) -> Drafter:
    """The ``speculative="auto"`` pick: the cost store's recorded
    ``pw.spec_tier`` ``pick`` row under THIS backend's fingerprint (its
    recorded K when the pick is the n-gram drafter), else the zero-HBM
    n-gram drafter at its default K.  A recorded draft-model pick needs a
    draft model, which the store does not hold, so it too resolves to
    the default n-gram drafter, as the reference's does."""
    if db is None:
        from ..obs.costdb import default_db

        db = default_db()
    entry = db.get("pw.spec_tier", "pick")
    if entry is not None:
        extra = entry.get("extra") or {}
        if extra.get("drafter", "ngram") == "ngram":
            return NGramDrafter(k=int(extra.get("k") or 4))
    return NGramDrafter()


def resolve_speculative(value, engine) -> SpecController | None:
    """Resolve ``PagedDecodeEngine(speculative=...)``:

    - ``None`` / ``False`` / ``"off"`` — disabled;
    - ``"ngram"`` / ``True`` — the n-gram drafter at its default K;
    - ``"auto"`` — the cost store's measured pick (:func:`_auto_drafter`);
    - a :class:`Drafter` — wrapped in a :class:`SpecController`;
    - a :class:`SpecController` — used as given.

    The controller is bound to ``engine``; a draft model that does not
    fit the engine's HBM budget falls back, with a warning, to the
    n-gram drafter at the same K."""
    if value is None or value is False or value == "off":
        return None
    if isinstance(value, SpecController):
        ctrl = value
    elif isinstance(value, Drafter):
        ctrl = SpecController(value)
    elif value is True or value == "ngram":
        ctrl = SpecController(NGramDrafter())
    elif value == "auto":
        ctrl = SpecController(_auto_drafter())
    else:
        raise ValueError(
            f"speculative={value!r} is not one of None/'off'/'ngram'/"
            "'auto'/Drafter/SpecController"
        )
    try:
        ctrl.bind(engine)
    except SpecResourceError as exc:
        logger.warning(
            "speculative drafter %r disabled (%s); falling back to the "
            "zero-HBM n-gram drafter", ctrl.drafter.name, exc)
        ctrl = SpecController(NGramDrafter(k=ctrl.k))
        ctrl.bind(engine)
    return ctrl


__all__ = ["DraftModelDrafter", "Drafter", "NGramDrafter", "SpecController",
           "SpecResourceError", "resolve_speculative"]
