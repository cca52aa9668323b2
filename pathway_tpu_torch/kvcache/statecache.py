"""Constant-memory decode: the fixed-size state backend and its engine
(the port of ``pathway_tpu/kvcache/statecache.py``).

The paged engine's cost per sequence GROWS with its context: every token
appends K/V, so device memory caps live sessions at pool bytes over
context bytes, and a suspend copies the whole conversation.  The SSD
decoder family (``models/decoder.py`` ``ssd_*``) replaces attention with
a gated linear-attention recurrence whose decode state is ONE fixed-size
tensor a sequence, ``[n_layers, n_heads, head_dim, head_dim]``, whatever
the context length.

:class:`StateCache` is the :class:`~.backend.CacheBackend` that holds
those states: a stacked ``[L, max_slots, H, hd, hd]`` tensor on the
device in the compute dtype, with one SLOT a sequence for its whole life
in place of block tables (no growth, no copy-on-write, no preemption).
Slot 0 is the null sink, like the paged pool's block 0: padding rows of
every dispatch write there.  A session suspends with one fixed-size
gather to pinned host memory and resumes with one scatter, whatever its
context length.

:class:`StateDecodeEngine` serves the SSD family with the serving surface
of :class:`~.engine.PagedDecodeEngine` (continuous batching, chunked
prefill on the mixed-token budget, chained decode, greedy and seeded
sampling, watchdog and supervised restart, sessions, the degrade hook)
by BORROWING the paged engine's cache-agnostic methods unbound: their
semantics are what the fleet and scheduler rely on.  It defines only the
cache-specific ones: admission by slot, release (suspend at completion),
the three dispatch shapes and the restart rebuild through
``make_backend("state")``.  Preemption, prefix sharing and speculation
stay off.

The engine is held to the same HBM ledger as the paged engine
(``obs/memory.hbm_plan``) with the constant-memory cache term:
``max_slots`` slots of ``state_bytes_per_seq`` bytes, context length
absent (``hbm_budget_bytes``, ``hbm_fit``; as in the reference, the
state engine's sizes are explicit).  Its programs are registered in the
device cost observatory (``pw.ssd_decode_step``, ``pw.ssd_mixed_step``,
``pw.ssd_chained_decode``, their ``_sampled`` twins; the cache's
``pw.state_suspend`` / ``pw.state_resume`` / ``pw.state_clear``), and it
records the paged engine's spans and counters: engine-generic ones on
the cache's ``KVCacheStats``, the slot and suspend/resume ones on its
``StateCacheStats``.

One correction to the paged playbook: a chain cannot let a finished row
keep stepping (the paged chain parks surplus writes in the null block; a
recurrent state has no null to absorb updates), so the chained programs
take per-row budgets and the EOS id and FREEZE finished rows, keeping
every suspended state equal to ``context + emitted[:-1]``.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
import weakref
from typing import Callable

import numpy as np
import torch

from .. import faults, obs
from .._device import resolve_device, resolve_dtype
from ..models.decoder import greedy, params_to, ssd_augment_params
from ..parallel.mesh import (SSD_STATE_SPEC, shard_decoder_params,
                             shard_shape)
from ..obs import memory as obs_memory
from ..obs.profiler import profiled
from .backend import CacheBackend, UnsupportedCacheOp, make_backend
from .block_pool import PoolExhausted, SequenceState, unique_name
from .engine import (PagedDecodeEngine, _Active, _WatchdogSync, _same,
                     _samp_args, engine_shards)

logger = logging.getLogger(__name__)


def _state_gather_fn(state, slot):
    return state[:, slot]


def _state_clear_fn(state, slot):
    state[:, slot].zero_()
    return state


def _state_scatter_fn(state, slot, vals):
    state[:, slot] = vals
    return state


# the fixed-shape suspend / resume / clear of one slot, registered in the
# device cost observatory under the reference's names
_state_gather = profiled("pw.state_suspend", _state_gather_fn)
_state_scatter = profiled("pw.state_resume", _state_scatter_fn)
_state_clear = profiled("pw.state_clear", _state_clear_fn)

# live caches by metrics name (the paged pools' naming rule)
_LIVE_CACHES: "weakref.WeakValueDictionary[str, StateCache]" = (
    weakref.WeakValueDictionary()
)
_LIVE_CACHES_LOCK = threading.Lock()


class StateCache(CacheBackend):
    """Slot allocator over the stacked SSD state tensor: the
    constant-memory implementation of the engine↔cache contract.
    ``block_size`` has no meaning here but is kept: fleet routing digests
    prompts in ``block_size`` chains for either backend."""

    cache_kind = "state"
    supports_fork = False
    supports_prefix = False
    supports_preemption = False

    def __init__(self, *, max_slots: int, n_layers: int, n_heads: int,
                 head_dim: int, dtype=torch.float32, block_size: int = 16,
                 name: str = "state_cache", device="cuda", mesh=None):
        if max_slots < 2:
            raise ValueError("max_slots must be >= 2 (slot 0 is reserved)")
        self.max_slots = int(max_slots)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.block_size = int(block_size)
        # ``shards``: one [L, S, H/tp, hd, hd] state a shard (one at
        # tp = 1), on its device, under one slot table (the paged pool's
        # head split)
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.size
        if self.n_heads % self.tp:
            legal = [t for t in range(1, self.n_heads + 1)
                     if self.n_heads % t == 0]
            raise ValueError(
                f"cannot shard the state cache: n_heads={self.n_heads} "
                f"% tp={self.tp} != 0. Legal tp values: {legal}")
        shape = shard_shape(
            (self.n_layers, self.max_slots, self.n_heads, self.head_dim,
             self.head_dim), SSD_STATE_SPEC, self.tp)
        devices = ([resolve_device(device)] if mesh is None
                   else mesh.devices)
        self.device = devices[0]
        self.shards = [torch.zeros(shape, dtype=dtype, device=d)
                       for d in devices]
        # slot 0 reserved: never allocated, target of padded dispatch rows
        self._free: list[int] = list(range(self.max_slots - 1, 0, -1))
        self._seqs: dict[int, SequenceState] = {}
        self._arrival = 0
        self._lock = threading.RLock()
        self.n_suspends = 0
        self.n_resumes = 0
        from ..serve.metrics import kv_stats, state_stats

        with _LIVE_CACHES_LOCK:
            self.name = unique_name(name, self, _LIVE_CACHES)
        wref = weakref.ref(self)

        def _in_use() -> int:
            cache = wref()
            return 0 if cache is None else cache.slots_in_use

        # engine-generic counters (TTFT, chains, restarts, host gap) live
        # on the shared KV stats block, slot occupancy as its blocks gauge
        self.kv_stats = kv_stats(
            self.name, blocks_in_use_fn=_in_use,
            blocks_total=self.max_slots - 1, shards=self.tp,
            shard_hbm_bytes=self.per_shard_bytes,
        )
        # the pathway_state_* family: slots and suspend/resume traffic
        self.state_stats = state_stats(
            self.name, slots_in_use_fn=_in_use,
            slots_total=self.max_slots - 1,
            state_bytes_per_seq=self.state_bytes_per_seq(1),
        )

    def retire(self) -> None:
        """Release the registry name now, so a restart's same-name cache
        re-attaches to the monotonic counters."""
        with _LIVE_CACHES_LOCK:
            if _LIVE_CACHES.get(self.name) is self:
                del _LIVE_CACHES[self.name]

    # -- capacity ----------------------------------------------------------
    @property
    def per_shard_bytes(self) -> int:
        """The state bytes EACH shard holds (all of it at tp = 1)."""
        s = self.shards[0]
        return s.numel() * s.element_size()

    def state_bytes_per_seq(self, n_tokens: int = 1) -> int:
        """One slot's bytes over every shard, ``L * H * hd * hd *
        itemsize``: a constant, with no context-length term."""
        return (self.n_layers * self.n_heads * self.head_dim
                * self.head_dim * self.shards[0].element_size())

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def slots_in_use(self) -> int:
        return (self.max_slots - 1) - len(self._free)

    def stats(self) -> dict:
        """Slot occupancy and suspend/resume counts."""
        with self._lock:
            return {"slots_in_use": self.slots_in_use,
                    "slots_total": self.max_slots - 1,
                    "state_bytes_per_seq": self.state_bytes_per_seq(),
                    "suspends": self.n_suspends, "resumes": self.n_resumes}

    def sequence(self, seq_id: int) -> SequenceState:
        return self._seqs[seq_id]

    def sequences(self) -> list[SequenceState]:
        return list(self._seqs.values())

    # -- slot lifecycle ----------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int, *, shared_blocks=(),
                 priority: int = 1) -> SequenceState:
        """Claim ONE slot for a new sequence (``block_ids`` is ``[slot]``,
        so the session store's calls stay uniform across backends), its
        state zeroed: the recurrence ACCUMULATES onto the slot, and a
        reused slot would fold its last occupant into the new sequence.
        Raises :class:`PoolExhausted` with no side effects when every
        slot is live."""
        if shared_blocks:
            raise UnsupportedCacheOp(
                "StateCache does not support shared (prefix) slots")
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError(f"sequence {seq_id} already allocated")
            if not self._free:
                raise PoolExhausted("state cache has no free slot",
                                    needed=1, free=0)
            slot = self._free.pop()
            for st in self.shards:
                _state_clear(st, slot)
            self._arrival += 1
            seq = SequenceState(seq_id=seq_id, block_ids=[slot],
                                n_tokens=int(n_tokens), priority=priority,
                                arrival=self._arrival)
            self._seqs[seq_id] = seq
            return seq

    def extend_slots(self, seq_id: int, k: int) -> list[tuple[int, int]]:
        """Growth is free: the slot absorbs every decode step.  Advances
        the token count and returns the slot ``k`` times (as ``(slot,
        0)``, the paged contract's shape)."""
        if k <= 0:
            return []
        with self._lock:
            seq = self._seqs[seq_id]
            seq.n_tokens += k
            return [(seq.block_ids[0], 0)] * k

    def free_sequence(self, seq_id: int) -> None:
        with self._lock:
            seq = self._seqs.pop(seq_id)
            self._free.append(seq.block_ids[0])

    # -- suspend / resume (backend contract; tiering.SessionStore) ---------
    def suspend_host(self, seq_id: int,
                     context_tokens) -> tuple[dict | None, int]:
        """ONE fixed-size gather a shard to host memory (pinned on the
        card, one synchronise a shard before the slot is freed, so a
        later write into it cannot overtake the copy), then free the
        slot.  The charge is the buffer's real bytes: the shape never
        varies, so nothing is padded."""
        if len(context_tokens) == 0:
            self.free_sequence(seq_id)
            return None, 0
        with self._lock:
            slot = self._seqs[seq_id].block_ids[0]
        hosts = []
        for st in self.shards:
            cuda = st.device.type == "cuda"
            rows = _state_gather(st, slot)
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=cuda)
            host.copy_(rows, non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(st.device).synchronize()
            hosts.append(host)
        self.free_sequence(seq_id)
        with self._lock:
            self.n_suspends += 1
        self.state_stats.record_suspend()
        nbytes = sum(h.nbytes for h in hosts)
        return {"s": hosts}, nbytes

    def resume_host(self, payload: dict, slot_ids) -> None:
        """ONE scatter a shard into the slot; the host-to-device copy is
        stream-ordered before every later kernel that reads the state."""
        slot = int(list(slot_ids)[0])
        for st, host in zip(self.shards, payload["s"]):
            cuda = st.device.type == "cuda"
            _state_scatter(st, slot, host.to(st.device, non_blocking=cuda))
        with self._lock:
            self.n_resumes += 1
        self.state_stats.record_resume()

    # -- verification ------------------------------------------------------
    def check_invariants(self, external_refs=None) -> None:
        """The free list and the live sequences' slots partition
        {1..max_slots-1}: one slot a sequence, no slot held twice, slot 0
        never allocated."""
        with self._lock:
            free = list(self._free)
            assert len(free) == len(set(free)), "duplicate free-list entry"
            assert 0 not in free, "reserved slot 0 on the free list"
            held: list[int] = []
            for seq in self._seqs.values():
                assert len(seq.block_ids) == 1, (
                    f"sequence {seq.seq_id} holds {len(seq.block_ids)} "
                    "slots (must be exactly 1)")
                assert seq.block_ids[0] != 0, (
                    f"sequence {seq.seq_id} holds the reserved null slot")
                held.append(seq.block_ids[0])
            assert len(held) == len(set(held)), (
                "two sequences hold the same slot")
            assert not (set(held) & set(free)), (
                "live slot also on the free list")
            assert len(held) + len(free) == self.max_slots - 1, (
                "free list + live slots do not partition the cache")


class StateDecodeEngine:
    """Continuous-batching generation over :class:`StateCache` and the
    SSD programs, with :class:`~.engine.PagedDecodeEngine`'s serving
    surface (most of it the paged engine's own methods, borrowed).

    ``max_slots`` (alias ``num_blocks``, one capacity unit either way)
    sizes the cache; a parameter dict without the SSD decay projections
    is grafted with ``ssd_augment_params`` (seed 0), so every replica and
    restart runs the same weights.  ``max_restarts``,
    ``watchdog_timeout_s``, ``degrade_fn``, ``session_store``,
    ``hbm_budget_bytes``, ``hbm_fit``, ``name``, ``tp`` and ``devices``
    are the paged engine's: with tp > 1 the (raw, SSD-grafted) params
    are sharded once at construction, the cache holds one [L, S, H/tp,
    hd, hd] state a shard, and every program runs its ``ssd_*_tp``
    form."""

    # cache-agnostic, borrowed unbound: admission order, delivery and the
    # failure domain, sampling arrays, the chained-round driver (only
    # _dispatch_chain, the dispatch shape, differs beneath it)
    generate = PagedDecodeEngine.generate
    serve_batch = PagedDecodeEngine.serve_batch
    generate_batch = PagedDecodeEngine.generate_batch
    _run_loop = PagedDecodeEngine._run_loop
    _loop_body = PagedDecodeEngine._loop_body
    _admit_arrivals = PagedDecodeEngine._admit_arrivals
    _requeue = PagedDecodeEngine._requeue
    _fail_all = PagedDecodeEngine._fail_all
    _wrap_failure = PagedDecodeEngine._wrap_failure
    _try_degrade = PagedDecodeEngine._try_degrade
    _emit = PagedDecodeEngine._emit
    _sync_host = PagedDecodeEngine._sync_host
    _sampling_arrays = PagedDecodeEngine._sampling_arrays
    _is_done = PagedDecodeEngine._is_done
    _finish = PagedDecodeEngine._finish
    _can_chain = PagedDecodeEngine._can_chain
    _chain_headroom = PagedDecodeEngine._chain_headroom
    _chained_rounds = PagedDecodeEngine._chained_rounds
    _scan_chain = PagedDecodeEngine._scan_chain
    _dev = PagedDecodeEngine._dev
    _note_sync = PagedDecodeEngine._note_sync
    _note_dispatch = PagedDecodeEngine._note_dispatch
    _note_issued = PagedDecodeEngine._note_issued
    _synced = PagedDecodeEngine._synced
    _note_mixed = PagedDecodeEngine._note_mixed
    _restarted = PagedDecodeEngine._restarted
    _program = PagedDecodeEngine._program
    _on_shards = PagedDecodeEngine._on_shards
    _prog_suffix = ""

    def __init__(self, cfg, params, *, max_slots: int = 64,
                 num_blocks: int | None = None, max_batch_size: int = 8,
                 prefill_chunk: int = 16, chain_steps: int = 8,
                 stop_token: int | None = None, name: str = "state_decoder",
                 block_size: int = 16,
                 watchdog_timeout_s: float | None = None,
                 max_restarts: int | None = None,
                 degrade_fn: Callable | None = None, session_store=None,
                 hbm_budget_bytes: int | None = None,
                 hbm_fit: str = "reject", device="cuda",
                 tp: int | None = None, devices=None):
        if num_blocks is not None:
            max_slots = int(num_blocks)
        self.tp, self.mesh, self.device = engine_shards(
            cfg, tp, devices, resolve_device(device))
        self._ids = greedy if self.mesh is None else _same
        self.cfg = cfg
        self.name = name
        self.max_batch_size = int(max_batch_size)
        self.stop_token = stop_token
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        if hbm_fit not in ("reject", "clamp", "off"):
            raise ValueError(
                f"hbm_fit={hbm_fit!r} is not one of 'reject', 'clamp', "
                "'off'")
        if "w_a" not in params["layers"][0]:
            params = ssd_augment_params(params, cfg)
        self.params = params_to(params, self.device, self.dtype)
        if self.mesh is not None:
            self.params = shard_decoder_params(self.params, self.mesh)
        head_dim = cfg.d_model // cfg.n_heads
        per_seq = (cfg.n_layers * cfg.n_heads * head_dim * head_dim
                   * torch.empty((), dtype=self.dtype).element_size())
        # the paged engine's pre-flight ledger with the constant-memory
        # cache term: num_blocks is the SLOT count, context length absent
        self.hbm_plan = obs_memory.hbm_plan(
            cfg, num_blocks=int(max_slots), block_size=int(block_size),
            max_batch_size=self.max_batch_size,
            chain_steps=max(1, int(chain_steps)),
            prefill_chunk=int(prefill_chunk), tp=self.tp, dtype=self.dtype,
            params=self.params, budget_bytes=hbm_budget_bytes,
            reference_attn=False, state_bytes_per_seq=per_seq,
            device=self.device,
        )
        if self.hbm_plan.budget_bytes is not None \
                and not self.hbm_plan.fits and hbm_fit != "off":
            clamped = (self.hbm_plan.max_fitting_num_blocks()
                       if hbm_fit == "clamp" else None)
            if clamped is None or clamped < 2:
                raise ValueError(self.hbm_plan.reject_message())
            logger.warning(
                "engine %s does not fit HBM at max_slots=%d; clamping to %d "
                "(budget %.1fMB, %s)", name, int(max_slots), clamped,
                self.hbm_plan.budget_bytes / 1048576,
                self.hbm_plan.budget_source)
            max_slots = clamped
            self.hbm_plan = self.hbm_plan.with_(num_blocks=clamped)
        self._pool_kwargs = dict(
            max_slots=int(max_slots), n_layers=cfg.n_layers,
            n_heads=cfg.n_heads, head_dim=head_dim, dtype=self.dtype,
            block_size=int(block_size), name=name, device=self.device)
        if self.mesh is not None:
            self._pool_kwargs["mesh"] = self.mesh
        self.pool = make_backend("state", **self._pool_kwargs)
        if watchdog_timeout_s is None:
            env_wd = os.environ.get("PW_ENGINE_WATCHDOG_S")
            watchdog_timeout_s = float(env_wd) if env_wd else None
        self.watchdog_timeout_s = (
            float(watchdog_timeout_s)
            if watchdog_timeout_s and watchdog_timeout_s > 0 else None)
        if max_restarts is None:
            max_restarts = int(os.environ.get("PW_ENGINE_MAX_RESTARTS", "0")
                               or 0)
        self.max_restarts = max(0, int(max_restarts))
        self.degrade_fn = degrade_fn
        self._degrade_takes_req = (
            degrade_fn is not None
            and "req" in inspect.signature(degrade_fn).parameters)
        self.session_store = session_store
        self._watchdog = (_WatchdogSync() if self.watchdog_timeout_s
                          else None)
        self.n_restarts = 0
        self.n_degraded = 0
        self.rounds = {"mixed": 0, "decode": 0, "chain": 0}
        # the recurrence has no positional table: only max_new and EOS
        # close a request (the borrowed capacity checks compare to inf)
        self.max_seq_tokens = float("inf")
        self.prefill_chunk = max(1, int(prefill_chunk))
        # one mixed round's token budget: a decode row costs one token,
        # the rest is chunk headroom (the paged ragged step's rule)
        self.mixed_tokens = self.max_batch_size + self.prefill_chunk
        self.chain_steps = max(1, int(chain_steps))
        self._spec = None  # speculation needs paged slots: always off
        self._seq_counter = 0
        self._lock = threading.RLock()
        self._run_id: str | None = None
        self._t_device_idle: float | None = None
        self._t_dispatch: float | None = None
        self._t_failure: float | None = None
        self._dispatch_kind = "step"
        self._run_ctx: tuple = (obs.new_trace_id(), 0)
        # no prefix sharing; the borrowed run loop clears the empty map
        self._inflight_prefix: dict = {}
        self._sampled: dict | None = None
        cfg = self.cfg
        step, mixed, chained = (self._program("ssd_decode_step"),
                                self._program("ssd_mixed_step"),
                                self._program("ssd_chained_decode"))
        ids = self._ids

        def _step_fn(p, state, token, slots):
            out, state = step(p, cfg, state, token.long(), slots.long())
            return ids(out), state

        def _mixed_fn(p, state, tokens, n_valid, slots):
            out, state = mixed(p, cfg, state, tokens.long(), n_valid.long(),
                               slots.long())
            return ids(out), state

        def _chained_fn(p, state, token, slots, steps, rem, stop_tok):
            return chained(p, cfg, state, token.long(), slots.long(), steps,
                           rem.long(), stop_tok.long())

        # three static shapes cover a greedy workload: (B,) decode,
        # (B, C) mixed, (B, K) chained
        self._step = profiled("pw.ssd_decode_step", _step_fn)
        self._mixed = profiled("pw.ssd_mixed_step", _mixed_fn)
        self._chained = profiled("pw.ssd_chained_decode", _chained_fn)

    def _state(self):
        """The state a program takes (see ``_on_shards``)."""
        return self._on_shards(self.pool.shards)

    def _sampled_programs(self) -> dict:
        """The sampled twins of the three programs (``pw.ssd_*_sampled``),
        built on first use."""
        if self._sampled is None:
            cfg = self.cfg
            step = self._program("ssd_decode_step_sampled")
            mixed = self._program("ssd_mixed_step_sampled")
            chained = self._program("ssd_chained_decode_sampled")

            def _step_fn(p, state, token, slots, *samp):
                return step(p, cfg, state, token.long(), slots.long(),
                            *_samp_args(samp))

            def _mixed_fn(p, state, tokens, n_valid, slots, *samp):
                return mixed(p, cfg, state, tokens.long(), n_valid.long(),
                             slots.long(), *_samp_args(samp))

            def _chained_fn(p, state, token, slots, steps, rem, stop_tok,
                            *samp):
                return chained(p, cfg, state, token.long(), slots.long(),
                               steps, rem.long(), stop_tok.long(),
                               *_samp_args(samp))

            self._sampled = {
                "step": profiled("pw.ssd_decode_step_sampled", _step_fn),
                "mixed": profiled("pw.ssd_mixed_step_sampled", _mixed_fn),
                "chained": profiled("pw.ssd_chained_decode_sampled",
                                    _chained_fn),
            }
        return self._sampled

    # -- failure domain ----------------------------------------------------
    def _restart(self, running, pending, exc: BaseException,
                 attempt: int) -> None:
        """Rebuild the failure domain, a fresh StateCache through the
        backend seam, and requeue every in-flight request with its
        emitted tokens: re-admission recomputes the recurrence over
        prompt + emitted, token-identical as the paged restart is.  The
        survivors are requeued BEFORE the rebuild, so a failed rebuild
        still leaves every request to the terminal path."""
        self._t_failure = time.perf_counter()
        t0 = self._t_failure
        survivors = [act.req for act in running]
        running.clear()
        for req in survivors:
            self._requeue(pending, req)
        old_pool, self.pool = self.pool, None
        old_pool.retire()
        try:
            self.pool = make_backend("state", **self._pool_kwargs)
        except BaseException:
            self.pool = old_pool  # the terminal path frees through it
            raise
        del old_pool
        self._t_device_idle = None
        self._t_dispatch = None
        self._restarted(attempt, exc, t0, len(survivors))

    # -- admission ---------------------------------------------------------
    def _try_admit(self, req, running, deliver) -> str:
        """Claim one slot and queue the (untrimmed: the recurrence has no
        length cap) prompt for chunked streaming.  A session hit resumes
        the suspended state into the fresh slot and prefill continues at
        the first token it does not cover; no resident position is
        recomputed (the recurrence would fold it twice), so a stored
        context covering the WHOLE new prompt counts as a miss."""
        if req.max_new - len(req.emitted) <= 0:
            deliver(req)
            return "done"
        tokens = (req.prompt + req.emitted) or [4]
        n = len(tokens)
        self._seq_counter += 1
        seq_id = self._seq_counter
        sess_entry = None
        if req.session is not None and self.session_store is not None:
            sess_entry = self.session_store.match(req.session, tokens)
        try:
            seq = self.pool.allocate(seq_id, n, priority=req.priority)
        except PoolExhausted:
            if running:
                return "wait"
            deliver(req, RuntimeError(
                f"state cache ({self.pool.max_slots - 1} slots) has no "
                "free slot"))
            return "failed"
        act = _Active(seq_id, req)
        act.tokens = tokens
        act.admitted = tokens
        if sess_entry is not None and len(sess_entry.tokens) < n:
            try:
                resident = self.session_store.resume_into(
                    self.pool, sess_entry, seq.block_ids)
            except BaseException:
                # not yet in `running`: free here or the slot leaks
                self.pool.free_sequence(seq_id)
                raise
            act.n_filled = resident
            act.n_diverted = resident
        running.append(act)
        return "admitted"

    def _release_seq(self, act: _Active) -> None:
        """Completion-time release.  A session-tagged request SUSPENDS its
        state instead (one gather): it covers admitted + emitted minus
        the last token, which was output and never fed back.  A suspend
        that raises is counted in the store's ``n_suspend_failures`` and
        the slot is freed, so the next turn recomputes."""
        req = act.req
        store = self.session_store
        if (store is not None and req.session is not None
                and act.admitted is not None):
            context = list(act.admitted) + req.emitted[act.emit_base:][:-1]
            try:
                store.suspend(req.session, self.pool, act.seq_id, context)
                return
            except Exception:  # noqa: BLE001 - counted, slot freed below
                store.record_suspend_failure()
                logger.warning("session suspend failed for %r on engine "
                               "%s; freeing its slot", req.session,
                               self.name, exc_info=True)
                if all(s.seq_id != act.seq_id for s in self.pool.sequences()):
                    return  # the failure came after the cache freed it
        self.pool.free_sequence(act.seq_id)

    def _slot(self, act: _Active) -> int:
        return self.pool.sequence(act.seq_id).block_ids[0]

    # -- stepping ----------------------------------------------------------
    def _step_round(self, running, pending, deliver, poll, stop) -> None:
        """One round: the chained program when the queue is quiet (the
        borrowed driver), else the mixed chunk program while a prefill
        streams, else the one-token decode program."""
        if self._can_chain(running, pending):
            if self._chained_rounds(running, pending, deliver, poll, stop):
                return
            if not running:
                return
        if any(a.tokens is not None for a in running):
            self._mixed_round(running, deliver)
        elif running:
            self._decode_round(running, deliver)

    def _decode_round(self, running, deliver) -> None:
        B = self.max_batch_size
        token = np.zeros(B, np.int32)
        slots = np.zeros(B, np.int32)  # idle rows target the null slot
        acts = list(running)
        for i, act in enumerate(acts):
            token[i] = act.req.emitted[-1]
            slots[i] = self._slot(act)
        samp = self._sampling_arrays([(i, a.req) for i, a in enumerate(acts)],
                                     B)
        args = (self.params, self._state(), self._dev(token),
                self._dev(slots))
        faults.fire("engine.dispatch.step")
        t_disp = self._note_dispatch("step")
        if samp is None:
            prog = self._step
            ids, _ = prog(*args)
        else:
            prog = self._sampled_programs()["step"]
            ids, _ = prog(*args, *samp)
        self._note_issued(len(acts))
        ids, t_sync1 = self._synced(ids)
        prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1,
                             items=len(acts))
        self.rounds["decode"] += 1
        for act in acts:
            obs.record_span("engine.decode_step", t_disp, t_sync1,
                            ctx=act.req.ctx)
        self.pool.kv_stats.record_chain(steps=1, slots=len(acts),
                                     emitted=len(acts))
        for i, act in enumerate(acts):
            self._emit(act.req, int(ids[i]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _mixed_round(self, running, deliver) -> None:
        """Decode rows (one token each) and prefill chunk rows (runs of up
        to ``prefill_chunk`` tokens) in one (B, C) dispatch under the
        ``mixed_tokens`` budget: a long prompt streams in chunks beside
        the in-flight decodes, the paged ragged step's scheduling in a
        dense per-row layout (the chunk form wants rectangular runs)."""
        B = self.max_batch_size
        C = self.prefill_chunk
        tokens = np.zeros((B, C), np.int32)
        n_valid = np.zeros(B, np.int32)  # 0 = idle row: an exact no-op
        slots = np.zeros(B, np.int32)
        budget = self.mixed_tokens
        rows: list[tuple[_Active, int, int]] = []  # (act, row, filled|-1)
        row = 0
        for act in running:  # decode rows ride every round
            if act.tokens is not None:
                continue
            tokens[row, 0] = act.req.emitted[-1]
            n_valid[row] = 1
            slots[row] = self._slot(act)
            rows.append((act, row, -1))
            row += 1
            budget -= 1
        for act in running:  # chunk rows fill the remaining budget
            if act.tokens is None:
                continue
            if row >= B or budget <= 0:
                break  # later chunks wait a round (FIFO)
            s = act.n_filled
            e = min(s + C, len(act.tokens), s + budget)
            if e <= s:
                continue
            nv = e - s
            tokens[row, :nv] = act.tokens[s:e]
            n_valid[row] = nv
            slots[row] = self._slot(act)
            rows.append((act, row, e))
            row += 1
            budget -= nv
        if not rows:
            raise RuntimeError("mixed round produced no rows")
        # sampling rides the rows that emit this round; a mid-prefill
        # row's draw would be discarded
        samp = self._sampling_arrays(
            [(r, act.req) for act, r, f in rows
             if f < 0 or f == len(act.tokens)], B)
        d = self._dev
        args = (self.params, self._state(), d(tokens), d(n_valid),
                d(slots))
        faults.fire("engine.dispatch.mixed")
        t_disp = self._note_dispatch("mixed")
        if samp is None:
            prog = self._mixed
            ids, _ = prog(*args)
        else:
            prog = self._sampled_programs()["mixed"]
            ids, _ = prog(*args, *samp)
        self._note_issued(len(rows))
        ids, t_sync1 = self._synced(ids)
        prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1,
                             items=int(n_valid.sum()))
        self.rounds["mixed"] += 1
        self._note_mixed(rows, t_disp, t_sync1)
        for act, row, filled in rows:
            if filled >= 0:
                act.n_filled = filled
                if filled < len(act.tokens):
                    continue  # mid-prefill: this row's id is garbage
                act.tokens = None
            self._emit(act.req, int(ids[row]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _dispatch_chain(self, running, pending):
        """Dispatch ONE K-step chain over every decode row (the sampled
        twin when any row samples).  There is no slot to pre-extend, so
        nothing is preempted; each row's budget and the EOS id go INTO
        the program, which freezes finished rows.  Returns ``(acts,
        kreal, ids)`` with ``ids`` the un-synced (B, K) device tensor."""
        K = self.chain_steps
        B = self.max_batch_size
        token = np.zeros(B, np.int32)
        slots = np.zeros(B, np.int32)
        rem = np.zeros(B, np.int32)  # idle rows: budget 0, fully frozen
        acts, kreal = [], []
        for i, act in enumerate(running):
            token[i] = act.req.emitted[-1]
            slots[i] = self._slot(act)
            rem[i] = min(K, max(act.req.max_new - len(act.req.emitted), 1))
            acts.append(act)
            kreal.append(int(rem[i]))
        stop = acts[0].req.stop_token  # one stop token per run
        samp = self._sampling_arrays([(i, a.req) for i, a in enumerate(acts)],
                                     B)
        args = (self.params, self._state(), self._dev(token),
                self._dev(slots), self._dev(np.arange(K, dtype=np.int32)),
                self._dev(rem),
                self._dev(np.array(-1 if stop is None else int(stop),
                                   np.int32)))
        faults.fire("engine.dispatch.chain")
        t_disp = self._note_dispatch("chain")
        if samp is None:
            prog = self._chained
            ids, _ = prog(*args)
        else:
            prog = self._sampled_programs()["chained"]
            ids, _ = prog(*args, *samp)
        self._note_issued(len(acts))
        self.rounds["chain"] += 1
        return acts, kreal, ids, t_disp, prog


__all__ = ["StateCache", "StateDecodeEngine"]
