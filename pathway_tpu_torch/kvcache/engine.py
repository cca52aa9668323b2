"""Continuous-batching generation over the paged KV cache.

The port of ``pathway_tpu/kvcache/engine.py`` ``PagedDecodeEngine``:

- admission (chunked): a request's prompt is matched against the prefix
  cache (shared leading blocks are mapped instead of re-stored and
  re-computed), fresh blocks are allocated for the remainder, and the
  prompt streams through the RAGGED fused step
  (``models/decoder.paged_mixed_step``, the ragged paged-attention
  kernel) in ``prefill_chunk``-token chunks packed beside the in-flight
  decode rows — an arrival never stalls running decodes behind a
  monolithic prefill;
- admission (``chunked_prefill=False``): the prompt is prefilled whole,
  padded to its ``seq_buckets`` bucket, by ONE dense pass
  (``models/decoder.paged_prefill``; the flash-attention kernel on the
  card for buckets >= 256) whose K/V is scattered into the sequence's
  blocks, and its first token is emitted at admission;
- decode: rows with no chunk in flight advance one token per step
  (``paged_decode_step``, the append+attend kernel), or, when the queue
  is quiet, up to ``chain_steps`` steps per dispatch
  (``paged_chained_decode``) with one [B, K] ids sync per chain, the
  next chain dispatched before the previous chain's completions are
  delivered;
- sampling: a request may carry ``sampling=(temperature, top_k, top_p,
  seed)``; a round in which such a row emits dispatches the
  ``*_sampled`` twin of its program (greedy rows ride it at temperature
  0, which returns the argmax exactly), any other round the greedy
  program.  A row's n-th token is drawn from a key of (seed, n) alone,
  so every recompute below replays it bit for bit;
- the token choice runs on the device; only [B] (or [B, K]) int32 ids
  come back to the host per round;
- preemption: when the pool is exhausted, refcount-1 prefix blocks are
  evicted first, then a victim (lowest priority class, most recent
  arrival) is preempted and later re-admitted by recompute over
  ``prompt + emitted`` — token-identical to never having been
  preempted;
- failure: a device->host sync blocked past ``watchdog_timeout_s``
  raises :class:`EngineHungError`; any failure with restart budget left
  (``max_restarts``) rebuilds the pool and prefix cache and re-admits
  every in-flight request by the same recompute; with the budget spent
  every request is handed to ``degrade_fn`` when one is given (the
  fleet's failover hook), else gets a typed ``EngineFailedError``;
- sessions (``session_store``, chunked mode): a request carrying a
  ``session`` id resumes that session's suspended K/V from the store at
  admission (its positions ride the divert rule, like prefix-shared
  blocks) and suspends its context to the store at completion;
- speculation (``speculative=``): a drafter proposes up to K tokens per
  greedy row and ONE ragged verify dispatch (``paged_mixed_step`` with
  C = K+1 query columns a row) checks them; the greedy accept rule keeps
  the tokens identical to non-speculative decode.

Shapes per round are fixed: ``max_batch_size`` rows, ``prefill_chunk``
query columns, ``max_batch_size + prefill_chunk`` packed tokens in a
mixed round; idle rows and columns write to the reserved null block.

The engine dispatches the fused decode PLAN (``models/decoder.
plan_decode_params``): Q/K/V folded into one gemm a layer and the head
pre-transposed, and with ``quantize="int8"`` every matmul weight int8
with per-output-channel scales (resident in int8 on the card).  The plan
is a pure function of the checkpoint, kept as ``base_params``, so a
restart, a fleet replica or a draft model rebuilds the same one.

Sizes (``num_blocks``, ``block_size``, ``max_batch_size``,
``chain_steps``) left as None are chosen from the HBM ledger
(``obs/memory.choose_engine_config``: on the card against what this
process can hold, from ``torch.cuda.mem_get_info``; on the CPU, with no
budget, the documented ``ENGINE_DEFAULTS``), and a configuration that
cannot fit is rejected at construction (``hbm_fit="reject"``), or its
pool shrunk (``"clamp"``).  ``auto_config`` records what was chosen and
why, ``hbm_plan`` the ledger.  The pool is built, and rebuilt on a
restart, through ``backend.make_backend("paged", ...)``.

Tensor parallelism (``tp > 1``): the plan is built with its QKV columns
laid out per shard and sharded once, at construction
(``parallel/mesh.shard_decoder_params``, one dict a shard); the pool
holds one [L, NB, BS, H/tp, hd] K and V tensor a shard under one block
table; and every program dispatches through its ``*_tp`` form
(``models/decoder.py``), which runs the per-shard body on each shard in
lockstep and returns replicated ids.  Shards sit on the first ``tp``
CUDA devices, or on an explicit ``devices=`` list, which may repeat a
device (``["cpu"] * 4`` in the tests, ``["cuda:0"] * tp`` on one card).
Admission, scheduling, preemption, the watchdog, restart and the
degrade hook are host-side and do not change with tp.

Every step program is a ``obs.profiler.profiled`` function under the
reference's name (``pw.decode_step``, ``pw.mixed_step``,
``pw.chained_decode``, ``pw.prefill``, their ``_sampled`` twins,
``pw.verify_step``; ``_i8`` on an int8 plan), called with the reference's
int32 index arrays, so its buckets carry the reference's labels; each
dispatch->sync window is recorded against its program after the sync.
The engine records its spans on the flight recorder (``engine.run``,
``engine.request``, ``engine.pending``, ``engine.admission``,
``engine.sync``, ``engine.host_gap``, ``engine.issue.<kind>``,
``engine.device.<kind>``, ``engine.decode_step``,
``engine.prefill_chunk``, ``engine.chain``, ``engine.verify``,
``engine.draft``; the events ``engine.restart`` and ``engine.degraded``),
its counters on the pool's ``KVCacheStats``, and dumps the recorder when
it fails.  A round's ``engine.issue.<kind>`` (dispatch -> every kernel
enqueued, with the ``rows`` it carries of ``capacity``) starts with its
``engine.device.<kind>`` (dispatch -> the sync's return, host issue
included); ``engine.pending`` runs from the engine learning of a request
to the end of its first admission.
"""

from __future__ import annotations

import inspect
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from .. import faults, obs
from .._device import resolve_device, resolve_dtype
from ..models import decoder as dec
from ..models.decoder import greedy, int8_device_native, plan_decode_params
from ..models.encoder import params_to
from ..obs import memory as obs_memory
from ..obs.profiler import ProfiledFunction, profiled
from ..parallel.mesh import (legal_tp_values, shard_decoder_params, tp_mesh,
                             validate_decoder_tp)
from ..serve.admission import EngineFailedError, Priority
from .backend import make_backend
from .block_pool import PoolExhausted
from .prefix_cache import PrefixCache
from .speculative import resolve_speculative

logger = logging.getLogger(__name__)


class EngineHungError(RuntimeError):
    """A device->host sync exceeded the engine watchdog's deadline: the
    program is presumed wedged.  Handled like a failed dispatch
    (supervised restart while budget remains)."""


class _WatchdogSync:
    """Deadline-bounded device->host sync.

    A blocked ``.cpu()`` cannot be interrupted from Python, so the pull
    runs on a helper thread and the engine thread waits with a timeout.
    On expiry the helper is ORPHANED (a daemon parked on the wedged pull)
    and the next sync spawns a fresh one; the restarted engine's new pool
    makes the wedged program's result irrelevant."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._inbox: queue.Queue | None = None

    def _spawn(self) -> None:
        self._inbox = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, args=(self._inbox,), daemon=True,
            name="pw-engine-watchdog",
        )
        self._thread.start()

    @staticmethod
    def _loop(inbox) -> None:
        while True:
            job = inbox.get()
            if job is None:
                return  # orphaned after a timeout: wind down
            fn, box = job
            try:
                box["result"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised in run()
                box["error"] = exc
            box["done"].set()

    def run(self, fn: Callable, timeout_s: float):
        if self._thread is None or not self._thread.is_alive():
            self._spawn()
        box: dict = {"done": threading.Event(), "result": None, "error": None}
        self._inbox.put((fn, box))
        if not box["done"].wait(timeout_s):
            # the helper is stuck inside fn(): abandon it (the None
            # sentinel stops it if fn ever returns) and fail typed
            self._inbox.put(None)
            self._thread = None
            raise EngineHungError(
                f"device dispatch still blocked after {timeout_s}s "
                "(watchdog deadline)"
            )
        if box["error"] is not None:
            raise box["error"]
        return box["result"]


def resolve_tp(cfg, tp: int | None, n_devices: int | None = None) -> int:
    """The tensor-parallel degree for a decoder config.  ``n_devices``
    (default: the CUDA devices this process sees; a machine with no card
    counts its CPU as one) caps it.  ``tp=None`` picks the largest legal
    degree, stepping down to one that divides the KV heads, the vocab
    and ``d_ff``: 1 on one card or none.  An explicit ``tp`` is
    validated and raises, naming the legal values, when the model or the
    devices cannot shard it."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() or 1
    d_ff = getattr(cfg, "d_ff", None)
    if tp is None:
        legal = legal_tp_values(cfg.n_heads, cfg.vocab_size, n_devices, d_ff)
        return max(legal) if legal else 1
    tp = int(tp)
    validate_decoder_tp(cfg.n_heads, cfg.vocab_size, tp, n_devices, d_ff)
    return tp


def engine_shards(cfg, tp: int | None, devices, device: torch.device):
    """An engine's ``(tp, mesh, home device)``.  ``tp=None`` is one shard
    a listed device, else 1: sharding is asked for, never picked (the
    speed of tp > 1 over several cards is not measured yet; call
    :func:`resolve_tp` with ``tp=None`` for the largest degree the cards
    could take).  Without ``devices``, tp > 1 takes ``tp`` consecutive
    cards from the engine's own (``cuda`` is ``cuda:0``) and raises off
    the card, where shards are placed with ``devices=``.  With a mesh the
    home device is shard 0's: the host-built index arrays go there, and
    each program replicates them to the other shards."""
    if tp is None:
        tp = 1 if devices is None else len(devices)
    if devices is not None:
        n_devices = len(devices)
    elif device.type == "cuda":
        first = device.index or 0
        n_devices = torch.cuda.device_count() - first
        devices = [torch.device("cuda", first + i) for i in range(int(tp))]
    else:
        n_devices = 1
    tp = resolve_tp(cfg, tp, n_devices)
    if tp == 1:
        return 1, None, device
    mesh = tp_mesh(tp, devices)
    return tp, mesh, mesh.devices[0]


def _same(x):
    return x


def _mixed_args(a) -> tuple:
    """The ragged step's index arrays, widened where the port gathers
    with them: ``(tokens, positions, row_tables, row_start, row_nvalid,
    row_token_idx, tok_row, tok_col, sb, so, logit_idx)``."""
    (tokens, positions, row_tables, row_start, row_nvalid, row_token_idx,
     tok_row, tok_col, sb, so, logit_idx) = a
    return (tokens.long(), positions.long(), row_tables, row_start,
            row_nvalid, row_token_idx.long(), tok_row.long(), tok_col.long(),
            sb.long(), so.long(), logit_idx.long())


def _samp_args(a) -> tuple:
    """``(temperature, top_k, top_p, seed, emit)`` with the integer
    fields widened for the sampling head."""
    temp, top_k, top_p, seed, emit = a
    return temp, top_k.long(), top_p, seed.long(), emit.long()


def _norm_sampling(s) -> tuple | None:
    """A sampling spec (dict or 4-tuple) as ``(temperature, top_k, top_p,
    seed)``, or None for greedy.  A temperature-0 spec is KEPT: it rides
    the sampled program, whose head returns the exact argmax for it."""
    if s is None:
        return None
    if isinstance(s, dict):
        return (float(s.get("temperature", 1.0)), int(s.get("top_k", 0)),
                float(s.get("top_p", 1.0)), int(s.get("seed", 0)))
    t, k, p, seed = s
    return (float(t), int(k), float(p), int(seed))


def _payload_extras(r) -> tuple[Any, dict | None]:
    """The optional tail of a request tuple: after ``(prompt, max_new)``
    may come a priority and/or an options dict (``sampling``,
    ``session``, ``on_token``, ``emitted``), in either slot.  Returns
    ``(priority, options)``, priority 1 by default."""
    priority: Any = 1
    opts = None
    for el in r[2:4]:
        if isinstance(el, dict):
            opts = el
        elif el is not None:
            priority = el
    return priority, opts


def _prio(v) -> int:
    """A priority as its int class: an int, or a ``Priority`` name."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return int(Priority.parse(v))


class _Request:
    __slots__ = ("prompt", "max_new", "priority", "stop_token", "emitted",
                 "index", "on_done", "on_error", "sampling", "session",
                 "on_token", "t_arrival", "span", "ctx", "waiting")

    def __init__(self, prompt, max_new: int, *, priority: int = 1,
                 stop_token: int | None = None, index: int | None = None,
                 on_done: Callable | None = None,
                 on_error: Callable | None = None, sampling=None,
                 session=None, on_token: Callable | None = None,
                 emitted=None, trace: tuple | None = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.stop_token = stop_token
        # tokens already produced (a continued request): admission
        # recomputes prompt + emitted, and the seed schedule resumes at
        # emit index len(emitted); max_new counts them
        self.emitted: list[int] = [int(t) for t in emitted or ()]
        self.index = index
        self.on_done = on_done
        self.on_error = on_error
        self.sampling = _norm_sampling(sampling)
        # names a KV tiering session (kvcache/tiering.py)
        self.session = session
        # streams each emitted token as it lands (best-effort)
        self.on_token = on_token
        self.t_arrival = time.perf_counter()
        # the request's root span, opened when the engine learns of it
        # (continuing the trace its scheduler submit minted, when given)
        # and finished at delivery; admission/prefill/chain spans parent
        # under it
        self.span = obs.start_span(
            "engine.request", ctx=trace,
            prompt_tokens=len(self.prompt), max_new=self.max_new,
        )
        self.ctx = self.span.ctx
        # True until the first admission ends (the engine.pending span);
        # a preempted request's re-admission is not a new wait
        self.waiting = True


class _Active:
    __slots__ = ("seq_id", "req", "tokens", "n_filled", "n_diverted",
                 "prefix_keys", "wait_writer", "admitted", "emit_base")

    def __init__(self, seq_id: int, req: _Request):
        self.seq_id = seq_id
        self.req = req
        # the (trimmed) prompt still streaming in; None once prefilled
        self.tokens: list[int] | None = None
        # the token list a chunked admission started from (kept past
        # prefill), and len(emitted) when this _Active was made: the K/V
        # of this allocation covers admitted + emitted[emit_base:] (the
        # drafter's context, and what a session suspend stores)
        self.admitted: list[int] | None = None
        self.emit_base = len(req.emitted)
        self.n_filled = 0
        self.n_diverted = 0  # positions < this are prefix-shared blocks
        self.prefix_keys: list | None = None
        # the sequence whose chunked prefill is STILL WRITING our shared
        # leading blocks: our chunks are gated on its progress
        self.wait_writer: "_Active | None" = None


class PagedDecodeEngine:
    """Batched greedy or sampled decoding through BlockPool + PrefixCache.

    ``max_restarts`` (default ``PW_ENGINE_MAX_RESTARTS`` or 0) and
    ``watchdog_timeout_s`` (default ``PW_ENGINE_WATCHDOG_S`` or off) set
    the failure handling; past the restart budget, ``degrade_fn`` (when
    given) completes each stranded request instead of failing it:
    ``degrade_fn(prompt, n_remaining, emitted)`` returns the remaining
    tokens, and a ``degrade_fn`` that takes a ``req`` keyword also gets
    the request (sampling spec, session, ``on_token``: the fleet's
    failover form).  ``session_store`` (a ``tiering.SessionStore``)
    suspends and resumes session-tagged requests; ``speculative``
    (``None``/``"off"``, ``"ngram"``, ``"auto"``, a ``Drafter`` or a
    ``SpecController``) turns on speculative decoding for greedy rows.
    ``quantize`` (None or ``"int8"``) picks the plan's weights; ``name``
    labels the engine (a fleet names its replicas) and its pool's
    counters.  ``tp`` shards it over ``devices`` (default: ``tp``
    cards from ``device`` on; ``tp=None`` is one shard a listed device,
    else 1; see :func:`engine_shards`).  Sizes left
    None are chosen from the HBM ledger, held to
    ``hbm_budget_bytes`` (or what the card can hold) as ``hbm_fit``
    says: ``"reject"`` raises, ``"clamp"`` shrinks the pool, ``"off"``
    only reports."""

    def __init__(self, cfg, params, *, num_blocks: int | None = None,
                 block_size: int | None = None,
                 max_blocks_per_seq: int | None = None,
                 max_batch_size: int | None = None,
                 seq_buckets=(64, 256, 1024),
                 prefix_sharing: bool = True, stop_token: int | None = None,
                 prefill_chunk: int | None = None,
                 chain_steps: int | None = None,
                 chunked_prefill: bool = True,
                 max_restarts: int | None = None,
                 watchdog_timeout_s: float | None = None,
                 degrade_fn: Callable | None = None, session_store=None,
                 speculative=None, quantize: str | None = None,
                 hbm_budget_bytes: int | None = None,
                 hbm_fit: str = "reject",
                 name: str = "engine", device="cuda", tp: int | None = None,
                 devices=None):
        self.name = name
        self.tp, self.mesh, self.device = engine_shards(
            cfg, tp, devices, resolve_device(device))
        # a greedy program's ids: the argmax of its logits at tp = 1; the
        # sharded head already chose them
        self._ids = greedy if self.mesh is None else _same
        self.cfg = cfg
        self.stop_token = stop_token
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} is not None or 'int8'")
        if hbm_fit not in ("reject", "clamp", "off"):
            raise ValueError(
                f"hbm_fit={hbm_fit!r} is not one of 'reject', 'clamp', "
                "'off'")
        self.quantize = quantize
        self.base_params = params
        # quantized where the checkpoint lies (f32), then moved: an int8
        # plan is native (int8-resident) on the engine's device when
        # int8_device_native says so (the card), dequantized on the CPU
        self.params = params_to(
            plan_decode_params(cfg, params, tp=self.tp, quantize=quantize,
                               native=int8_device_native(None, self.device)),
            self.device, self.dtype)
        if self.mesh is not None:
            # one dict a shard, each on its device; the logical plan
            # is dropped, so each shard holds only its slice
            self.params = shard_decoder_params(self.params, self.mesh)
        # the plain attention path (gathered K/V temps) runs exactly on
        # the CPU; on the card the paged kernels keep them on chip
        self.reference_attn = self.device.type != "cuda"
        # pre-flight HBM fit: params + KV pool + step temps must fit the
        # budget BEFORE any allocation; unset shapes are chosen from the
        # same ledger's what-ifs, over the decode plan's own tensors (an
        # int8 plan billed at its byte width)
        auto = obs_memory.choose_engine_config(
            cfg, params=self.params, tp=self.tp, dtype=self.dtype,
            budget_bytes=hbm_budget_bytes,
            reference_attn=self.reference_attn,
            prefill_chunk=prefill_chunk, num_blocks=num_blocks,
            block_size=block_size, max_batch_size=max_batch_size,
            chain_steps=chain_steps, device=self.device,
        )
        num_blocks = auto["num_blocks"]
        block_size = auto["block_size"]
        chain_steps = auto["chain_steps"]
        self.max_batch_size = int(auto["max_batch_size"])
        self.auto_config = {
            "chosen": auto["chosen"], "source": auto["source"],
            "num_blocks": num_blocks, "block_size": block_size,
            "max_batch_size": self.max_batch_size,
            "chain_steps": chain_steps, "quantize": quantize,
        }
        # built FRESH from the resolved shapes: the verdict enforced is
        # exactly what re-running hbm_plan with these numbers gives
        self.hbm_plan = obs_memory.hbm_plan(
            cfg, num_blocks=int(num_blocks), block_size=int(block_size),
            max_batch_size=self.max_batch_size,
            chain_steps=max(1, int(chain_steps)),
            prefill_chunk=prefill_chunk, tp=self.tp, dtype=self.dtype,
            params=self.params, budget_bytes=hbm_budget_bytes,
            reference_attn=self.reference_attn, device=self.device,
        )
        if auto["chosen"] and self.hbm_plan.budget_bytes is not None \
                and not self.hbm_plan.fits:
            raise AssertionError(
                "auto-chosen engine config must re-construct as fitting: "
                + self.hbm_plan.reject_message())
        if self.hbm_plan.budget_bytes is not None \
                and not self.hbm_plan.fits and hbm_fit != "off":
            clamped = (self.hbm_plan.max_fitting_num_blocks()
                       if hbm_fit == "clamp" else None)
            if clamped is None or clamped < 2:
                raise ValueError(self.hbm_plan.reject_message())
            logger.warning(
                "engine %s does not fit HBM at num_blocks=%d; clamping to "
                "%d (budget %.1fMB, %s)", name, int(num_blocks), clamped,
                self.hbm_plan.budget_bytes / 1048576,
                self.hbm_plan.budget_source)
            num_blocks = clamped
            self.hbm_plan = self.hbm_plan.with_(num_blocks=clamped)
        # kept so a supervised restart can rebuild the pool from scratch
        self._pool_kwargs = dict(
            num_blocks=num_blocks, block_size=block_size,
            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            head_dim=cfg.d_model // cfg.n_heads, dtype=self.dtype,
            name=name, device=self.device,
        )
        if self.mesh is not None:
            self._pool_kwargs["mesh"] = self.mesh
        self.pool = make_backend("paged", **self._pool_kwargs)
        self._prefix_sharing = bool(prefix_sharing)
        self.prefix = PrefixCache(self.pool) if prefix_sharing else None
        bs = self.pool.block_size
        cap = min((num_blocks - 1) * bs, cfg.max_len)
        if max_blocks_per_seq is None:
            max_blocks_per_seq = -(-cap // bs)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_tokens = min(self.max_blocks_per_seq * bs, cfg.max_len)
        # the longest admitted prompt: block-aligned buckets capped at
        # what one table can span
        bucket_cap = max((self.max_seq_tokens // bs) * bs, bs)
        self.seq_buckets = sorted({
            min(-(-b // bs) * bs, bucket_cap) for b in seq_buckets
        }) or [bucket_cap]
        self.chunked_prefill = bool(chunked_prefill)
        # chunk width: block-aligned, default two blocks per step
        if prefill_chunk is None:
            prefill_chunk = 2 * bs
        self.prefill_chunk = max(bs, min(-(-int(prefill_chunk) // bs) * bs,
                                         bucket_cap))
        # packed token budget of one ragged dispatch: each decode row
        # costs one token, the rest is chunk headroom
        self.mixed_tokens = self.max_batch_size + self.prefill_chunk
        self.chain_steps = max(1, int(chain_steps))
        # watchdog + supervised restart: a restart re-admits every
        # in-flight request by recompute over prompt + emitted, the
        # preemption path, so recovered output is token-identical
        if watchdog_timeout_s is None:
            env_wd = os.environ.get("PW_ENGINE_WATCHDOG_S")
            watchdog_timeout_s = float(env_wd) if env_wd else None
        self.watchdog_timeout_s = (
            float(watchdog_timeout_s)
            if watchdog_timeout_s and watchdog_timeout_s > 0 else None
        )
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
        # requests completed by degrade_fn (also the pool's
        # record_engine_degrade counter)
        self.n_degraded = 0
        self.rounds = {"mixed": 0, "decode": 0, "chain": 0, "prefill": 0,
                       "verify": 0}
        self._seq_counter = 0
        self._lock = threading.RLock()
        self._run_id: str | None = None
        # dispatch-window / host-gap accounting: _note_dispatch opens a
        # round's dispatch->sync window (closing any host gap),
        # _note_sync closes it
        self._t_device_idle: float | None = None
        self._t_dispatch: float | None = None
        self._t_failure: float | None = None
        self._dispatch_kind = "step"
        self._run_ctx: tuple = (obs.new_trace_id(), 0)
        # chain key -> (writer _Active, physical block) for blocks an
        # in-flight chunked prefill is still writing (per run)
        self._inflight_prefix: dict = {}
        self._build_programs()
        # the *_sampled programs and the verify program, built on first
        # use: a greedy-only, non-speculative workload never touches them
        self._sampled: dict | None = None
        self._verify: ProfiledFunction | None = None
        # resolution may bill a draft model against this engine's ledger,
        # so it runs after hbm_plan
        self._spec = resolve_speculative(speculative, self)

    def _program(self, name: str):
        """The step program ``name`` of ``models/decoder``: the function
        itself at tp = 1, its ``*_tp`` form over the mesh (the mesh after
        the config) with one."""
        if self.mesh is None:
            return getattr(dec, name)
        fn, mesh = getattr(dec, name + "_tp"), self.mesh
        return lambda p, cfg, *a: fn(p, cfg, mesh, *a)

    def _on_shards(self, xs: list):
        """A program's argument for one tensor a shard ``xs``: the one
        tensor at tp = 1, the list with a mesh."""
        return xs if self.mesh is not None else xs[0]

    def _kv(self, pool) -> tuple:
        """The K and V pools a program takes."""
        return self._on_shards(pool.k), self._on_shards(pool.v)

    def _build_programs(self) -> None:
        """The greedy step programs, each registered in the device cost
        observatory under the reference's name.  They take the
        reference's arguments (int32 index arrays, the configuration
        closed over) and widen the indices the port's math gathers with."""
        cfg, sfx = self.cfg, self._prog_suffix
        step, mixed = (self._program("paged_decode_step"),
                       self._program("paged_mixed_step"))
        chained, prefill = (self._program("paged_chained_decode"),
                            self._program("paged_prefill"))
        ids = self._ids

        def _step_fn(p, k_pool, v_pool, token, positions, bt, sb, so):
            out, k_pool, v_pool = step(p, cfg, k_pool, v_pool, token.long(),
                                       positions.long(), bt, sb, so)
            return ids(out), k_pool, v_pool

        def _mixed_fn(p, k_pool, v_pool, *rest):
            out, k_pool, v_pool = mixed(p, cfg, k_pool, v_pool,
                                        *_mixed_args(rest))
            return ids(out), k_pool, v_pool

        def _chained_fn(p, k_pool, v_pool, token, positions, bt, sb, so):
            return chained(p, cfg, k_pool, v_pool, token.long(),
                           positions.long(), bt, sb, so)

        def _prefill_fn(p, token_ids, n_valid, k_pool, v_pool, bt):
            out, k_pool, v_pool = prefill(p, cfg, token_ids.long(),
                                          n_valid.long(), k_pool, v_pool, bt)
            return ids(out), k_pool, v_pool

        self._step = profiled(f"pw.decode_step{sfx}", _step_fn)
        self._mixed = profiled(f"pw.mixed_step{sfx}", _mixed_fn)
        self._chained = profiled(f"pw.chained_decode{sfx}", _chained_fn)
        self._prefill = profiled(f"pw.prefill{sfx}", _prefill_fn)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @property
    def _prog_suffix(self) -> str:
        """The program family's suffix in logs: ``_i8`` on int8 plans."""
        return "_i8" if self.quantize == "int8" else ""

    # -- sampling ----------------------------------------------------------
    def _sampled_programs(self) -> dict:
        """The sampled twins of the step programs (``pw.*_sampled``),
        built on first use."""
        if self._sampled is None:
            cfg, sfx = self.cfg, self._prog_suffix
            step = self._program("paged_decode_step_sampled")
            mixed = self._program("paged_mixed_step_sampled")
            chained = self._program("paged_chained_decode_sampled")
            prefill = self._program("paged_prefill_sampled")

            def _step_fn(p, k_pool, v_pool, token, positions, bt, sb, so,
                         *samp):
                return step(p, cfg, k_pool, v_pool, token.long(),
                            positions.long(), bt, sb, so, *_samp_args(samp))

            def _mixed_fn(p, k_pool, v_pool, *rest):
                return mixed(p, cfg, k_pool, v_pool, *_mixed_args(rest[:11]),
                             *_samp_args(rest[11:]))

            def _chained_fn(p, k_pool, v_pool, token, positions, bt, sb, so,
                            *samp):
                return chained(p, cfg, k_pool, v_pool, token.long(),
                               positions.long(), bt, sb, so,
                               *_samp_args(samp))

            def _prefill_fn(p, token_ids, n_valid, k_pool, v_pool, bt,
                            *samp):
                return prefill(p, cfg, token_ids.long(), n_valid.long(),
                               k_pool, v_pool, bt, *_samp_args(samp))

            self._sampled = {
                "step": profiled(f"pw.decode_step_sampled{sfx}", _step_fn),
                "mixed": profiled(f"pw.mixed_step_sampled{sfx}", _mixed_fn),
                "chained": profiled(f"pw.chained_decode_sampled{sfx}",
                                    _chained_fn),
                "prefill": profiled(f"pw.prefill_sampled{sfx}", _prefill_fn),
            }
        return self._sampled

    def _verify_program(self):
        """The verify program (``pw.verify_step``), built on the first
        speculative round: the ragged mixed step with one argmax per
        packed query position."""
        if self._verify is None:
            cfg, mixed = self.cfg, self._program("paged_mixed_step")
            ids = self._ids

            def _verify_fn(p, k_pool, v_pool, *rest):
                out, k_pool, v_pool = mixed(p, cfg, k_pool, v_pool,
                                            *_mixed_args(rest))
                return ids(out), k_pool, v_pool

            self._verify = profiled(f"pw.verify_step{self._prog_suffix}",
                                    _verify_fn)
        return self._verify

    def _sampling_arrays(self, entries, B: int):
        """Per-row ``(temperature, top_k, top_p, seed, emit_idx)`` device
        arrays for one dispatch, or None when every row is greedy (the
        round then runs the greedy program).  ``entries``: (row,
        _Request) pairs; greedy rows get temperature 0."""
        if not any(req.sampling is not None for _i, req in entries):
            return None
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int32)
        top_p = np.ones(B, np.float32)
        seed = np.zeros(B, np.int32)
        emit = np.zeros(B, np.int32)
        for i, req in entries:
            emit[i] = len(req.emitted)
            if req.sampling is not None:
                temp[i], top_k[i], top_p[i], seed[i] = req.sampling
        return tuple(self._dev(a) for a in (temp, top_k, top_p, seed, emit))

    # -- public API --------------------------------------------------------
    def generate(self, prompt_ids, max_new: int, *,
                 stop_token: int | None = None) -> list[int]:
        """Single-sequence convenience wrapper over :meth:`generate_batch`."""
        return self.generate_batch([(list(prompt_ids), max_new)],
                                   stop_token=stop_token)[0]

    def serve_batch(self, reqs, scheduler=None) -> list:
        """``batch_fn`` adapter for a request scheduler: ``reqs`` are
        ``(prompt_ids, n_new[, priority][, options])`` payloads; a
        per-request failure lands in that request's result slot.  With
        ``scheduler`` (anything with ``poll_inflight(n)``,
        ``complete_inflight(w, result)`` and ``fail_inflight(w, exc)``),
        new arrivals are admitted into the in-flight batch at step
        boundaries."""
        import functools

        poll = None
        traces = []
        if scheduler is not None:
            def poll(n):
                # the request's trace context rides along, so the engine's
                # spans parent under the scheduler's submit root
                return [
                    ((list(w.payload[0]), int(w.payload[1]))
                     + tuple(w.payload[2:4]), _prio(w.priority),
                     functools.partial(scheduler.complete_inflight, w),
                     functools.partial(scheduler.fail_inflight, w),
                     getattr(w, "trace", None))
                    for w in scheduler.poll_inflight(n)
                ]

            # the batch's own waiters (size-bucket padding repeats the last
            # payload past them: those get fresh traces)
            traces = [getattr(w, "trace", None)
                      for w in getattr(scheduler, "_inflight_waiters", ())]

        def norm(r):
            priority, opts = _payload_extras(r)
            base = (list(r[0]), int(r[1]), _prio(priority))
            return base + (opts,) if opts is not None else base

        return self.generate_batch([norm(r) for r in reqs], poll=poll,
                                   return_exceptions=True, traces=traces)

    def generate_batch(self, requests, *, poll: Callable | None = None,
                       stop_token: int | None = None,
                       return_exceptions: bool = False,
                       traces=None) -> list[list[int]]:
        """Decode ``(prompt_ids, max_new[, priority][, options])``
        requests; ``options`` may hold ``sampling=(temperature, top_k,
        top_p, seed)`` (or the dict form), ``session`` (a tiering session
        id), ``on_token`` (called with each emitted token) and
        ``emitted`` (tokens already produced).

        ``poll(n)``, when given, is called at every step boundary and may
        return up to ``n`` newly arrived ``(payload, priority, on_done,
        on_error)`` tuples to admit; their results flow through the
        callbacks.  ``return_exceptions=True`` places a per-request
        exception in its result slot instead of raising.  An engine
        failure past the restart budget reaches every request as an
        ``EngineFailedError``.  ``traces`` gives each request's trace
        context (a scheduler's ``serve_batch`` passes its waiters')."""
        stop = self.stop_token if stop_token is None else stop_token
        pending: deque[_Request] = deque()
        for i, r in enumerate(requests):
            priority, opts = _payload_extras(r)
            opts = opts or {}
            pending.append(_Request(
                r[0], r[1], priority=_prio(priority), stop_token=stop,
                index=i, sampling=opts.get("sampling"),
                session=opts.get("session"), on_token=opts.get("on_token"),
                emitted=opts.get("emitted"),
                trace=traces[i] if traces and i < len(traces) else None,
            ))
        results: list[Any] = [None] * len(requests)
        errors: list[BaseException] = []
        outstanding = {"n": len(requests)}

        def deliver(req: _Request, err: BaseException | None = None) -> None:
            # delivery closes the request's root span (finish() is
            # idempotent)
            req.span.finish(outcome="error" if err is not None else "done",
                            emitted=len(req.emitted))
            if req.on_done is None and req.on_error is None:
                outstanding["n"] -= 1
            if err is not None:
                if req.on_error is not None:
                    req.on_error(err)
                elif return_exceptions:
                    results[req.index] = err
                else:
                    errors.append(err)
            elif req.on_done is not None:
                req.on_done(list(req.emitted))
            else:
                results[req.index] = list(req.emitted)

        if poll is not None:
            inner_poll = poll

            def poll(n):  # noqa: F811 - bounded by batch-origin work
                return inner_poll(n) if outstanding["n"] > 0 else []

        with self._lock:
            self._run_loop(pending, deliver, poll, stop)
        if self._spec is not None:
            # batch end: the controller's measured (drafter, K) aggregate
            # lands in the cost store, the prior speculative="auto" reads
            self._spec.flush()
        if errors:
            raise errors[0]
        return results

    # -- main loop and failure domain -------------------------------------
    def _run_loop(self, pending, deliver, poll, stop) -> None:
        running: list[_Active] = []
        self._inflight_prefix.clear()
        # a dangling idle mark from the previous batch's last sync would
        # bill the inter-batch wait to this batch's first dispatch
        self._t_device_idle = None
        self._t_dispatch = None
        self._t_failure = None
        # the engine-run trace: issue, dispatch->sync window, host-gap and
        # sync spans of this run under one root (requests keep their own
        # traces)
        run_span = obs.start_span("engine.run", ctx=(obs.new_trace_id(), 0),
                                  pool=self.pool.name)
        self._run_ctx = run_span.ctx
        self._run_id = run_span.trace_id
        attempts_left = self.max_restarts
        while True:
            try:
                self._loop_body(running, pending, deliver, poll, stop)
                break
            except BaseException as exc:
                self._inflight_prefix.clear()
                err = exc
                if attempts_left > 0 and isinstance(err, Exception):
                    attempts_left -= 1
                    obs.recorder().dump_on_failure("engine_failure", err)
                    # the traceback's frames reference the dead pool:
                    # drop them so its memory can be released
                    err.__traceback__ = None
                    try:
                        self._restart(running, pending, err,
                                      self.max_restarts - attempts_left)
                        continue
                    except BaseException as rexc:  # noqa: BLE001
                        err = rexc  # the rebuild failed: budget is moot
                # the run span closes with its error FIRST and the dump is
                # written BEFORE the deliveries, so every typed error
                # carries THIS failure's dump path
                run_span.finish(error=type(err).__name__)
                obs.recorder().dump_on_failure("engine_failure", err)
                self._fail_all(running, pending, deliver, err)
                if not isinstance(err, Exception):
                    raise err  # KeyboardInterrupt/SystemExit propagate
                break
        run_span.finish()

    def _restart(self, running, pending, exc: BaseException,
                 attempt: int) -> None:
        """Rebuild the failure domain (a fresh BlockPool and PrefixCache)
        and requeue every in-flight request with its emitted tokens, so
        admission recomputes prompt + emitted.  The survivors are
        requeued BEFORE the rebuild: if it fails (a sticky device error,
        say), the terminal path still sees every request."""
        self._t_failure = time.perf_counter()
        t0 = self._t_failure
        survivors = [act.req for act in running]
        running.clear()
        for req in survivors:
            self._requeue(pending, req)
        self.prefix = None
        # release the dead pool's name first, so its replacement
        # re-attaches to the same monotonic counters
        old_pool, self.pool = self.pool, None
        old_pool.retire()
        try:
            self.pool = make_backend("paged", **self._pool_kwargs)
        except BaseException:
            # keep a pool attached: the terminal path frees through it
            self.pool = old_pool
            raise
        del old_pool
        self.prefix = PrefixCache(self.pool) if self._prefix_sharing else None
        self._t_device_idle = None
        self._t_dispatch = None
        self._restarted(attempt, exc, t0, len(survivors))

    def _restarted(self, attempt: int, exc: BaseException, t0: float,
                   n_survivors: int) -> None:
        """Account one supervised restart whose rebuild began at ``t0``."""
        self.n_restarts += 1
        rebuild_s = time.perf_counter() - t0
        self.pool.kv_stats.record_engine_restart(rebuild_s)
        obs.event("engine.restart", ctx=self._run_ctx, attempt=attempt,
                  error=type(exc).__name__, rebuild_s=round(rebuild_s, 4),
                  inflight=n_survivors)
        logger.warning(
            "engine %s%s restart #%d after %s: %s — cache rebuilt in "
            "%.3fs, re-admitting %d in-flight request(s) by recompute",
            self.name, self._prog_suffix, self.n_restarts,
            type(exc).__name__, exc, rebuild_s, n_survivors,
        )

    def _fail_all(self, running, pending, deliver, exc: BaseException) -> None:
        """Terminal failure: every request still in flight is handed to
        ``degrade_fn`` (when one is given and the failure is an
        ``Exception``), or gets a typed EngineFailedError (callers
        blocked on a callback must not hang)."""
        # terminal: no recovery window closes against this failure
        self._t_failure = None
        for act in running:
            try:
                self.pool.free_sequence(act.seq_id)
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
        reqs = [act.req for act in running] + list(pending)
        running.clear()
        pending.clear()
        wrapped = self._wrap_failure(exc)
        # a KeyboardInterrupt / SystemExit propagates promptly instead of
        # waiting on the degrade tier
        degrade = self.degrade_fn is not None and isinstance(exc, Exception)
        for req in reqs:
            if degrade and self._try_degrade(req, deliver):
                continue
            deliver(req, wrapped)

    def _try_degrade(self, req: _Request, deliver) -> bool:
        """Complete one stranded request through ``degrade_fn`` and
        deliver it; False (nothing delivered) when the degrade tier
        raised.  Tokens the engine already emitted are kept: the degrade
        tier continues the sequence.  A ``degrade_fn`` taking ``req``
        (the fleet's handoff) streams its tokens itself, so ``on_token``
        is fired here only for the plain ``(prompt, n_remaining,
        emitted)`` form."""
        takes_req = self._degrade_takes_req
        n_engine = len(req.emitted)
        remaining = req.max_new - n_engine
        try:
            if remaining > 0 and (req.stop_token is None
                                  or req.stop_token not in req.emitted):
                if takes_req:
                    extra = self.degrade_fn(list(req.prompt), remaining,
                                            list(req.emitted), req=req)
                else:
                    extra = self.degrade_fn(list(req.prompt), remaining,
                                            list(req.emitted))
                for t in list(extra)[:remaining]:
                    if takes_req:
                        req.emitted.append(int(t))
                    else:
                        self._emit(req, int(t))
                    if req.stop_token is not None and int(t) == req.stop_token:
                        break  # the same EOS truncation as _scan_chain
        except Exception:  # noqa: BLE001 - the request then fails typed
            logger.warning("degrade tier failed for a stranded request of "
                           "engine %s; failing it typed", self.name,
                           exc_info=True)
            return False
        # delivery is outside the try: a raising on_done must propagate,
        # not turn a delivered success into a second (error) delivery
        self.n_degraded += 1
        obs.event("engine.degraded", ctx=req.ctx, emitted=len(req.emitted))
        self.pool.kv_stats.record_engine_degrade()
        logger.warning("engine %s: a stranded request was completed by "
                       "its degrade_fn (%d tokens from the engine, %d from "
                       "the degrade tier)", self.name, n_engine,
                       len(req.emitted) - n_engine)
        deliver(req)
        return True

    def _wrap_failure(self, exc: BaseException) -> EngineFailedError:
        budget = (f" after {self.max_restarts} restart(s)"
                  if self.max_restarts else "")
        return EngineFailedError(
            f"decode engine failed{budget}: {type(exc).__name__}: {exc}",
            retry_after_s=5.0, trace_id=self._run_id,
            dump_path=obs.recorder().last_dump_path,
        )

    def _admit_arrivals(self, running, pending, poll, stop) -> None:
        if poll is None or len(running) >= self.max_batch_size:
            return
        budget = self.max_batch_size - len(running) - len(pending)
        for item in (poll(budget) if budget > 0 else ()):
            payload, priority, on_done, on_error = item[:4]
            # an optional 5th element is the request's trace context
            trace = item[4] if len(item) > 4 else None
            _p, opts = _payload_extras(payload)
            opts = opts or {}
            self._requeue(pending, _Request(
                payload[0], payload[1], priority=priority, stop_token=stop,
                on_done=on_done, on_error=on_error,
                sampling=opts.get("sampling"), session=opts.get("session"),
                on_token=opts.get("on_token"), emitted=opts.get("emitted"),
                trace=trace,
            ))

    def _loop_body(self, running, pending, deliver, poll, stop) -> None:
        while pending or running:
            self._admit_arrivals(running, pending, poll, stop)
            while pending and len(running) < self.max_batch_size:
                req = pending[0]
                t0a = time.perf_counter()
                status = self._try_admit(req, running, deliver)
                if status == "wait":
                    # recurs every round while the pool is full: the
                    # blocked time lands in the request's engine.pending
                    # span when it is admitted, not in a flood of spans
                    break
                t1a = time.perf_counter()
                obs.record_span("engine.admission", t0a, t1a, ctx=req.ctx,
                                outcome=status)
                if req.waiting:
                    req.waiting = False
                    obs.record_span("engine.pending", req.span.t0, t1a,
                                    ctx=req.ctx)
                pending.popleft()
            if not running:
                break
            self._step_round(running, pending, deliver, poll, stop)

    def _readmit_len(self, req: _Request) -> int:
        """How many tokens admission would prefill for ``req`` now."""
        total = len(req.prompt) + len(req.emitted)
        remaining = req.max_new - len(req.emitted)
        if total + remaining > self.max_seq_tokens:
            return max(self.max_seq_tokens - remaining, 1)
        return total

    def _requeue(self, pending, req: _Request) -> None:
        """Queue by PRIORITY class: ahead of strictly-lower-priority work,
        behind equal-or-higher."""
        idx = next(
            (i for i, r in enumerate(pending) if r.priority > req.priority),
            len(pending),
        )
        pending.insert(idx, req)

    def _emit(self, req: _Request, token_id: int) -> None:
        """Record one emitted token; the FIRST token of a request closes
        its time-to-first-token window, and the first token after a
        supervised restart closes the recovery window."""
        req.emitted.append(token_id)
        if req.on_token is not None:
            # a broken stream consumer must not take the batch down
            try:
                req.on_token(token_id)
            except Exception:  # noqa: BLE001
                logger.warning("on_token callback failed; continuing decode",
                               exc_info=True)
        if len(req.emitted) == 1:
            self.pool.kv_stats.record_ttft(time.perf_counter() - req.t_arrival)
        if self._t_failure is not None:
            self.pool.kv_stats.record_engine_recovery(
                time.perf_counter() - self._t_failure)
            self._t_failure = None

    def _note_sync(self) -> None:
        """A device->host sync just returned with nothing queued behind
        it: the dispatch->sync window lands as an ``engine.device.<kind>``
        span (the host's issue of the round and the device's work both
        lie inside it, so it is not busy time) and the device is idle
        until the next dispatch."""
        now = time.perf_counter()
        if self._t_dispatch is not None:
            obs.record_span("engine.device." + self._dispatch_kind,
                            self._t_dispatch, now, ctx=self._run_ctx)
            self._t_dispatch = None
        self._t_device_idle = now

    def _note_dispatch(self, kind: str) -> float:
        """Open a dispatch window (closing the host gap since the last
        sync: an ``engine.host_gap`` span and the pool's host-gap
        counter); returns its start."""
        now = time.perf_counter()
        if self._t_device_idle is not None:
            self.pool.kv_stats.record_host_gap(now - self._t_device_idle)
            obs.record_span("engine.host_gap", self._t_device_idle, now,
                            ctx=self._run_ctx)
            self._t_device_idle = None
        self._t_dispatch = now
        self._dispatch_kind = kind
        return now

    def _note_issued(self, rows: int) -> None:
        """The round's step program returned, every kernel of it enqueued:
        an ``engine.issue.<kind>`` span from the dispatch (the start of
        the round's ``engine.device.<kind>`` window), with the live
        ``rows`` the round carries of ``capacity``."""
        obs.record_span("engine.issue." + self._dispatch_kind,
                        self._t_dispatch, time.perf_counter(),
                        ctx=self._run_ctx, rows=rows,
                        capacity=self.max_batch_size)

    def _synced(self, ids) -> tuple[np.ndarray, float]:
        """The round's ids on the host, the ``engine.sync`` span recorded
        and the device window closed; returns ``(ids, t_sync_end)``."""
        t_sync0 = time.perf_counter()
        ids = self._sync_host(ids)
        t_sync1 = time.perf_counter()
        obs.record_span("engine.sync", t_sync0, t_sync1, ctx=self._run_ctx)
        self._note_sync()
        return ids, t_sync1

    def _sync_host(self, ids: torch.Tensor) -> np.ndarray:
        """Device->host copy of a round's ids, watchdog-bounded when
        configured.  The ``engine.sync`` fault point is inside the pull,
        so a ``hang`` wedges exactly where a stuck program would."""
        def pull():
            faults.fire("engine.sync")
            return ids.cpu().numpy()

        if self._watchdog is None:
            return pull()
        return self._watchdog.run(pull, self.watchdog_timeout_s)

    def _is_done(self, req: _Request, seq_id: int) -> bool:
        if len(req.emitted) >= req.max_new:
            return True
        if req.stop_token is not None and req.emitted[-1] == req.stop_token:
            return True
        # capacity: the next token's position must fit the table
        return self.pool.sequence(seq_id).n_tokens >= self.max_seq_tokens

    def _finish(self, act: _Active, running, deliver) -> None:
        running.remove(act)
        self._release_seq(act)
        deliver(act.req)

    def _release_seq(self, act: _Active) -> None:
        """Completion-time release of a finished sequence's blocks.  A
        session-tagged request (chunked mode, ``session_store`` set)
        SUSPENDS instead: its context K/V — the admitted tokens plus
        every emitted token fed back as input, so all but the last — is
        copied to the store, and the session's next turn resumes by
        scatter rather than recompute.  A suspend that raises is counted
        in the store's ``n_suspend_failures`` and the blocks are freed,
        so that next turn recomputes."""
        req = act.req
        store = self.session_store
        if (store is not None and req.session is not None
                and act.admitted is not None):
            context = list(act.admitted) + req.emitted[act.emit_base:][:-1]
            try:
                store.suspend(req.session, self.pool, act.seq_id, context)
                return
            except Exception:  # noqa: BLE001 - counted, blocks freed below
                store.record_suspend_failure()
                logger.warning("session suspend failed for %r on engine "
                               "%s; freeing its blocks", req.session,
                               self.name, exc_info=True)
                if all(s.seq_id != act.seq_id for s in self.pool.sequences()):
                    return  # the failure came after the pool freed it
        self.pool.free_sequence(act.seq_id)

    # -- admission ---------------------------------------------------------
    def _try_admit(self, req: _Request, running, deliver) -> str:
        """Allocate one request's blocks and queue its prompt for chunked
        streaming (no device work), or, with ``chunked_prefill=False``,
        prefill it whole (:meth:`_prefill_whole`).  Returns "admitted",
        "done" (nothing left to generate), "failed" (delivered as an
        error) or "wait" (pool full while other sequences run)."""
        if req.max_new - len(req.emitted) <= 0:
            deliver(req)
            return "done"
        tokens = req.prompt + req.emitted
        remaining = req.max_new - len(req.emitted)
        if len(tokens) + remaining > self.max_seq_tokens:
            # keep the most recent context that leaves room for every
            # new token
            tokens = tokens[-max(self.max_seq_tokens - remaining, 1):]
        if len(tokens) > self.seq_buckets[-1]:
            tokens = tokens[-self.seq_buckets[-1]:]
        tokens = tokens or [4]
        n = len(tokens)
        self._seq_counter += 1
        seq_id = self._seq_counter
        # a session-tagged request (chunked mode) resumes its suspended
        # K/V from the store instead of going through the prefix cache:
        # a session is one conversation's private history, so the
        # cross-request sharing (and its in-flight writer gates) is
        # bypassed for it
        use_session = (self.chunked_prefill and req.session is not None
                       and self.session_store is not None)
        sess_entry = (self.session_store.match(req.session, tokens)
                      if use_session else None)
        state = None
        attempt = 0
        while state is None:
            shared, keys, writer = [], [], None
            if self.prefix is not None and not use_session:
                shared, keys = self.prefix.match(tokens)
                # extend the match into blocks an IN-FLIGHT chunked
                # prefill is still writing (one writer only)
                for key in keys[len(shared):]:
                    ent = self._inflight_prefix.get(key)
                    if ent is None or (writer is not None
                                       and ent[0] is not writer):
                        break
                    writer = ent[0]
                    shared.append(ent[1])
                if attempt == 0:  # an eviction retry is the same admission
                    hits = len(shared)
                    if hits:
                        self.pool.kv_stats.record_prefix_hit(hits)
                    if len(keys) - hits:
                        self.pool.kv_stats.record_prefix_miss(len(keys) - hits)
            attempt += 1
            try:
                state = self.pool.allocate(seq_id, n, shared_blocks=shared,
                                           priority=req.priority)
            except PoolExhausted as exc:
                if self.prefix is not None and self.prefix.evict(
                        exc.needed - exc.free):
                    continue  # re-match: eviction may have dropped `shared`
                if running:
                    return "wait"
                if self.pool.preempt() is None:
                    deliver(req, RuntimeError(
                        f"KV pool ({self.pool.num_blocks - 1} blocks of "
                        f"{self.pool.block_size}) cannot hold a "
                        f"{n}-token sequence"
                    ))
                    return "failed"
        if not self.chunked_prefill:
            return self._prefill_whole(req, seq_id, tokens, shared, keys,
                                       running, deliver)
        act = _Active(seq_id, req)
        act.tokens = tokens
        act.admitted = tokens
        if use_session:
            resident = 0
            if sess_entry is not None:
                try:
                    resident = self.session_store.resume_into(
                        self.pool, sess_entry, state.block_ids)
                except BaseException:
                    # not yet in `running`: free here or the blocks leak
                    self.pool.free_sequence(seq_id)
                    raise
            # resumed positions ride the divert rule like prefix-shared
            # blocks; the prompt's LAST token always recomputes
            act.n_filled = min(resident, n - 1)
            act.n_diverted = resident
            running.append(act)
            return "admitted"
        # shared leading blocks need no recompute, but the prompt's LAST
        # token always runs to produce the next-token logits
        shared_tokens = len(shared) * self.pool.block_size
        act.n_filled = min(shared_tokens, n - 1)
        act.n_diverted = shared_tokens
        act.wait_writer = writer
        act.prefix_keys = keys
        if self.prefix is not None:
            for key, blk in zip(keys[len(shared):],
                                state.block_ids[len(shared):len(keys)]):
                self._inflight_prefix.setdefault(key, (act, blk))
        running.append(act)
        return "admitted"

    def _prefill_whole(self, req: _Request, seq_id: int, tokens, shared,
                       keys, running, deliver) -> str:
        """Whole-bucket admission (``chunked_prefill=False``): ONE dense
        prefill of the prompt padded to its bucket (the flash kernel on
        the card for buckets >= 256), its K/V scattered into the
        sequence's blocks, and the first token emitted (sampled at emit
        index ``len(emitted)`` for a sampled request).  The prefix-shared
        leading blocks already hold the right K/V: their scatter goes to
        the null block instead of rewriting them (a live sequence may be
        reading them, and a rewrite from another bucket need not be
        bit-identical)."""
        n = len(tokens)
        seq = self.pool.sequence(seq_id)
        try:
            bucket = next(b for b in self.seq_buckets if b >= n)
            buf = np.zeros((1, bucket), np.int32)
            buf[0, :n] = tokens
            scatter_bt = np.zeros((1, bucket // self.pool.block_size),
                                  np.int32)
            scatter_bt[0, : len(seq.block_ids)] = seq.block_ids
            scatter_bt[0, : len(shared)] = 0
            args = (self.params, self._dev(buf),
                    self._dev(np.array([n], np.int32)),
                    *self._kv(self.pool), self._dev(scatter_bt))
            faults.fire("engine.dispatch.prefill")
            t_disp = self._note_dispatch("prefill")
            if req.sampling is None:
                prog = self._prefill
                ids, _, _ = prog(*args)
            else:
                samp = self._sampling_arrays([(0, req)], 1)
                prog = self._sampled_programs()["prefill"]
                ids, _, _ = prog(*args, *samp)
            self._note_issued(1)
            # the sync stays inside the cleanup: a failed sync must not
            # leak the just-prefilled blocks
            ids, t_end = self._synced(ids)
            first = int(ids[0])
            prog.record_dispatch(t_end - t_disp, t_end=t_end, items=n)
            self.rounds["prefill"] += 1
            if self.prefix is not None:
                # insert() keeps only the full-block keys: the partial
                # tail block (the decode-write target) is never shared
                self.prefix.insert(keys, seq.block_ids)
        except BaseException:
            # not yet in `running`: the loop's failure cleanup cannot see
            # this sequence, so free its blocks here
            self.pool.free_sequence(seq_id)
            raise
        self._emit(req, first)
        if self._is_done(req, seq_id):
            self.pool.free_sequence(seq_id)
            deliver(req)
            return "done"
        running.append(_Active(seq_id, req))
        return "admitted"

    # -- stepping ----------------------------------------------------------
    def _step_round(self, running, pending, deliver, poll, stop) -> None:
        """One engine round: a speculative verify round when a drafter is
        armed and proposes, else the chained decode loop when the queue
        is quiet, else ONE ragged mixed step (when any chunk is in
        flight) or one plain decode step."""
        if self._spec is not None and self._spec_round(running, pending,
                                                       deliver):
            return
        if self._can_chain(running, pending):
            if self._chained_rounds(running, pending, deliver, poll, stop):
                return
            if not running:
                return  # every row was preempted into pending
        victims: list[_Active] = []
        reserved = self._reserve_slots(running, pending, victims)
        if victims:
            self._cascade_preempt(victims, running, pending)
        # chunk membership is decided AFTER reservation, which may have
        # preempted a mid-prefill sequence
        chunks = [a for a in running if a.tokens is not None]
        if chunks:
            self._mixed_round(reserved, chunks, running, deliver)
        elif reserved:
            self._decode_round(reserved, running, deliver)

    def _draft_context(self, act: _Active) -> list[int]:
        base = act.admitted if act.admitted is not None else act.req.prompt
        return list(base) + act.req.emitted[act.emit_base:]

    def _spec_round(self, running, pending, deliver) -> bool:
        """One speculative round: the drafter proposes up to K tokens per
        decode row, ONE ragged verify dispatch pushes every row's last
        emitted token plus its proposals through the mixed step (C = K+1
        query columns a row, the argmax at every packed position), and
        the greedy accept rule emits the longest prefix where draft ==
        target argmax plus the bonus token.  Returns False (the round
        falls through to the chain/step/mixed paths) when chunks are in
        flight, any row samples, or nothing was proposed."""
        spec = self._spec
        if any(a.tokens is not None for a in running):
            return False  # mid-prefill chunks stream through mixed
        if any(a.req.sampling is not None for a in running):
            return False
        acts = list(running)
        if not acts:
            return False
        pool = self.pool
        # a row needs k_i + 1 slots (proposals + the bonus token), never
        # more than its remaining emit/capacity budget
        ks = []
        for a in acts:
            rem = min(a.req.max_new - len(a.req.emitted),
                      self.max_seq_tokens - pool.sequence(a.seq_id).n_tokens)
            ks.append(max(0, min(spec.k, rem - 1)))
        if faults.fire("engine.draft") == "drop":
            return False  # drafting suppressed: the plain paths serve
        t_d0 = time.perf_counter()
        proposals = spec.propose_batch(
            [self._draft_context(a) for a in acts], ks)
        obs.record_span("engine.draft", t_d0, time.perf_counter(),
                        ctx=self._run_ctx)
        prop_of = {id(a): [int(t) for t in p][:k]
                   for a, p, k in zip(acts, proposals, ks)}
        if not any(prop_of.values()):
            return False  # nothing proposed: fall through (chain/step)
        victims: list[_Active] = []
        reserved = self._reserve_slots(
            running, pending, victims,
            k_for=lambda a: len(prop_of.get(id(a), ())) + 1,
        )
        if victims:
            self._cascade_preempt(victims, running, pending)
        if not reserved:
            return True  # every row preempted into pending; re-admit
        # token-packed verify arrays: row i owns packed positions
        # [i*C, i*C + nv_i), a static T = B*C; pad rows and tokens write
        # the null block and their ids are discarded
        C = spec.k + 1
        B = self.max_batch_size
        T = B * C
        NB = self.max_blocks_per_seq
        tokens = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        sb = np.zeros(T, np.int32)
        so = np.zeros(T, np.int32)
        row_tables = np.zeros((B, NB), np.int32)
        row_start = np.zeros(B, np.int32)
        row_nvalid = np.ones(B, np.int32)
        row_token_idx = np.zeros((B, C), np.int32)
        tok_row = np.zeros(T, np.int32)
        tok_col = np.zeros(T, np.int32)
        logit_idx = np.zeros(T, np.int32)
        rows: list[tuple[_Active, int, int]] = []
        for i, (act, slots) in enumerate(reserved):
            nv = len(slots)
            base = i * C
            seq = pool.sequence(act.seq_id)
            tokens[base:base + nv] = ([act.req.emitted[-1]]
                                      + prop_of.get(id(act), []))
            start = seq.n_tokens - nv  # extend_slots already advanced
            positions[base:base + nv] = np.arange(start, start + nv)
            for t, (blk, off) in enumerate(slots):
                sb[base + t] = blk
                so[base + t] = off
            row_tables[i, : len(seq.block_ids)] = seq.block_ids
            row_start[i] = start
            row_nvalid[i] = nv
            cols = np.minimum(np.arange(C), nv - 1)
            row_token_idx[i, :] = base + cols
            run = np.arange(base, base + nv)
            tok_row[run] = i
            tok_col[run] = np.arange(nv)
            logit_idx[base:base + C] = base + cols
            rows.append((act, i, nv))
        faults.fire("engine.dispatch.verify")
        t_disp = self._note_dispatch("verify")
        d = self._dev
        prog = self._verify_program()
        ids, _, _ = prog(
            self.params, *self._kv(pool), d(tokens), d(positions),
            d(row_tables), d(row_start), d(row_nvalid), d(row_token_idx),
            d(tok_row), d(tok_col), d(sb), d(so), d(logit_idx),
        )
        self._note_issued(len(rows))
        ids, t_sync1 = self._synced(ids)
        ms = (t_sync1 - t_disp) * 1e3
        self.rounds["verify"] += 1
        # packed position base+c holds the target's argmax after input
        # token c (c = 0: the row's last emitted token; c >= 1: draft
        # c-1).  Output c is the true greedy token iff every input before
        # it matched, so emit until the input feeding the next position
        # diverges; the first mismatch still yields one correct token
        n_proposed = sum(nv - 1 for _a, _r, nv in rows)
        n_accepted = n_emitted = 0
        done: list[_Active] = []
        for act, i, nv in rows:
            base = i * C
            req = act.req
            prop = prop_of.get(id(act), [])
            emitted_n = 0
            finished = False
            for c in range(nv):
                self._emit(req, int(ids[base + c]))
                emitted_n += 1
                if len(req.emitted) >= req.max_new or (
                        req.stop_token is not None
                        and req.emitted[-1] == req.stop_token):
                    finished = True
                    break
                if c < nv - 1 and prop[c] != int(ids[base + c]):
                    break  # draft refuted: later positions are phantom
            n_emitted += emitted_n
            n_accepted += emitted_n - 1
            # roll back the rejected tail NOW: the pool never holds
            # phantom K/V past the round
            if nv - emitted_n:
                pool.truncate_slots(act.seq_id, nv - emitted_n)
            obs.record_span("engine.verify", t_disp, t_sync1, ctx=req.ctx,
                            k=nv - 1, accepted=emitted_n - 1)
            # capacity is judged AFTER the rollback
            if finished or pool.sequence(
                    act.seq_id).n_tokens >= self.max_seq_tokens:
                done.append(act)
        prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1,
                             items=n_emitted)
        pool.kv_stats.record_spec(proposed=n_proposed, accepted=n_accepted,
                               emitted=n_emitted)
        for act in done:
            self._finish(act, running, deliver)
            # a finished stream is drafter training data
            spec.note_release(self._draft_context(act))
        spec.note_round(n_proposed, n_accepted, n_emitted, ms)
        return True

    def _can_chain(self, running, pending) -> bool:
        """Chain only when the queue is QUIET: nothing pending, no
        mid-prefill rows, and some row with >= 2 tokens of budget."""
        if self.chain_steps <= 1 or pending or not running:
            return False
        if any(a.tokens is not None for a in running):
            return False
        return self._chain_headroom(running) >= 2

    def _chain_headroom(self, running) -> int:
        return max(
            min(a.req.max_new - len(a.req.emitted),
                self.max_seq_tokens - self.pool.sequence(a.seq_id).n_tokens)
            for a in running
        )

    def _dispatch_chain(self, running, pending):
        """Pre-extend every decode row's table by its chain budget and
        dispatch ONE K-step chain (the sampled twin when any row
        samples).  Returns ``(acts, kreal, ids)`` with ``ids`` the
        un-synced [B, K] device tensor, or None when nothing could be
        reserved."""
        K = self.chain_steps
        pool = self.pool

        def k_for(act):
            seq = pool.sequence(act.seq_id)
            rem = min(act.req.max_new - len(act.req.emitted),
                      self.max_seq_tokens - seq.n_tokens)
            # short-budget rows still ride the chain: surplus steps write
            # the null block and their ids are truncated host-side
            return min(K, max(rem, 1))

        victims: list[_Active] = []
        reserved = self._reserve_slots(running, pending, victims, k_for=k_for)
        if victims:
            self._cascade_preempt(victims, running, pending)
        if not reserved:
            return None
        B = self.max_batch_size
        NB = self.max_blocks_per_seq
        token = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        sb = np.zeros((B, K), np.int32)
        so = np.zeros((B, K), np.int32)
        bt = np.zeros((B, NB), np.int32)
        acts, kreal = [], []
        for i, (act, slots) in enumerate(reserved):
            seq = pool.sequence(act.seq_id)
            token[i] = act.req.emitted[-1]
            # extend_slots already advanced n_tokens by len(slots)
            positions[i] = seq.n_tokens - len(slots)
            for t, (blk, off) in enumerate(slots):
                sb[i, t] = blk
                so[i, t] = off
            bt[i, : len(seq.block_ids)] = seq.block_ids
            acts.append(act)
            kreal.append(len(slots))
        # emit index of each row's step-0 token: a chain of K tokens
        # draws exactly what K single steps would
        samp = self._sampling_arrays([(i, a.req) for i, a in enumerate(acts)],
                                     B)
        args = (self.params, *self._kv(pool), self._dev(token),
                self._dev(positions), self._dev(bt), self._dev(sb),
                self._dev(so))
        faults.fire("engine.dispatch.chain")
        t_disp = self._note_dispatch("chain")
        if samp is None:
            prog = self._chained
            ids, _, _ = prog(*args)
        else:
            prog = self._sampled_programs()["chained"]
            ids, _, _ = prog(*args, *samp)
        self._note_issued(len(acts))
        self.rounds["chain"] += 1
        return acts, kreal, ids, t_disp, prog

    def _scan_chain(self, acts, kreal, ids_np, running
                    ) -> tuple[list[_Active], int]:
        """Truncating emit of one synced chain: each row's ids in order
        until EOS / max_new / capacity closes it (the per-step done rule,
        token by token).  Returns the finished rows and the number of
        tokens emitted."""
        done = []
        n_emitted = 0
        for i, act in enumerate(acts):
            if not any(a is act for a in running):
                continue  # preempted after dispatch; results are void
            req = act.req
            finished = False
            for t in range(kreal[i]):
                self._emit(req, int(ids_np[i, t]))
                n_emitted += 1
                if len(req.emitted) >= req.max_new or (
                        req.stop_token is not None
                        and req.emitted[-1] == req.stop_token):
                    finished = True
                    break
            if finished or self.pool.sequence(
                    act.seq_id).n_tokens >= self.max_seq_tokens:
                done.append(act)
        return done, n_emitted

    def _chained_rounds(self, running, pending, deliver, poll, stop) -> bool:
        """Chains back to back: each iteration dispatches chain N+1 (its
        input is chain N's last emitted id) BEFORE delivering chain N's
        finished requests, and returns to the per-step path as soon as an
        arrival, a preemption or a lack of headroom disturbs the quiet
        window.  With a drafter armed the chain is the fallback: one
        dispatch, then every round is offered to the drafter again."""
        inflight = self._dispatch_chain(running, pending)
        if inflight is None:
            return False
        while True:
            self._admit_arrivals(running, pending, poll, stop)
            acts, kreal, ids_dev, t_disp, prog = inflight
            # ONE sync per K-token chain; it passes chain N's events (and
            # not chain N+1's, which is dispatched after it)
            ids_np, t_sync1 = self._synced(ids_dev)
            for i, act in enumerate(acts):
                obs.record_span("engine.chain", t_disp, t_sync1,
                                ctx=act.req.ctx, k=kreal[i])
            done, n_emitted = self._scan_chain(acts, kreal, ids_np, running)
            prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1,
                                 items=n_emitted)
            for act in done:
                running.remove(act)
                self._release_seq(act)
            nxt = None
            if (running and not pending and self._spec is None
                    and self._chain_headroom(running) >= 2):
                try:
                    nxt = self._dispatch_chain(running, pending)
                except BaseException:
                    for act in done:  # finished rows left `running` already
                        deliver(act.req)
                    raise
            for act in done:
                deliver(act.req)
            self.pool.kv_stats.record_chain(
                steps=self.chain_steps, slots=len(acts) * self.chain_steps,
                emitted=n_emitted)
            if nxt is None:
                return True
            inflight = nxt

    def _decode_round(self, reserved, running, deliver) -> None:
        B = self.max_batch_size
        NB = self.max_blocks_per_seq
        token = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        sb = np.zeros(B, np.int32)
        so = np.zeros(B, np.int32)
        bt = np.zeros((B, NB), np.int32)
        for i, (act, slots) in enumerate(reserved):
            seq = self.pool.sequence(act.seq_id)
            token[i] = act.req.emitted[-1]
            positions[i] = seq.n_tokens - 1  # append_slot already advanced
            sb[i], so[i] = slots[0]
            bt[i, : len(seq.block_ids)] = seq.block_ids
        samp = self._sampling_arrays(
            [(i, act.req) for i, (act, _s) in enumerate(reserved)], B)
        args = (self.params, *self._kv(self.pool),
                self._dev(token), self._dev(positions), self._dev(bt),
                self._dev(sb), self._dev(so))
        faults.fire("engine.dispatch.step")
        t_disp = self._note_dispatch("step")
        if samp is None:
            prog = self._step
            ids, _, _ = prog(*args)
        else:
            prog = self._sampled_programs()["step"]
            ids, _, _ = prog(*args, *samp)
        self._note_issued(len(reserved))
        ids, t_sync1 = self._synced(ids)
        prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1,
                             items=len(reserved))
        self.rounds["decode"] += 1
        for act, _slot in reserved:
            obs.record_span("engine.decode_step", t_disp, t_sync1,
                            ctx=act.req.ctx)
        # a per-step round is a K=1 chain in the chain histogram
        self.pool.kv_stats.record_chain(steps=1, slots=len(reserved),
                                     emitted=len(reserved))
        for i, (act, _slot) in enumerate(reserved):
            self._emit(act.req, int(ids[i]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _mixed_round(self, reserved, chunks, running, deliver) -> None:
        """The ragged fused step over a token-PACKED stream: decode rows
        one token each, chunk rows a run of prompt tokens, sharing the
        ``mixed_tokens`` budget."""
        B = self.max_batch_size
        C = self.prefill_chunk
        T = self.mixed_tokens
        NB = self.max_blocks_per_seq
        bs = self.pool.block_size
        tokens = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        sb = np.zeros(T, np.int32)
        so = np.zeros(T, np.int32)
        row_tables = np.zeros((B, NB), np.int32)
        row_start = np.zeros(B, np.int32)
        row_nvalid = np.ones(B, np.int32)
        row_token_idx = np.zeros((B, C), np.int32)
        tok_row = np.zeros(T, np.int32)
        tok_col = np.zeros(T, np.int32)
        logit_idx = np.zeros(B, np.int32)
        rows: list[tuple[_Active, int, int]] = []  # (act, row, filled|-1)
        t = 0
        row = 0
        for act, slots in reserved:
            seq = self.pool.sequence(act.seq_id)
            tokens[t] = act.req.emitted[-1]
            positions[t] = seq.n_tokens - 1  # append_slot already advanced
            sb[t], so[t] = slots[0]
            row_tables[row, : len(seq.block_ids)] = seq.block_ids
            row_start[row] = positions[t]
            row_token_idx[row, :] = t  # one valid column
            tok_row[t] = row
            logit_idx[row] = t
            rows.append((act, row, -1))
            t += 1
            row += 1
        proj: dict[int, int] = {}  # this round's projected n_filled
        for act in chunks:
            budget = T - t
            if budget <= 0 or row >= B:
                break  # later chunks wait a round (FIFO)
            seq = self.pool.sequence(act.seq_id)
            s = act.n_filled
            e = min(s + C, len(act.tokens), s + budget)
            w = act.wait_writer
            if w is not None:
                if w.tokens is None:
                    act.wait_writer = None  # the writer finished
                else:
                    # our queries up to e read the shared region below
                    # min(e, n_diverted); the writer must have written it
                    # by THIS dispatch (same-round writes land first)
                    wp = proj.get(id(w), w.n_filled)
                    if min(e, act.n_diverted) > wp:
                        e = min(e, wp)
                    if e <= s:
                        continue  # the writer lags: wait a round
            nv = e - s
            pos = np.arange(s, e)
            tokens[t:t + nv] = act.tokens[s:e]
            positions[t:t + nv] = pos
            blocks = np.asarray(seq.block_ids, np.int32)
            # prefix-shared blocks already hold the right K/V: divert
            # their writes to the null block (a live sequence may be
            # reading them); the gather still reads them via the table
            sb[t:t + nv] = np.where(pos < act.n_diverted, 0,
                                    blocks[pos // bs])
            so[t:t + nv] = pos % bs
            row_tables[row, : len(seq.block_ids)] = seq.block_ids
            row_start[row] = s
            row_nvalid[row] = nv
            run = np.arange(t, t + nv)
            row_token_idx[row, :nv] = run
            row_token_idx[row, nv:] = t + nv - 1  # pad columns: masked
            tok_row[run] = row
            tok_col[run] = np.arange(nv)
            logit_idx[row] = t + nv - 1
            rows.append((act, row, e))
            proj[id(act)] = e
            t += nv
            row += 1
        if not rows:
            raise RuntimeError(
                "ragged step produced no rows (gated chunk cycle?)"
            )
        # sampling rides per ROW, for the rows that emit this round: the
        # decode rows and the chunk rows whose prompt completes (drawing
        # at len(emitted)); a mid-prefill row's draw would be discarded,
        # so a round in which only such rows sample runs the greedy program
        samp = self._sampling_arrays(
            [(r, act.req) for act, r, f in rows
             if f < 0 or f == len(act.tokens)], B)
        d = self._dev
        args = (self.params, *self._kv(self.pool), d(tokens),
                d(positions), d(row_tables), d(row_start), d(row_nvalid),
                d(row_token_idx), d(tok_row), d(tok_col), d(sb), d(so),
                d(logit_idx))
        faults.fire("engine.dispatch.mixed")
        t_disp = self._note_dispatch("mixed")
        if samp is None:
            prog = self._mixed
            ids, _, _ = prog(*args)
        else:
            prog = self._sampled_programs()["mixed"]
            ids, _, _ = prog(*args, *samp)
        self._note_issued(len(rows))
        ids, t_sync1 = self._synced(ids)
        prog.record_dispatch(t_sync1 - t_disp, t_end=t_sync1, items=t)
        self.rounds["mixed"] += 1
        self._note_mixed(rows, t_disp, t_sync1)
        for act, row, filled in rows:
            if filled >= 0:
                act.n_filled = filled
                if filled < len(act.tokens):
                    continue  # mid-prefill: this row's logits are garbage
                # prefill complete: register the prompt's full blocks for
                # sharing now that their K/V is written
                if self.prefix is not None and act.prefix_keys:
                    self.prefix.insert(
                        act.prefix_keys,
                        self.pool.sequence(act.seq_id).block_ids,
                    )
                self._drop_inflight_keys(act)
                act.tokens = None
                act.prefix_keys = None
            self._emit(act.req, int(ids[row]))
            if self._is_done(act.req, act.seq_id):
                self._finish(act, running, deliver)

    def _note_mixed(self, rows, t_disp: float, t_sync1: float) -> None:
        """A mixed round's counters and spans: decode rows are a K=1
        entry in the chain histogram; each row rides the dispatch as an
        ``engine.decode_step`` or an ``engine.prefill_chunk`` span (the
        chunk's [start, end) prompt positions) on its request's trace."""
        self.pool.kv_stats.record_mixed_step(len(rows))
        n_decode = sum(1 for _a, _r, f in rows if f < 0)
        if n_decode:
            self.pool.kv_stats.record_chain(steps=1, slots=n_decode,
                                         emitted=n_decode)
        self.pool.kv_stats.record_prefill_chunks(len(rows) - n_decode)
        for act, _row, filled in rows:
            if filled < 0:
                obs.record_span("engine.decode_step", t_disp, t_sync1,
                                ctx=act.req.ctx)
            else:
                obs.record_span("engine.prefill_chunk", t_disp, t_sync1,
                                ctx=act.req.ctx, start=act.n_filled,
                                end=filled)

    def _drop_inflight_keys(self, act: _Active) -> None:
        if self._inflight_prefix:
            self._inflight_prefix = {
                k: v for k, v in self._inflight_prefix.items()
                if v[0] is not act
            }

    def _cascade_preempt(self, victims, running, pending) -> None:
        """A preempted mid-prefill writer strands every sharer whose
        shared region it had not finished writing: requeue those for
        recompute too (transitively)."""
        queue_ = list(victims)
        while queue_:
            w = queue_.pop()
            self._drop_inflight_keys(w)
            for act in list(running):
                if act.wait_writer is not w:
                    continue
                if w.tokens is None or w.n_filled >= act.n_diverted \
                        or act.tokens is None:
                    act.wait_writer = None  # region fully written
                else:
                    running.remove(act)
                    self.pool.free_sequence(act.seq_id)
                    self._requeue(pending, act.req)
                    queue_.append(act)

    def _reserve_slots(self, running, pending, victims=None, k_for=None
                       ) -> list[tuple[_Active, list[tuple[int, int]]]]:
        """Reserve write slots per running DECODE sequence, resolving pool
        exhaustion by prefix eviction first, preemption second (victims
        come only from rows not yet reserved this round).  ``k_for(act)``
        gives each row's slot count (default 1), reserved atomically."""
        reserved: list[tuple[_Active, list[tuple[int, int]]]] = []
        survivors = list(running)
        idx = 0
        while idx < len(survivors):
            act = survivors[idx]
            if act.tokens is not None:
                idx += 1  # mid-prefill: no decode slot this round
                continue
            try:
                slots = self.pool.extend_slots(
                    act.seq_id, k_for(act) if k_for is not None else 1
                )
            except PoolExhausted as exc:
                if self.prefix is not None and self.prefix.evict(
                        max(exc.needed - exc.free, 1)) > 0:
                    continue
                # a sequence whose re-admission would have to truncate
                # (breaking token identity) is preempt-immune
                bucket_cap = self.seq_buckets[-1]
                exclude = {a.seq_id for a, _ in reserved} | {
                    a.seq_id for a in survivors
                    if self._readmit_len(a.req) > bucket_cap
                }
                victim = self.pool.preempt(exclude=exclude)
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with nothing left to preempt; "
                        "increase num_blocks"
                    )
                vact = next(
                    (a for a in survivors if a.seq_id == victim.seq_id), None
                )
                if vact is None:
                    continue  # a stray registered through direct pool use
                survivors.remove(vact)
                running.remove(vact)
                if victims is not None:
                    victims.append(vact)
                # recompute re-admission over prompt + emitted
                self._requeue(pending, vact.req)
                continue
            reserved.append((act, slots))
            idx += 1
        return reserved


__all__ = ["EngineHungError", "PagedDecodeEngine"]
