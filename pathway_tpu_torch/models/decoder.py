"""Causal decoder LM — the generation model of the RAG path (greedy, or
sampled on the paged and SSD paths; f32/bf16 or int8-resident weights in
the decode plan; tensor-parallel over a ``parallel/mesh.TPMesh``).

Plain functions on the JAX package's parameter-dict layout, so the same
weights run in both (``models/convert.py``).  Attention on the paged
path goes through ``kvcache/paged_attention.py``, the dense prefill's
(``flash``) through ``ops/attention_cuda.py``: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors.  The paged steps update the
pools IN PLACE (the JAX package returns new, donated arrays) and return
them for symmetry with the JAX signatures.

The paged steps take a ``head_fn`` hook in place of the vocab head (the
JAX package's ``head_fn=``): the ``*_sampled`` programs pass the sampling
head (:func:`_sampling_head`), which draws each row's token on the device
from a key that is a pure function of the request's seed and the token's
emit index (``models/prng.py``).

``plan_decode_params(quantize="int8")`` quantizes the plan's matmul
weights per output channel; the products widen the int8 weight to the
compute dtype and scale the result (plain ``torch.matmul``: in the JAX
package too this is XLA, not a Pallas kernel).  The ``ssd_*`` programs
are the constant-memory linear-attention family the state cache serves
(``kvcache/statecache.py``).

Each step program is written once, as a per-shard body: a generator that
``yield``s where the JAX body calls ``lax.psum``/``lax.all_gather``
(``_embed_rows``, ``_row_proj``, the vocab heads).  With no shard a body
issues no collective and the public function runs it to its end
(``parallel/mesh.run_single``): the tp = 1 programs are the
single-device math.  The ``*_tp`` programs run the same bodies once per
shard of a mesh in lockstep (``TPMesh.spmd``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device, resolve_dtype
from ..obs.profiler import profiled
from ..ops.attention_cuda import flash_attention
from ..parallel.mesh import run_single, shard_all_gather, shard_psum
from . import prng
from .encoder import (EncoderConfig, _act, _layer_norm, _proj, init_params,
                      params_to)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 1024
    dtype: Any = "auto"  # bf16 on the card, f32 on the CPU
    ln_eps: float = 1e-6
    act: str = "gelu_tanh"  # gelu (exact erf) | gelu_tanh | relu

    def as_encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads, d_ff=self.d_ff,
            max_len=self.max_len, dtype=self.dtype,
        )


def init_decoder_params(cfg: DecoderConfig, seed: int = 0,
                        device="cuda") -> dict:
    return init_params(cfg.as_encoder_cfg(), seed, device)


def _act_fn(cfg):
    return _act(cfg.act)


def _embed_rows(embed, tokens, shard=None):
    """Tied-embedding lookup (a per-shard body's generator: ``x = yield
    from _embed_rows(...)``).  Under a shard the table holds its vocab
    slice: each token's row lives on exactly one shard, the others give
    zeros, and the psum of one exact row plus zeros is exact, so the
    sharded lookup is bit-identical to the replicated one."""
    if shard is None:
        return embed[tokens]
    v_loc = embed.shape[0]
    local = tokens - shard.index * v_loc
    ok = (local >= 0) & (local < v_loc)
    rows = embed[torch.clamp(local, 0, v_loc - 1)].masked_fill(
        ~ok[..., None], 0)
    return (yield from shard_psum(rows, shard))


def _mm_p(layer, x, w_name: str):
    """``x @ layer[w_name]``, or, when the decode plan carries the int8
    ``{w}_q``/``{w}_s`` pair instead, ``(x @ q) * s``: the int8 weight
    widened to the compute dtype on read and the per-output-channel scale
    applied to the product in the compute dtype (the JAX package's rule;
    XLA fuses that convert into the gemm's operand load, here it is a
    plain cast before ``matmul``)."""
    q = layer.get(w_name + "_q")
    if q is None:
        return x @ layer[w_name].to(x.dtype)
    y = x @ q.to(x.dtype)
    return y * layer[w_name + "_s"].to(y.dtype)


def _proj_p(layer, x, w_name: str, b_name: str):
    """encoder._proj, decode-plan-aware (the int8 ``{w}_q`` pair honoured)."""
    out = _mm_p(layer, x, w_name)
    b = layer.get(b_name)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _row_proj(layer, x, w_name: str, b_name: str, shard=None):
    """Row-parallel projection (a generator): under a shard the
    contraction is split over the shards, so the partial products are
    psum'd BEFORE the replicated bias is added, once.  With no shard it
    is :func:`_proj_p`.  An int8 plan's per-output-channel scale is the
    same on every shard, so scaling the partials before the psum equals
    scaling the sum."""
    out = yield from shard_psum(_mm_p(layer, x, w_name), shard)
    b = layer.get(b_name)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _qkv_proj(layer, x):
    """Q/K/V: ONE fused gemm against the decode plan's ``wqkv`` (or int8
    ``wqkv_q``) leaf when present, else the three separate gemms.  A
    sharded plan's ``wqkv`` columns are laid out per shard
    (:func:`_fuse_cols`), so a shard's slice splits three ways into its
    own heads' q, k and v."""
    if "wqkv" in layer or "wqkv_q" in layer:
        return _proj_p(layer, x, "wqkv", "bqkv").chunk(3, dim=-1)
    return (_proj(layer, x, "wq", "bq"), _proj(layer, x, "wk", "bk"),
            _proj(layer, x, "wv", "bv"))


def _head_weight(params):
    """The vocab-head operand: the plan's pre-transposed [D, V]
    ``embed_t`` as a ``(w, scales | None)`` tuple (orientation explicit,
    never shape-guessed; int8 ``embed_t_q`` with its scales), or the raw
    tied [V, D] table."""
    if "embed_t_q" in params:
        return (params["embed_t_q"], params["embed_t_s"])
    if "embed_t" in params:
        return (params["embed_t"], None)
    return params["embed"]


def _head_logits(head_w, x):
    """(B, D) -> (B, V) f32 logits for the tied-embedding head ((B, V/tp)
    on a shard).  An int8 head's scales multiply the f32 logits (the
    layers' products take theirs in the compute dtype)."""
    if isinstance(head_w, tuple):
        w, s = head_w
        logits = (x @ w.to(x.dtype)).float()
        return logits if s is None else logits * s.float()
    return (x @ head_w.to(x.dtype).T).float()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab; ties go to the smallest id (torch.argmax
    returns the first maximal index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _head_out(head_w, x, shard=None):
    """The default vocab head (a generator).  With no shard: the (B, V)
    f32 logits, which the caller samples.  Under a shard the greedy
    choice is fused in as an exact two-stage argmax: each shard argmaxes
    its (B, V/tp) slice, and only the (value, global index) pairs cross
    shards; the largest value wins and, among equal values, the smallest
    global index, so the result is the argmax of the full row.  Returns
    (B,) int32 ids then."""
    logits = _head_logits(head_w, x)
    if shard is None:
        return logits
    v_loc = logits.shape[-1]
    loc = torch.argmax(logits, dim=-1)
    val = logits.gather(-1, loc[:, None])[:, 0]
    gidx = loc + shard.index * v_loc
    vals = yield from shard_all_gather(val[None], shard)    # (tp, B)
    idxs = yield from shard_all_gather(gidx[None], shard)   # (tp, B)
    best = vals.max(dim=0).values
    cand = torch.where(vals == best[None], idxs,
                       torch.full_like(idxs, torch.iinfo(idxs.dtype).max))
    return cand.min(dim=0).values.to(torch.int32)


def _greedy_head(head_w, x, shard=None):
    """The vocab head fused with its argmax: (B, D) -> (B,) int32 ids."""
    if shard is None:
        return greedy(_head_logits(head_w, x))
    return (yield from _head_out(head_w, x, shard))


# -- device-side sampling ---------------------------------------------------
#
# The sampled programs thread per-row (temperature, top_k, top_p, seed,
# emit index) through the SAME step math as the greedy ones; only the
# vocab head changes.  temperature <= 0 rows return the greedy argmax
# exactly (a torch.where, not a numerical limit), and a row's n-th token
# is drawn from fold_in(fold_in(prng_key(0), seed), n) alone, so
# preemption-recompute, restart and speculation replay it bit for bit.


def _seed_keys(seed: torch.Tensor) -> torch.Tensor:
    """Per-row base keys ``fold_in(prng_key(0), seed)``: (B,) -> (B, 2)."""
    return prng.fold_in(prng.prng_key(0, seed.device), seed)


def _row_sample_keys(seed: torch.Tensor, emit_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Per-row keys of the ``emit_idx``-th token of requests seeded by
    ``seed``: (B,) ints -> (B, 2) int64 uint32 words."""
    return prng.fold_in(_seed_keys(seed), emit_idx)


def _nucleus(logits: torch.Tensor, temperature: torch.Tensor,
             top_k: torch.Tensor, top_p: torch.Tensor):
    """The sort and masks of :func:`_sample_rows`: ``(order, scaled,
    keep)`` with ``order`` the stable descending sort of each row (ties
    keep the smallest id first), ``scaled`` the sorted logits over the
    temperature and ``keep`` the top-k ranks AND the top-p nucleus
    (exclusive prefix mass < top_p), rank 0 always kept.  ``top_k <= 0``
    disables its mask; ``top_p = 1.0`` keeps every token whose f32
    exclusive prefix mass stays below 1 (the JAX formula: a far tail whose
    prefix sum rounds to 1 is dropped)."""
    V = logits.shape[-1]
    neg_sorted, order = torch.sort(-logits, dim=-1, stable=True)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = -neg_sorted / temp
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(V, device=logits.device)[None, :]
    k = top_k.to(torch.int64).masked_fill(top_k <= 0, V)[:, None]
    keep = (ranks < k) & ((cum - probs) < top_p.float()[:, None])
    keep[:, 0].fill_(True)
    return order, scaled, keep


def _sample_rows(logits: torch.Tensor, greedy_ids: torch.Tensor,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Row-wise temperature/top-k/top-p sampling over (B, V) f32 logits:
    Gumbel-argmax over the kept, temperature-scaled logits
    (:func:`_nucleus`), with ``keys`` (B, 2) the rows' PRNG keys.
    temperature <= 0 rows return ``greedy_ids`` exactly.  Returns (B,)
    int32."""
    order, scaled, keep = _nucleus(logits, temperature, top_k, top_p)
    noisy = torch.where(keep, scaled + prng.gumbel(keys, logits.shape[-1]),
                        torch.full_like(scaled, float("-inf")))
    choice = order.gather(-1, torch.argmax(noisy, dim=-1)[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy_ids,
                       choice.to(torch.int32))


def _sampling_head(temperature, top_k, top_p, keys):
    """A vocab-head override (the ``head_fn`` hook of the paged steps)
    that samples instead of argmaxing; returns (B,) int32 ids.  Under a
    shard the (B, V/tp) logits slices are gathered back to full rows
    first (the draw must see the whole nucleus); a temperature-0 row
    takes the argmax of the gathered row, the two-stage argmax's id."""

    def head(head_w, x, shard=None):
        logits = _head_logits(head_w, x)
        logits = yield from shard_all_gather(logits, shard, 1)
        return _sample_rows(logits, greedy(logits), temperature, top_k,
                            top_p, keys)

    return head


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of a [In, Out]
    matmul weight, computed in f32: ``s[o] = amax(|w[:, o]|) / 127`` (1
    for an all-zero column, so its round trip stays exact) and ``q =
    clip(round(w / s), -127, 127)``.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so ``q`` and ``s`` equal the JAX
    package's bit for bit.  Returns ``(q int8, s f32)``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from IEEE division
    # (the JAX package's, and the CPU's) in the last bit
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


def int8_device_native(native: bool | None = None,
                       device: torch.device | str = "cuda") -> bool:
    """Whether an int8 plan keeps its weights RESIDENT in int8.  Auto
    (None): on the card (the JAX package's "native on TPU"); on the CPU
    the plan keeps int8 numerics (quantize, then scale back) but
    pre-applies the dequant at build time and runs float products."""
    if native is not None:
        return bool(native)
    return torch.device(device).type == "cuda"


def _plan_quantize(name: str, w: torch.Tensor, out: dict, native: bool):
    q, s = quantize_weight_int8(w)
    if native:
        out[name + "_q"] = q
        out[name + "_s"] = s
    else:
        out[name] = (q.float() * s).to(w.dtype)


def _fuse_cols(ws, tp: int):
    """Concatenate column-parallel leaves along their output axis, laid
    out per tp shard: shard s's contiguous slice is ``[ws[0]_s | ws[1]_s
    | ...]``, so splitting the fused axis over tp hands each shard the
    fusion of its own unfused slices (tp = 1: a plain concatenation)."""
    if tp <= 1:
        return torch.cat(ws, dim=-1)
    parts = [w.chunk(tp, dim=-1) for w in ws]
    return torch.cat([p[s] for s in range(tp) for p in parts], dim=-1)


def plan_decode_params(cfg: DecoderConfig, params: dict, *, tp: int = 1,
                       quantize: str | None = None,
                       native: bool | None = None) -> dict:
    """The fused decode plan the paged engine dispatches with: Q/K/V
    folded into one [D, 3D] ``wqkv`` per layer (columns laid out per tp
    shard, :func:`_fuse_cols`, so the leaf shards column-parallel), and
    the tied head pre-materialized as [D, V] ``embed_t`` (always: the JAX
    package materializes it everywhere but on the TPU).  Both are exact,
    so the f32 plan is token-identical to the raw parameters.

    ``quantize="int8"`` also quantizes every matmul weight (``wqkv``,
    ``wo``, ``w_up``, ``w_down``, ``embed_t``) per output channel
    (:func:`quantize_weight_int8`); ``native`` (default: by the params'
    device, :func:`int8_device_native`) keeps them as int8 ``{w}_q``
    leaves with f32 ``{w}_s`` scales, or pre-applies ``q * s``.  The
    embedding LOOKUP table stays as it is either way: one row per token
    is read, so quantizing it saves nothing."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r} is not None or 'int8'")
    int8 = quantize == "int8"
    native = (int8_device_native(native, params["embed"].device) if int8
              else False)
    plan = {k: v for k, v in params.items() if k != "layers"}
    et = params["embed"].T.contiguous()
    if int8:
        _plan_quantize("embed_t", et, plan, native)
    else:
        plan["embed_t"] = et
    layers = []
    for layer in params["layers"]:
        new = {k: v for k, v in layer.items()
               if k not in ("wq", "wk", "wv", "bq", "bk", "bv")}
        wqkv = _fuse_cols([layer["wq"], layer["wk"], layer["wv"]], tp)
        if layer.get("bq") is not None:
            new["bqkv"] = _fuse_cols([layer["bq"], layer["bk"], layer["bv"]],
                                     tp)
        if int8:
            _plan_quantize("wqkv", wqkv, new, native)
            for w_name in ("wo", "w_up", "w_down"):
                if w_name in new:
                    _plan_quantize(w_name, new.pop(w_name), new, native)
        else:
            new["wqkv"] = wqkv
        layers.append(new)
    plan["layers"] = layers
    return plan


def _prefill_body(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
                  n_valid: torch.Tensor, flash, head_fn, shard):
    """:func:`prefill`'s per-shard body (a generator; see
    ``parallel/mesh.py``): under a shard it runs the shard's H/tp heads
    and vocab slice, with one psum per row-parallel projection."""
    dtype = resolve_dtype(cfg.dtype, token_ids.device)
    B, T = token_ids.shape
    hd = cfg.d_model // cfg.n_heads
    if flash is None:
        flash = token_ids.device.type == "cuda" and T >= 256
    x = yield from _embed_rows(params["embed"].to(dtype), token_ids, shard)
    x = x + params["pos_embed"].to(dtype)[:T][None, :, :]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    if not flash:
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=token_ids.device))
    cache = []
    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        q, k, v = _qkv_proj(layer, h)
        q = q.reshape(B, T, -1, hd)
        k = k.reshape(B, T, -1, hd)
        v = v.reshape(B, T, -1, hd)
        cache.append({"k": k, "v": v})
        if flash:
            a = flash_attention(q, k, v, causal=True).reshape(B, T, -1)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            scores = scores.masked_fill(~causal[None, None], -1e9)
            probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
            a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, -1)
        x = x + (yield from _row_proj(layer, a, "wo", "bo", shard))
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + (yield from _row_proj(layer, ff, "w_down", "b_down", shard))
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    last = x[torch.arange(B, device=x.device), n_valid.long() - 1]
    head = _head_out if head_fn is None else head_fn
    out = yield from head(_head_weight(params), last, shard)
    return out, cache


def prefill(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
            n_valid: torch.Tensor, *, flash: bool | None = None,
            head_fn=None):
    """Dense full-context forward over the (padded) prompt: returns the
    logits at position ``n_valid - 1`` and the per-layer K/V cache
    (``{"k", "v"}`` of shape (B, T, H, hd)).

    ``flash`` routes attention through ``ops/attention_cuda.
    flash_attention`` (the CUDA kernel on the card, reading the fused QKV
    product's q/k/v views in place); default: on the card for T >= 256,
    as the JAX package defaults to its Pallas kernel on the TPU.
    ``flash=False`` is the plain einsum path, the in-port identity
    oracle.  ``head_fn(head_w, x, shard)`` replaces the vocab head
    (default :func:`_head_out`, f32 logits)."""
    return run_single(_prefill_body(params, cfg, token_ids, n_valid, flash,
                                    head_fn, None))


def decode_step(params: dict, cfg: DecoderConfig, cache: list[dict],
                token: torch.Tensor, pos: int):
    """One incremental token: (B,) ids at position ``pos`` -> (B, V)
    logits; the dense cache is updated in place at ``pos`` and returned.
    Attention reads the cache rows <= pos only.  ``pos`` is an int or a
    0-dim tensor on the device (the fused loop keeps it there)."""
    dtype = resolve_dtype(cfg.dtype, token.device)
    B = token.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    T = cache[0]["k"].shape[1]
    x = params["embed"].to(dtype)[token][:, None, :]  # (B, 1, D)
    x = x + params["pos_embed"].to(dtype)[pos][None, None, :]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    valid = (torch.arange(T, device=token.device) <= pos)[None, None, None, :]
    for layer, kv in zip(params["layers"], cache):
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        q, k1, v1 = _qkv_proj(layer, h)
        kv["k"][:, pos] = k1.reshape(B, H, hd)
        kv["v"][:, pos] = v1.reshape(B, H, hd)
        q = q.reshape(B, 1, H, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kv["k"]) / math.sqrt(hd)
        scores = scores.masked_fill(~valid, -1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, kv["v"]).reshape(
            B, 1, cfg.d_model)
        x = x + _proj_p(layer, a, "wo", "bo")
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + _proj_p(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return _head_logits(_head_weight(params), x[:, 0, :]), cache


def generate_tokens_fused(params: dict, cfg: DecoderConfig,
                          token_ids: torch.Tensor, n_valid: torch.Tensor,
                          max_new: int, stop_token: int | None):
    """Prefill + the whole greedy decode loop with no host sync per token
    (the JAX package's one-program ``lax.while_loop``).  Returns device
    tensors ``(out (B, max_new) int32, n_steps int32)`` for the caller to
    fetch once.

    The loop's exit — every row done (its stop token emitted) or the
    cache full (``pos == L``) — is computed on the device: the host
    issues all ``max_new - 1`` steps, and a step past the exit neither
    writes ``out`` (its columns stay 0, as in the JAX package) nor counts
    in ``n_steps``; its position is clamped inside the cache.  All rows
    share the prompt length, as the JAX package's host wrapper asserts."""
    B, L = token_ids.shape
    dev = token_ids.device
    logits, cache = prefill(params, cfg, token_ids, n_valid)
    tok = greedy(logits)
    out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out[:, 0] = tok
    if stop_token is not None:
        done = tok == stop_token
    else:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = n_valid.to(dev).max().long()
    n_steps = torch.ones((), dtype=torch.int32, device=dev)
    for step in range(1, max_new):
        live = ~done.all() & (pos < L)
        logits, cache = decode_step(params, cfg, cache, tok,
                                    torch.clamp(pos, max=L - 1))
        tok = greedy(logits)
        out[:, step] = torch.where(live, tok, out[:, step])
        if stop_token is not None:
            done = done | (live & (tok == stop_token))
        n_steps += live
        pos = pos + 1
    return out, n_steps


def _paged_prefill_body(params, cfg, token_ids, n_valid, k_pool, v_pool,
                        block_tables, flash, head_fn, shard):
    logits, cache = yield from _prefill_body(params, cfg, token_ids, n_valid,
                                             flash, head_fn, shard)
    B, T = token_ids.shape
    BS, H, hd = k_pool.shape[2:]  # H: the shard's heads
    bt = block_tables.long()
    for li, kv in enumerate(cache):
        k_pool[li][bt] = kv["k"].reshape(B, T // BS, BS, H, hd)
        v_pool[li][bt] = kv["v"].reshape(B, T // BS, BS, H, hd)
    return logits, k_pool, v_pool


def paged_prefill(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
                  n_valid: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_tables: torch.Tensor, *,
                  flash: bool | None = None, head_fn=None):
    """Prefill through the paged KV cache: the dense :func:`prefill` (so
    the prompt's logits are those of the dense path), then each layer's
    K/V scattered into the pool blocks ``block_tables`` names, IN PLACE.

    token_ids: (B, T), T a multiple of the pool's block size; pools
    (n_layers, num_blocks, block_size, H, hd); block_tables (B, T //
    block_size) int, padded with the null block 0 — padding rows write
    there, and block 0 is never read.  Returns ``(logits, k_pool,
    v_pool)`` (``head_fn``'s result in place of the logits when given).
    """
    return run_single(_paged_prefill_body(
        params, cfg, token_ids, n_valid, k_pool, v_pool, block_tables, flash,
        head_fn, None))


def _paged_decode_body(params, cfg, k_pool, v_pool, token, positions,
                       block_tables, slot_blocks, slot_offsets, head_fn,
                       shard):
    from ..kvcache.paged_attention import append_attend_fn

    dtype = resolve_dtype(cfg.dtype, token.device)
    B = token.shape[0]
    hd = cfg.d_model // cfg.n_heads
    x = yield from _embed_rows(params["embed"].to(dtype), token, shard)
    x = x[:, None, :] + params["pos_embed"].to(dtype)[positions][:, None, :]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    attend = append_attend_fn(block_tables, positions + 1, slot_blocks,
                              slot_offsets, token.device)
    for li, layer in enumerate(params["layers"]):
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        q, k1, v1 = _qkv_proj(layer, h)
        q = q.reshape(B, 1, -1, hd)
        a = attend(q, k1.reshape(B, -1, hd), v1.reshape(B, -1, hd),
                   k_pool[li], v_pool[li])
        x = x + (yield from _row_proj(layer, a.reshape(B, 1, -1), "wo", "bo",
                                      shard))
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + (yield from _row_proj(layer, ff, "w_down", "b_down", shard))
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    head = _head_out if head_fn is None else head_fn
    out = yield from head(_head_weight(params), x[:, 0, :], shard)
    return out, k_pool, v_pool


def paged_decode_step(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                      token, positions, block_tables, slot_blocks,
                      slot_offsets, *, head_fn=None):
    """One batched incremental token through the paged cache: each row's
    K/V lands at ``(slot_blocks[b], slot_offsets[b])`` and attention
    reads back through ``block_tables`` masked to ``positions + 1``
    tokens — the fused append+attend op (the kernel on the card).

    token/positions/slot_blocks/slot_offsets: (B,) int;
    block_tables: (B, NB) int.  Returns ``(logits, k_pool, v_pool)``
    (``head_fn``'s result in place of the logits when given)."""
    return run_single(_paged_decode_body(
        params, cfg, k_pool, v_pool, token, positions, block_tables,
        slot_blocks, slot_offsets, head_fn, None))


def _paged_mixed_body(params, cfg, k_pool, v_pool, tokens, positions,
                      row_tables, row_start, row_nvalid, row_token_idx,
                      tok_row, tok_col, slot_blocks, slot_offsets, logit_idx,
                      head_fn, shard):
    from ..kvcache.paged_attention import paged_attention_fn

    dtype = resolve_dtype(cfg.dtype, tokens.device)
    T = tokens.shape[0]
    hd = cfg.d_model // cfg.n_heads
    # clamp so a caller bug cannot index past the position table
    pos = torch.clamp(positions, max=cfg.max_len - 1)
    x = yield from _embed_rows(params["embed"].to(dtype), tokens, shard)
    x = x + params["pos_embed"].to(dtype)[pos]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    sb = slot_blocks.long()
    so = slot_offsets.long()
    attend = paged_attention_fn(row_token_idx.shape[1], row_tables,
                                start_pos=row_start, n_valid=row_nvalid,
                                device=tokens.device)
    for li, layer in enumerate(params["layers"]):
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        q, k1, v1 = _qkv_proj(layer, h)
        q = q.reshape(T, -1, hd)
        k_pool[li][sb, so] = k1.reshape(T, -1, hd)
        v_pool[li][sb, so] = v1.reshape(T, -1, hd)
        a_rows = attend(q[row_token_idx], k_pool[li], v_pool[li])
        a = a_rows[tok_row, tok_col]  # back to the packed (T, H, hd)
        x = x + (yield from _row_proj(layer, a.reshape(T, -1), "wo", "bo",
                                      shard))
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + (yield from _row_proj(layer, ff, "w_down", "b_down", shard))
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    head = _head_out if head_fn is None else head_fn
    out = yield from head(_head_weight(params), x[logit_idx], shard)
    return out, k_pool, v_pool


def paged_mixed_step(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                     tokens, positions, row_tables, row_start, row_nvalid,
                     row_token_idx, tok_row, tok_col, slot_blocks,
                     slot_offsets, logit_idx, *, head_fn=None):
    """One RAGGED fused step over a token-PACKED mixed batch: decode rows
    contribute one token, prefill-chunk rows a consecutive run.

    Embeddings, layer norms, projections and the FFN run packed on the
    (T, D) stream; attention runs per row through the ragged paged op
    (``row_token_idx`` lifts each row's run to a (B, C) query block,
    ``tok_row``/``tok_col`` scatter the outputs back).  Per layer, all T
    tokens' K/V are written into the pool slots FIRST, then attention
    reads back masked to ``row_start + c + 1`` per query column — the
    causal set the dense prefill masks to.

    tokens/positions/slot_blocks/slot_offsets: (T,) int (padding tokens
    use position 0 and the null block 0); row_tables: (B, NB);
    row_start/row_nvalid: (B,) (n_valid >= 1); row_token_idx: (B, C);
    tok_row/tok_col: (T,); logit_idx: (B,) — packed index of each row's
    LAST run token (the speculative verify passes every packed position,
    (B * C,)).  Returns ``(logits (len(logit_idx), V), k_pool, v_pool)``
    (``head_fn``'s result in place of the logits when given)."""
    return run_single(_paged_mixed_body(
        params, cfg, k_pool, v_pool, tokens, positions, row_tables,
        row_start, row_nvalid, row_token_idx, tok_row, tok_col, slot_blocks,
        slot_offsets, logit_idx, head_fn, None))


def _chained_body(params, cfg, k_pool, v_pool, token, positions,
                  block_tables, slot_blocks, slot_offsets, head_at, shard):
    """K decode steps, step t's ids feeding step t+1, step t's vocab head
    ``head_at(t)`` (which returns ids).  Under a shard the replicated ids
    of the two-stage argmax are the carry every shard feeds its next
    step: the chain adds no collective to the per-step set."""
    K = slot_blocks.shape[1]
    maxp = cfg.max_len - 1
    tok = token.to(torch.int32)
    ids = []
    for t in range(K):
        # surplus steps of a budget-exhausted row run at a clamped
        # position; real steps never reach the clamp
        pos = torch.clamp(positions + t, max=maxp)
        tok, k_pool, v_pool = yield from _paged_decode_body(
            params, cfg, k_pool, v_pool, tok, pos, block_tables,
            slot_blocks[:, t], slot_offsets[:, t], head_at(t), shard)
        ids.append(tok)
    return torch.stack(ids, dim=1), k_pool, v_pool


def paged_chained_decode(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                         token, positions, block_tables, slot_blocks,
                         slot_offsets):
    """K greedy decode steps, step t's ids feeding step t+1 (the JAX
    package's ``lax.scan`` as a loop over :func:`paged_decode_step`).

    slot_blocks/slot_offsets: (B, K) per-step write slots, pre-reserved
    by the host; rows whose budget is < K point their surplus steps at
    the null block (their ids are discarded host-side).  Returns
    ``(ids (B, K) int32, k_pool, v_pool)``."""
    return run_single(_chained_body(
        params, cfg, k_pool, v_pool, token, positions, block_tables,
        slot_blocks, slot_offsets, lambda _t: _greedy_head, None))


# -- draft-model proposals (speculative decoding) ---------------------------


def draft_propose(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
                  n_valid: torch.Tensor, *, k: int) -> torch.Tensor:
    """K greedy next-token proposals from a small DRAFT model over a
    short window: ``token_ids`` (B, W) holds each row's most recent
    context in its first ``n_valid[b]`` entries with at least ``k`` free
    tail slots.  Each step runs the dense :func:`prefill` with
    ``flash=False`` (the JAX package's choice), argmaxes and appends.
    Positions are window-relative, so proposals are a pure function of
    the window.  Returns (B, k) int32."""
    B, W = token_ids.shape
    buf = token_ids.to(torch.int64).clone()
    nv = n_valid.to(torch.int64).clone()
    rows = torch.arange(B, device=buf.device)
    ids = []
    for _ in range(k):
        tok, _cache = prefill(params, cfg, buf, nv, flash=False,
                              head_fn=_greedy_head)
        buf[rows, torch.clamp(nv, max=W - 1)] = tok.to(torch.int64)
        nv = torch.clamp(nv + 1, max=W)
        ids.append(tok)
    return torch.stack(ids, dim=1)


# -- sampled program variants -------------------------------------------------
#
# Each wraps its greedy twin with the sampling head: the step math (so
# the logits, so the greedy rows' ids) is shared code.  Extra (B,) arrays:
# temperature (f32), top_k (int, <= 0 disables), top_p (f32, 1.0
# disables), seed (the request's) and emit_idx (the absolute index of the
# token this step emits for the row).  Each returns ``(ids (B,) int32,
# k_pool, v_pool)``.


def _row_head(temperature, top_k, top_p, seed, emit_idx):
    return _sampling_head(temperature, top_k, top_p,
                          _row_sample_keys(seed, emit_idx))


def _chain_heads(temperature, top_k, top_p, seed, emit0):
    """Step t of a sampled chain folds ``emit0 + t`` into each row's seed
    key, so a row's n-th token depends only on (seed, n)."""
    base = _seed_keys(seed)
    return lambda t: _sampling_head(temperature, top_k, top_p,
                                    prng.fold_in(base, emit0 + t))


def paged_decode_step_sampled(params: dict, cfg: DecoderConfig, k_pool,
                              v_pool, token, positions, block_tables,
                              slot_blocks, slot_offsets, temperature, top_k,
                              top_p, seed, emit_idx):
    """:func:`paged_decode_step` with per-row sampling."""
    return paged_decode_step(
        params, cfg, k_pool, v_pool, token, positions, block_tables,
        slot_blocks, slot_offsets,
        head_fn=_row_head(temperature, top_k, top_p, seed, emit_idx))


def paged_mixed_step_sampled(params: dict, cfg: DecoderConfig, k_pool,
                             v_pool, tokens, positions, row_tables,
                             row_start, row_nvalid, row_token_idx, tok_row,
                             tok_col, slot_blocks, slot_offsets, logit_idx,
                             temperature, top_k, top_p, seed, emit_idx):
    """:func:`paged_mixed_step` with per-row sampling (mid-prefill rows'
    ids are garbage the engine ignores, like their greedy logits)."""
    return paged_mixed_step(
        params, cfg, k_pool, v_pool, tokens, positions, row_tables,
        row_start, row_nvalid, row_token_idx, tok_row, tok_col, slot_blocks,
        slot_offsets, logit_idx,
        head_fn=_row_head(temperature, top_k, top_p, seed, emit_idx))


def paged_chained_decode_sampled(params: dict, cfg: DecoderConfig, k_pool,
                                 v_pool, token, positions, block_tables,
                                 slot_blocks, slot_offsets, temperature,
                                 top_k, top_p, seed, emit0):
    """:func:`paged_chained_decode` with per-row sampling: step t folds
    ``emit0 + t`` into each row's seed key, so the noise of a row's n-th
    token depends only on (seed, n) however budgets, preemption or a
    restart cut the chain.  ``emit0``: (B,) the emit index of each row's
    step-0 token."""
    return run_single(_chained_body(
        params, cfg, k_pool, v_pool, token, positions, block_tables,
        slot_blocks, slot_offsets,
        _chain_heads(temperature, top_k, top_p, seed, emit0), None))


def paged_prefill_sampled(params: dict, cfg: DecoderConfig, token_ids,
                          n_valid, k_pool, v_pool, block_tables, temperature,
                          top_k, top_p, seed, emit_idx, *,
                          flash: bool | None = None):
    """:func:`paged_prefill` with first-token sampling.  ``emit_idx`` is
    0 for a fresh prompt and ``len(emitted)`` for a re-admission by
    recompute (preemption or restart)."""
    return paged_prefill(
        params, cfg, token_ids, n_valid, k_pool, v_pool, block_tables,
        flash=flash,
        head_fn=_row_head(temperature, top_k, top_p, seed, emit_idx))


# -- the tensor-parallel programs ---------------------------------------------
#
# Each ``*_tp`` program runs its per-shard body once per shard of
# ``mesh`` (``parallel/mesh.TPMesh.spmd``): ``params`` is the list of
# shard param dicts (``parallel/mesh.shard_decoder_params`` of a plan
# built with ``tp=``), the pools (or the SSD state) are lists of shard
# tensors ([L, NB, BS, H/tp, hd] each), and the host-built index arrays
# are replicated to every shard's device.  QKV is column-parallel, the
# output and down projections row-parallel with one psum each, and the
# greedy choice is fused into the sharded head (an exact two-stage
# argmax), so each returns ``(ids, *shard pools)``: replicated ids from
# shard 0, never full-vocab logits.


def _tp_program(mesh, params, pools, args, body):
    """Run ``body(shard params, *shard pools, *shard args, shard)`` on
    every shard; returns shard 0's ids and each pool's shard list."""
    n = mesh.size
    reps = [mesh.replicate(a) if isinstance(a, torch.Tensor) else [a] * n
            for a in args]

    def per_shard(shard):
        i = shard.index
        return body(params[i], *(pl[i] for pl in pools),
                    *(r[i] for r in reps), shard=shard)

    outs = mesh.spmd(per_shard)
    return (outs[0][0],) + tuple([o[j + 1] for o in outs]
                                 for j in range(len(pools)))


def paged_prefill_tp(params, cfg: DecoderConfig, mesh, token_ids, n_valid,
                     k_pool, v_pool, block_tables, *,
                     flash: bool | None = None):
    """:func:`paged_prefill` over ``mesh``: the dense prefill at H/tp
    heads a shard (the flash kernel at H/tp heads on the card), each
    shard scattering its K/V slice into its pool shard."""
    return _tp_program(
        mesh, params, (k_pool, v_pool), (token_ids, n_valid, block_tables),
        lambda p, kp, vp, ids, nv, bt, shard: _paged_prefill_body(
            p, cfg, ids, nv, kp, vp, bt, flash, None, shard))


def paged_decode_step_tp(params, cfg: DecoderConfig, mesh, k_pool, v_pool,
                         token, positions, block_tables, slot_blocks,
                         slot_offsets):
    """:func:`paged_decode_step` over ``mesh``: each shard appends and
    attends its H/tp heads of the pool (the append+attend kernel)."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (token, positions, block_tables, slot_blocks, slot_offsets),
        lambda p, kp, vp, *a, shard: _paged_decode_body(
            p, cfg, kp, vp, *a, None, shard))


def paged_mixed_step_tp(params, cfg: DecoderConfig, mesh, k_pool, v_pool,
                        tokens, positions, row_tables, row_start, row_nvalid,
                        row_token_idx, tok_row, tok_col, slot_blocks,
                        slot_offsets, logit_idx):
    """:func:`paged_mixed_step` over ``mesh`` (the ragged kernel at H/tp
    heads a shard)."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (tokens, positions, row_tables, row_start, row_nvalid, row_token_idx,
         tok_row, tok_col, slot_blocks, slot_offsets, logit_idx),
        lambda p, kp, vp, *a, shard: _paged_mixed_body(
            p, cfg, kp, vp, *a, None, shard))


def paged_chained_decode_tp(params, cfg: DecoderConfig, mesh, k_pool, v_pool,
                            token, positions, block_tables, slot_blocks,
                            slot_offsets):
    """:func:`paged_chained_decode` over ``mesh``."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (token, positions, block_tables, slot_blocks, slot_offsets),
        lambda p, kp, vp, *a, shard: _chained_body(
            p, cfg, kp, vp, *a, lambda _t: _greedy_head, shard))


def paged_prefill_sampled_tp(params, cfg: DecoderConfig, mesh, token_ids,
                             n_valid, k_pool, v_pool, block_tables,
                             temperature, top_k, top_p, seed, emit_idx, *,
                             flash: bool | None = None):
    """:func:`paged_prefill_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (token_ids, n_valid, block_tables, temperature, top_k, top_p, seed,
         emit_idx),
        lambda p, kp, vp, ids, nv, bt, *samp, shard: _paged_prefill_body(
            p, cfg, ids, nv, kp, vp, bt, flash, _row_head(*samp), shard))


def paged_decode_step_sampled_tp(params, cfg: DecoderConfig, mesh, k_pool,
                                 v_pool, token, positions, block_tables,
                                 slot_blocks, slot_offsets, temperature,
                                 top_k, top_p, seed, emit_idx):
    """:func:`paged_decode_step_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (token, positions, block_tables, slot_blocks, slot_offsets,
         temperature, top_k, top_p, seed, emit_idx),
        lambda p, kp, vp, *a, shard: _paged_decode_body(
            p, cfg, kp, vp, *a[:5], _row_head(*a[5:]), shard))


def paged_mixed_step_sampled_tp(params, cfg: DecoderConfig, mesh, k_pool,
                                v_pool, tokens, positions, row_tables,
                                row_start, row_nvalid, row_token_idx, tok_row,
                                tok_col, slot_blocks, slot_offsets, logit_idx,
                                temperature, top_k, top_p, seed, emit_idx):
    """:func:`paged_mixed_step_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (tokens, positions, row_tables, row_start, row_nvalid, row_token_idx,
         tok_row, tok_col, slot_blocks, slot_offsets, logit_idx, temperature,
         top_k, top_p, seed, emit_idx),
        lambda p, kp, vp, *a, shard: _paged_mixed_body(
            p, cfg, kp, vp, *a[:11], _row_head(*a[11:]), shard))


def paged_chained_decode_sampled_tp(params, cfg: DecoderConfig, mesh, k_pool,
                                    v_pool, token, positions, block_tables,
                                    slot_blocks, slot_offsets, temperature,
                                    top_k, top_p, seed, emit0):
    """:func:`paged_chained_decode_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (k_pool, v_pool),
        (token, positions, block_tables, slot_blocks, slot_offsets,
         temperature, top_k, top_p, seed, emit0),
        lambda p, kp, vp, *a, shard: _chained_body(
            p, cfg, kp, vp, *a[:5], _chain_heads(*a[5:]), shard))


# -- the SSD (gated linear-attention) decoder ---------------------------------
#
# The constant-memory family of the state cache (``kvcache/statecache.py``):
# attention is replaced by a per-head decaying recurrence whose whole decode
# state is one (H, hd, hd) matrix per layer, independent of context length.
# It uses no positional embedding (order is encoded by the decay), so a
# sequence is bounded by nothing but its request.  The state lives in a
# stacked [L, max_slots, H, hd, hd] tensor; slot 0 is the null sink of
# padding rows, like the paged pool's block 0.  Like the paged steps, the
# programs update the state IN PLACE and return it.


def ssd_augment_params(params: dict, cfg: DecoderConfig,
                       seed: int = 0) -> dict:
    """Graft the per-layer decay projections (``w_a`` (D, H), ``b_a``
    (H,)) onto a dense decoder's parameters; every other weight is
    reused, so one checkpoint serves the paged and the SSD engines.
    ``b_a`` spreads the heads' decay from slow (~0.95 a token) to fast
    (~0.27); ``w_a`` adds a small input-dependent gate.

    ``w_a`` is the JAX package's ``0.02 * jax.random.normal`` draw for
    the same seed: the keys and bits through the port's threefry
    (``models/prng.py``, bit for bit), the normal as JAX forms it
    (``sqrt(2) * erfinv(u)``, u uniform in (-1, 1)) within the two
    ``erfinv`` implementations' rounding.  Drawn on the CPU, then moved
    to the parameters' device, so every replica and restart grafts the
    same bytes."""
    D, H = cfg.d_model, cfg.n_heads
    dev = params["embed"].device
    key = prng.prng_key(seed)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    hi = torch.tensor(1.0)
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        # jax.random.split(key): the two keys are threefry2x32(key, (0, i))
        k0, k1 = prng.threefry2x32(key, torch.zeros(2, dtype=torch.int64),
                                   torch.arange(2, dtype=torch.int64))
        key, sub = (torch.stack([k0[0], k1[0]]),
                    torch.stack([k0[1], k1[1]]))
        bits = prng.random_bits_32(sub, D * H).reshape(D, H)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        u = torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)
        normal = torch.tensor(math.sqrt(2.0), dtype=torch.float32) * \
            torch.erfinv(u)
        new = dict(layer)
        new["w_a"] = (0.02 * normal).to(dev)
        new["b_a"] = torch.linspace(-3.0, 1.0, H, dtype=torch.float32).to(dev)
        layers.append(new)
    out["layers"] = layers
    return out


def _ssd_decay(layer, h, valid=None):
    """Per-head log decay ``log a = -softplus(h @ w_a + b_a) <= 0``;
    ``valid`` sets padding tokens to log a = 0 (a = 1), so they neither
    decay nor feed the state."""
    la = -F.softplus(h @ layer["w_a"].to(h.dtype) + layer["b_a"].to(h.dtype))
    if valid is not None:
        la = la * valid[..., None].to(la.dtype)
    return la


def _ssd_layer_chunk(layer, h, s0, hd: int, valid):
    """Chunk-parallel form over one C-token chunk: h (B, C, D), s0 (B, H,
    hd, hd), valid (B, C) bool.  Returns ``(y (B, C, H, hd), s1)``.

    Within the chunk, ``W[t, s] = exp(L_t - L_s)`` for s <= t (L the
    inclusive cumulative log decay); above the diagonal L_t - L_s > 0 and
    its exp can overflow, so it is SELECTED away (``torch.where``): a
    mask multiply would turn ``inf * 0`` into NaN.  The carried state adds
    ``exp(L_t) q_t . s0``, and the chunk folds into ``s1 = exp(L_C) s0 +
    sum_s exp(L_C - L_s) k_s^T v_s``.  Padding tokens (log a = 0, k = 0)
    are exact no-ops on both."""
    B, C, _D = h.shape
    q = _proj(layer, h, "wq", "bq").reshape(B, C, -1, hd) / math.sqrt(hd)
    k = _proj(layer, h, "wk", "bk").reshape(B, C, -1, hd)
    v = _proj(layer, h, "wv", "bv").reshape(B, C, -1, hd)
    k = torch.where(valid[:, :, None, None], k, torch.zeros_like(k))
    la = _ssd_decay(layer, h, valid)            # (B, C, H)
    lc = torch.cumsum(la, dim=1)                # inclusive: L_t
    dec = lc[:, :, None, :] - lc[:, None, :, :]  # (B, t, s, H)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=h.device))
    w = torch.where(causal[None, :, :, None], torch.exp(dec),
                    torch.zeros_like(dec)).to(h.dtype)
    att = torch.einsum("bthd,bshd->btsh", q, k)
    y = torch.einsum("btsh,bshd->bthd", att * w, v)
    y = y + torch.exp(lc)[..., None].to(h.dtype) * torch.einsum(
        "bthd,bhde->bthe", q, s0)
    w_fold = torch.exp(lc[:, -1:, :] - lc).to(h.dtype)  # (B, C, H)
    s1 = torch.exp(lc[:, -1])[..., None, None].to(h.dtype) * s0 \
        + torch.einsum("bsh,bshd,bshe->bhde", w_fold, k, v)
    return y, s1


def _ssd_layer_step(layer, h, s0, hd: int):
    """Recurrent form, one token: h (B, D), s0 (B, H, hd, hd).  Returns
    ``(y (B, H, hd), s1)``; the C = 1 chunk form's math."""
    B = h.shape[0]
    q = _proj(layer, h, "wq", "bq").reshape(B, -1, hd) / math.sqrt(hd)
    k = _proj(layer, h, "wk", "bk").reshape(B, -1, hd)
    v = _proj(layer, h, "wv", "bv").reshape(B, -1, hd)
    a = torch.exp(_ssd_decay(layer, h))         # (B, H)
    s1 = a[..., None, None].to(h.dtype) * s0 \
        + torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", q, s1)
    return y, s1


def _ssd_forward_body(params, cfg, s, token, head_fn, shard):
    dtype = resolve_dtype(cfg.dtype, token.device)
    B = token.shape[0]
    hd = cfg.d_model // cfg.n_heads
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    x = yield from _embed_rows(params["embed"].to(dtype), token, shard)
    new = []
    for li, layer in enumerate(params["layers"]):
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        y, s1 = _ssd_layer_step(layer, h, s[li], hd)
        x = x + (yield from _row_proj(layer, y.reshape(B, -1), "wo", "bo",
                                      shard))
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj(layer, h, "w_up", "b_up"))
        x = x + (yield from _row_proj(layer, ff, "w_down", "b_down", shard))
        new.append(s1)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    head = _head_out if head_fn is None else head_fn
    out = yield from head(params["embed"], x, shard)
    return out, torch.stack(new)


def _ssd_forward_step(params: dict, cfg: DecoderConfig, s, token, head_fn):
    """One recurrent token through every layer: ``s`` the rows' state
    stack (L, B, H, hd, hd), ``token`` (B,).  Returns ``(out, s_new)``,
    ``out`` the f32 logits or ``head_fn``'s result."""
    return run_single(_ssd_forward_body(params, cfg, s, token, head_fn,
                                        None))


def _ssd_mixed_body(params, cfg, state, tokens, n_valid, row_slots, head_fn,
                    shard):
    dtype = resolve_dtype(cfg.dtype, tokens.device)
    B, C = tokens.shape
    hd = cfg.d_model // cfg.n_heads
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    slots = row_slots.long()
    valid = (torch.arange(C, device=tokens.device)[None, :]
             < n_valid[:, None])
    x = yield from _embed_rows(params["embed"].to(dtype), tokens, shard)
    new = []
    for li, layer in enumerate(params["layers"]):
        s0 = state[li, slots]                    # (B, H, hd, hd)
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        y, s1 = _ssd_layer_chunk(layer, h, s0, hd, valid)
        x = x + (yield from _row_proj(layer, y.reshape(B, C, -1), "wo", "bo",
                                      shard))
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj(layer, h, "w_up", "b_up"))
        x = x + (yield from _row_proj(layer, ff, "w_down", "b_down", shard))
        new.append(s1)
    # several idle rows writing slot 0 race, and which one lands is
    # undefined on the card: benign only because slot 0 is the null sink
    state[:, slots] = torch.stack(new)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    last = torch.clamp(n_valid.long() - 1, min=0)
    sel = x[torch.arange(B, device=x.device), last]
    head = _head_out if head_fn is None else head_fn
    out = yield from head(params["embed"], sel, shard)
    return out, state


def ssd_mixed_step(params: dict, cfg: DecoderConfig, state: torch.Tensor,
                   tokens: torch.Tensor, n_valid: torch.Tensor,
                   row_slots: torch.Tensor, *, head_fn=None):
    """One chunk-parallel step over a batch of token RUNS, the state
    engine's mixed prefill + decode program (a decode row is a run of
    one token).

    tokens (B, C) ints, each row's next C tokens zero-padded; n_valid
    (B,) the valid tokens a row (0: an idle row, an exact no-op on its
    slot); row_slots (B,) slot ids (idle rows: the null slot 0); state
    (L, S, H, hd, hd), updated IN PLACE.  Returns ``(out, state)``,
    ``out`` at each row's LAST valid token: (B, V) f32 logits or
    ``head_fn``'s result."""
    return run_single(_ssd_mixed_body(params, cfg, state, tokens, n_valid,
                                      row_slots, head_fn, None))


def _ssd_decode_body(params, cfg, state, token, row_slots, head_fn, shard):
    slots = row_slots.long()
    out, s = yield from _ssd_forward_body(params, cfg, state[:, slots], token,
                                          head_fn, shard)
    state[:, slots] = s
    return out, state


def ssd_decode_step(params: dict, cfg: DecoderConfig, state: torch.Tensor,
                    token: torch.Tensor, row_slots: torch.Tensor, *,
                    head_fn=None):
    """One batched recurrent decode token: gather each row's state,
    update, scatter back (IN PLACE).  token/row_slots (B,) ints.  Returns
    ``(out, state)`` as :func:`ssd_mixed_step`."""
    return run_single(_ssd_decode_body(params, cfg, state, token, row_slots,
                                       head_fn, None))


def _ssd_chained_body(params, cfg, state, token, row_slots, steps, rem,
                      stop_tok, head_at, shard):
    """K recurrent steps (``K = len(steps)``), step t's ids feeding step
    t+1 and step t's head ``head_at(t)`` returning ids.  A row past its
    budget ``rem`` or its EOS FREEZES: its state stops updating and its
    id repeats, so a finished row's state stays exactly context +
    emitted[:-1] (a recurrent state has no null block to absorb surplus
    steps).  The rows' state stack is gathered once and scattered once."""
    slots = row_slots.long()
    s = state[:, slots]
    B = token.shape[0]
    tok = token.to(torch.int32)
    nprod = torch.zeros(B, dtype=torch.int32, device=token.device)
    stopped = torch.zeros(B, dtype=torch.bool, device=token.device)
    rem = rem.to(torch.int32)
    ids = []
    for t in range(int(steps.shape[0])):
        new_ids, s_new = yield from _ssd_forward_body(params, cfg, s, tok,
                                                      head_at(t), shard)
        active = ~stopped & (nprod < rem)
        s = torch.where(active[None, :, None, None, None], s_new, s)
        tok = torch.where(active, new_ids, tok)
        nprod = nprod + active.to(torch.int32)
        stopped = stopped | (active & (tok == stop_tok))
        ids.append(tok)
    state[:, slots] = s
    return torch.stack(ids, dim=1), state


def ssd_chained_decode(params: dict, cfg: DecoderConfig, state, token,
                       row_slots, steps, rem, stop_tok):
    """K greedy recurrent steps (the JAX package's ``lax.scan`` as a loop
    over :func:`_ssd_forward_step`).  ``steps`` (K,) (its length is the
    chain's), ``rem`` (B,) each row's step budget, ``stop_tok`` () the EOS
    id (-1 for none).  Returns ``(ids (B, K) int32, state)``."""
    return run_single(_ssd_chained_body(
        params, cfg, state, token, row_slots, steps, rem, stop_tok,
        lambda _t: _greedy_head, None))


def ssd_mixed_step_sampled(params: dict, cfg: DecoderConfig, state, tokens,
                           n_valid, row_slots, temperature, top_k, top_p,
                           seed, emit_idx):
    """:func:`ssd_mixed_step` with per-row sampling, on the paged
    programs' (seed, emit index) key schedule.  Returns ``(ids,
    state)``."""
    return ssd_mixed_step(
        params, cfg, state, tokens, n_valid, row_slots,
        head_fn=_row_head(temperature, top_k, top_p, seed, emit_idx))


def ssd_decode_step_sampled(params: dict, cfg: DecoderConfig, state, token,
                            row_slots, temperature, top_k, top_p, seed,
                            emit_idx):
    """:func:`ssd_decode_step` with per-row sampling."""
    return ssd_decode_step(
        params, cfg, state, token, row_slots,
        head_fn=_row_head(temperature, top_k, top_p, seed, emit_idx))


def ssd_chained_decode_sampled(params: dict, cfg: DecoderConfig, state,
                               token, row_slots, steps, rem, stop_tok,
                               temperature, top_k, top_p, seed, emit0):
    """:func:`ssd_chained_decode` with sampling: step t folds ``emit0 +
    t`` into each row's seed key, the paged chain's schedule (a row's
    active steps are a prefix of the chain, so K sampled single steps
    draw the same tokens)."""
    return run_single(_ssd_chained_body(
        params, cfg, state, token, row_slots, steps, rem, stop_tok,
        _chain_heads(temperature, top_k, top_p, seed, emit0), None))


# The SSD programs over a mesh: each shard runs its H/tp heads'
# recurrence on its slice of the state ([L, S, H/tp, hd, hd]); the
# collectives per layer are the paged path's (one psum per row-parallel
# projection, the two-stage argmax head).  ``state`` is the list of
# shard states; each returns ``(ids, shard states)``.


def ssd_mixed_step_tp(params, cfg: DecoderConfig, mesh, state, tokens,
                      n_valid, row_slots):
    """:func:`ssd_mixed_step` over ``mesh``."""
    return _tp_program(
        mesh, params, (state,), (tokens, n_valid, row_slots),
        lambda p, st, *a, shard: _ssd_mixed_body(p, cfg, st, *a, None,
                                                 shard))


def ssd_decode_step_tp(params, cfg: DecoderConfig, mesh, state, token,
                       row_slots):
    """:func:`ssd_decode_step` over ``mesh``."""
    return _tp_program(
        mesh, params, (state,), (token, row_slots),
        lambda p, st, *a, shard: _ssd_decode_body(p, cfg, st, *a, None,
                                                  shard))


def ssd_chained_decode_tp(params, cfg: DecoderConfig, mesh, state, token,
                          row_slots, steps, rem, stop_tok):
    """:func:`ssd_chained_decode` over ``mesh``: the replicated ids are
    the carry every shard feeds its next step."""
    return _tp_program(
        mesh, params, (state,), (token, row_slots, steps, rem, stop_tok),
        lambda p, st, *a, shard: _ssd_chained_body(
            p, cfg, st, *a, lambda _t: _greedy_head, shard))


def ssd_mixed_step_sampled_tp(params, cfg: DecoderConfig, mesh, state,
                              tokens, n_valid, row_slots, temperature, top_k,
                              top_p, seed, emit_idx):
    """:func:`ssd_mixed_step_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (state,),
        (tokens, n_valid, row_slots, temperature, top_k, top_p, seed,
         emit_idx),
        lambda p, st, *a, shard: _ssd_mixed_body(
            p, cfg, st, *a[:3], _row_head(*a[3:]), shard))


def ssd_decode_step_sampled_tp(params, cfg: DecoderConfig, mesh, state,
                               token, row_slots, temperature, top_k, top_p,
                               seed, emit_idx):
    """:func:`ssd_decode_step_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (state,),
        (token, row_slots, temperature, top_k, top_p, seed, emit_idx),
        lambda p, st, *a, shard: _ssd_decode_body(
            p, cfg, st, *a[:2], _row_head(*a[2:]), shard))


def ssd_chained_decode_sampled_tp(params, cfg: DecoderConfig, mesh, state,
                                  token, row_slots, steps, rem, stop_tok,
                                  temperature, top_k, top_p, seed, emit0):
    """:func:`ssd_chained_decode_sampled` over ``mesh``."""
    return _tp_program(
        mesh, params, (state,),
        (token, row_slots, steps, rem, stop_tok, temperature, top_k, top_p,
         seed, emit0),
        lambda p, st, *a, shard: _ssd_chained_body(
            p, cfg, st, *a[:5], _chain_heads(*a[5:]), shard))


# The full-sequence forward and the training step.  ``forward_logits`` is
# the differentiated path: its attention is plain einsum with an f32
# softmax, as in the JAX package, whose flash kernel has no VJP (nor has
# the port's).  Params, grads and momentum stay f32; compute runs in
# ``cfg.dtype``'s resolution (bf16 on the card).


def _causal_attention(layer, x, n_heads: int):
    B, T, D = x.shape
    hd = D // n_heads
    q = _proj(layer, x, "wq", "bq").reshape(B, T, n_heads, hd)
    k = _proj(layer, x, "wk", "bk").reshape(B, T, n_heads, hd)
    v = _proj(layer, x, "wv", "bv").reshape(B, T, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))
    scores = scores.masked_fill(~causal, -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    return _proj(layer, out, "wo", "bo")


def forward_logits(params: dict, cfg: DecoderConfig,
                   token_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T, V) f32 logits (tied embedding head).

    Pre-LN residual blocks — structurally GPT-2's forward, so GPT-2-family
    weights map directly (models/hf_import.py).  Differentiable in
    ``params``; runs on their device."""
    dtype = resolve_dtype(cfg.dtype, token_ids.device)
    token_ids = token_ids.long()
    x = params["embed"].to(dtype)[token_ids]
    T = token_ids.shape[1]
    x = x + params["pos_embed"].to(dtype)[:T][None, :, :]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        x = x + _causal_attention(layer, h, cfg.n_heads)
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj(layer, h, "w_up", "b_up"))
        x = x + _proj(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return (x @ params["embed"].to(x.dtype).T).float()


def lm_loss(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """The masked mean next-token NLL of ``token_ids`` (B, T); ``mask``
    (B, T) weighs each target position (an all-zero mask gives 0)."""
    logits = forward_logits(params, cfg, token_ids[:, :-1])
    targets = token_ids[:, 1:].long()
    m = mask[:, 1:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a params-shaped tree of dicts and lists
    (``rest``: trees of the same shape, read by key and index)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    leaves: list = []
    _tree_map(leaves.append, tree)
    return leaves


def make_train_step(cfg: DecoderConfig, learning_rate: float = 1e-3,
                    device="cuda"):
    """SGD with momentum 0.9 on :func:`lm_loss`, with no optimiser
    library: ``train_step(params, momentum, token_ids, mask)`` returns
    ``(new_params, new_momentum, loss)`` and leaves its inputs unchanged
    (the JAX step is a pure function).  ``params`` and ``momentum``
    (:func:`init_opt_state`) are f32 trees on ``device``; the token ids
    and mask are moved there.  The first step from zero momentum returns
    the gradients as its momentum."""
    dev = resolve_device(device)

    def train_step(params, opt_state, token_ids, mask):
        bad = {str(t.device) for t in _tree_leaves(params)
               if t.device.type != dev.type or dev.index not in (
                   None, t.device.index)}
        if bad:
            raise ValueError(f"params on {sorted(bad)}, the step runs on "
                             f"{dev}")
        live = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = _tree_leaves(live)
        loss = lm_loss(live, cfg, token_ids.to(dev), mask.to(dev))
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        with torch.no_grad():
            new_momentum = _tree_map(
                lambda t, m: 0.9 * m + _or_zeros(next(grads), t),
                live, opt_state)
            new_params = _tree_map(lambda p, m: p - learning_rate * m,
                                   params, new_momentum)
        return new_params, new_momentum, loss.detach()

    return train_step


def _or_zeros(grad, leaf):
    """A leaf the loss does not reach (an SSD graft's ``w_a``) has zero
    gradient, as ``jax.grad`` gives it."""
    return torch.zeros_like(leaf) if grad is None else grad


def init_opt_state(params):
    """Zero momentum of ``params``' shape."""
    return _tree_map(torch.zeros_like, params)


def measured_tier_prior(db=None) -> str | None:
    """The single-stream tier race's recorded verdict in the cost store
    (``pw.decode_tier`` / ``single_stream_pick``, scoped to this
    backend's fingerprint): ``"int8_host"``, ``"f32_device"`` or
    ``"int8_device"``, or None when no race was recorded here.  A store
    that cannot be read raises (the reference treats that as no
    prior)."""
    if db is None:
        from ..obs.costdb import default_db

        db = default_db()
    entry = db.get("pw.decode_tier", "single_stream_pick")
    if entry is None:
        return None
    tier = (entry.get("extra") or {}).get("tier")
    return tier if isinstance(tier, str) else None


class TorchDecoderLM:
    """Host-facing text generator (counterpart of ``JaxDecoderLM``):
    :meth:`generate` for one prompt over the dense cache, and
    :meth:`generate_batch` over the paged engine.  Its dense programs are
    registered in the device cost observatory as ``pw.lm_prefill``,
    ``pw.lm_decode_step`` and ``pw.lm_fused_k<max_new>[_s<stop>]``."""

    # max_new bucketing of the fused tier (the JAX package compiles one
    # program per (seq bucket, new bucket, stop); here it bounds the loop)
    new_buckets = (16, 32, 64, 128, 256)

    def __init__(self, cfg: DecoderConfig | None = None, seed: int = 0,
                 params: dict | None = None, tokenizer=None, device="cuda",
                 seq_buckets=(64, 256, 1024)):
        self.device = resolve_device(device)
        self.cfg = cfg or DecoderConfig()
        self.params = (params if params is not None
                       else init_decoder_params(self.cfg, seed, self.device))
        if tokenizer is None:
            from .tokenizer import HashTokenizer

            tokenizer = HashTokenizer(self.cfg.vocab_size)
        self.tokenizer = tokenizer
        self.seq_buckets = [b for b in seq_buckets
                            if b <= self.cfg.max_len] or [self.cfg.max_len]
        self._engine = None
        self._dense = None
        self._int8 = None
        self._int8_lock = threading.Lock()
        cfg = self.cfg

        def _prefill_fn(params, token_ids, n_valid):
            return prefill(params, cfg, token_ids.long(), n_valid.long())

        def _step_fn(params, cache, token, pos):
            return decode_step(params, cfg, cache, token.long(), pos)

        self._prefill = profiled("pw.lm_prefill", _prefill_fn)
        self._step = profiled("pw.lm_decode_step", _step_fn)
        # one fused program per (max_new bucket, stop): the stop token is
        # not in the argument shapes, so it is part of the program name
        self._fused_progs: dict = {}

    def _fused(self, max_new: int, stop_token: int | None):
        key = (max_new, stop_token)
        prog = self._fused_progs.get(key)
        if prog is None:
            cfg = self.cfg

            def fn(params, token_ids, n_valid):
                return generate_tokens_fused(params, cfg, token_ids.long(),
                                             n_valid.long(), max_new,
                                             stop_token)

            suffix = "" if stop_token is None else f"_s{stop_token}"
            prog = self._fused_progs[key] = profiled(
                f"pw.lm_fused_k{max_new}{suffix}", fn)
        return prog

    @classmethod
    def from_hf(cls, model_name_or_path: str, **kwargs) -> "TorchDecoderLM":
        """A locally stored GPT-2-family model (``transformers`` is
        imported only here; no network), its weights moved to
        ``device``; its tokenizer when one is saved beside the weights,
        else the hash tokenizer.  ``kwargs`` are the constructor's."""
        from .encoder import _HFTokenizerAdapter
        from .hf_import import load_hf_decoder

        dev = resolve_device(kwargs.pop("device", "cuda"))
        params, cfg, hf_tok = load_hf_decoder(model_name_or_path)
        tok = _HFTokenizerAdapter(hf_tok) if hf_tok is not None else None
        return cls(cfg, params=_tree_map(lambda t: t.to(dev), params),
                   tokenizer=tok, device=dev, **kwargs)

    def paged_engine(self, **kwargs):
        """The paged decode engine over this LM's weights, built on first
        use (keyed on the params object, so reassigning ``params``
        rebuilds it).  ``kwargs`` are ``PagedDecodeEngine`` arguments
        (sizes, ``max_restarts``, ``watchdog_timeout_s``,
        ``speculative``, ``quantize``); they apply when the engine is
        built."""
        if self._engine is not None and self._engine[0] is self.params:
            return self._engine[1]
        from ..kvcache.engine import PagedDecodeEngine

        eng = PagedDecodeEngine(self.cfg, self.params, device=self.device,
                                **kwargs)
        self._engine = (self.params, eng)
        return eng

    def _int8_host(self):
        """The int8 host tier over this LM's weights, built on first use
        under the generation lock (concurrent first calls quantize one
        copy) and keyed on the params object: reassigning ``params``
        rebuilds it."""
        with self._int8_lock:
            if self._int8 is None or self._int8[0] is not self.params:
                from .host_decoder import Int8DecoderHost

                self._int8 = (self.params,
                              Int8DecoderHost(self.cfg, self.params))
            return self._int8[1]

    def dense_params(self) -> dict:
        """The decode plan :meth:`generate` runs with: fused ``wqkv`` and
        ``embed_t`` (exact), on this LM's device in the compute dtype,
        built on first use and keyed on the params object."""
        if self._dense is not None and self._dense[0] is self.params:
            return self._dense[1]
        dtype = resolve_dtype(self.cfg.dtype, self.device)
        plan = params_to(plan_decode_params(self.cfg, self.params),
                         self.device, dtype)
        self._dense = (self.params, plan)
        return plan

    def encode_prompts(self, prompts: list[str], max_new_tokens: int):
        """Token ids per prompt, trimmed to leave room for every new
        token (the JAX package's trimming rule)."""
        keep = self.cfg.max_len - max_new_tokens
        return [self.tokenizer.encode(p)[-max(keep, 1):] or [4]
                for p in prompts]

    def _bucket(self, n: int) -> int:
        for b in self.seq_buckets:
            if n <= b:
                return b
        return self.seq_buckets[-1]

    def _decode_out(self, out: list[int]) -> str:
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode(out)
        # the hash tokenizer cannot invert ids: each comes back as "<id>"
        return " ".join(f"<{t}>" for t in out)

    def generate(self, prompt: str, max_new_tokens: int = 32,
                 stop_token: int | None = None,
                 fused: bool | str = "auto") -> str:
        """Greedy completion of one prompt over the dense cache, padded
        to its sequence bucket.  ``fused=True`` (and ``"auto"``, the JAX
        package's choice on the accelerator) runs
        :func:`generate_tokens_fused`: prefill plus the whole decode loop
        with one host fetch at the end.  ``fused=False`` is the stepwise
        tier, one ``decode_step`` and one id fetch per token.
        ``fused="int8"`` is the int8 host tier
        (``models/host_decoder.Int8DecoderHost``, on the CPU by design),
        built on first use; only an LM on the CPU takes it; on the card
        it raises rather than move the work to the host (int8 weights on
        the card: ``paged_engine(quantize="int8")``).

        ``fused="auto"`` consults :func:`measured_tier_prior`: a recorded
        ``"f32_device"`` / ``"int8_device"`` verdict routes to the paged
        engine (int8 plan for the latter), ``"int8_host"`` to the int8
        host tier on an LM on the CPU; an LM on the card does not take
        ``"int8_host"`` (the port does not serve the host tier from the
        card) and says so in the log.  Anything else runs the fused
        tier."""
        if fused == "auto":
            tier = measured_tier_prior()
            if tier in ("f32_device", "int8_device"):
                eng = self.paged_engine(
                    quantize="int8" if tier == "int8_device" else None)
                ids = self.encode_prompts([prompt], max_new_tokens)[0]
                out = []
                for t in eng.generate(ids, max_new_tokens):
                    out.append(int(t))
                    if stop_token is not None and t == stop_token:
                        break
                return self._decode_out(out)
            if tier == "int8_host" and self.device.type == "cpu":
                fused = "int8"
            else:
                if tier == "int8_host":
                    logger.info(
                        "generate(fused='auto'): the recorded tier "
                        "'int8_host' is not taken by an LM on %s (the host "
                        "tier is served on the CPU only); running the "
                        "fused tier", self.device)
                fused = True
        if fused == "int8" and self.device.type != "cpu":
            raise ValueError(
                f"fused='int8' is the int8 host tier, which runs on the "
                f"CPU, and this LM is on {self.device}: build the LM with "
                f"device='cpu' for the host tier, or use "
                f"paged_engine(quantize='int8') for int8 weights on the "
                f"card")
        ids = self.encode_prompts([prompt], max_new_tokens)[0]
        if fused == "int8":
            host = self._int8_host()
            # the host tier's KV cache is shared mutable state:
            # generations are serialised so callers cannot interleave it
            with self._int8_lock:
                out = [int(np.argmax(host.prefill(ids)))]
                for _ in range(max_new_tokens - 1):
                    if stop_token is not None and out[-1] == stop_token:
                        break
                    if host.n_past >= host.cap:
                        break
                    out.append(int(np.argmax(host.decode_step(out[-1]))))
            return self._decode_out(out)
        L = self._bucket(len(ids) + max_new_tokens)
        if len(ids) + max_new_tokens > L:
            # largest bucket smaller than prompt+completion: keep the most
            # recent context that still leaves room for every new token
            ids = ids[-max(L - max_new_tokens, 1):]
        n = len(ids)
        buf = torch.zeros((1, L), dtype=torch.int32)
        buf[0, :n] = torch.tensor(ids)
        buf = buf.to(self.device)
        n_valid = torch.tensor([n], dtype=torch.int32, device=self.device)
        params = self.dense_params()
        if fused:
            new_b = next(
                (b for b in self.new_buckets if max_new_tokens <= b),
                # beyond the largest bucket: round up to a 64-multiple
                -(-max_new_tokens // 64) * 64,
            )
            new_b = min(new_b, L - n) or 1
            tokens, n_steps = self._fused(new_b, stop_token)(
                params, buf, n_valid)
            # the one host fetch: the ids and the step count together
            got = torch.cat([tokens[0], n_steps.reshape(1)]).tolist()
            toks = got[:-1][: got[-1]][:max_new_tokens]
            out = []
            for t in toks:
                out.append(t)
                if stop_token is not None and t == stop_token:
                    break
            return self._decode_out(out)
        logits, kv = self._prefill(params, buf, n_valid)
        out = [int(greedy(logits)[0])]
        for _ in range(max_new_tokens - 1):
            nxt = out[-1]
            if stop_token is not None and nxt == stop_token:
                break
            if n >= L:
                break
            logits, kv = self._step(
                params, kv,
                torch.tensor([nxt], dtype=torch.int32, device=self.device),
                n)
            n += 1
            out.append(int(greedy(logits)[0]))
        return self._decode_out(out)

    def generate_batch(self, prompts: list[str], max_new_tokens: int = 32,
                       stop_token: int | None = None) -> list[str]:
        """Batched greedy completion through the paged KV cache: one
        engine pass decodes every prompt (mixed lengths, shared prefixes
        mapped to shared physical blocks)."""
        reqs = [(ids, max_new_tokens)
                for ids in self.encode_prompts(prompts, max_new_tokens)]
        outs = self.paged_engine().generate_batch(reqs, stop_token=stop_token)
        return [self._decode_out(toks) for toks in outs]


__all__ = [
    "DecoderConfig", "TorchDecoderLM", "decode_step", "draft_propose",
    "generate_tokens_fused", "greedy", "init_decoder_params",
    "measured_tier_prior",
    "int8_device_native", "paged_chained_decode",
    "paged_chained_decode_sampled", "paged_chained_decode_sampled_tp",
    "paged_chained_decode_tp", "paged_decode_step",
    "paged_decode_step_sampled", "paged_decode_step_sampled_tp",
    "paged_decode_step_tp", "paged_mixed_step", "paged_mixed_step_sampled",
    "paged_mixed_step_sampled_tp", "paged_mixed_step_tp", "paged_prefill",
    "paged_prefill_sampled", "paged_prefill_sampled_tp", "paged_prefill_tp",
    "params_to", "plan_decode_params", "prefill", "quantize_weight_int8",
    "ssd_augment_params", "ssd_chained_decode",
    "ssd_chained_decode_sampled", "ssd_chained_decode_sampled_tp",
    "ssd_chained_decode_tp", "ssd_decode_step", "ssd_decode_step_sampled",
    "ssd_decode_step_sampled_tp", "ssd_decode_step_tp", "ssd_mixed_step",
    "ssd_mixed_step_sampled", "ssd_mixed_step_sampled_tp",
    "ssd_mixed_step_tp",
]
