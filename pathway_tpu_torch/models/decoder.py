"""Causal decoder LM — the generation model of the RAG path (tp = 1,
no quantization, greedy).

Plain functions on the JAX package's parameter-dict layout, so the same
weights run in both (``models/convert.py``).  Attention on the paged
path goes through ``kvcache/paged_attention.py``: the CUDA kernels for
CUDA tensors, the plain version for CPU tensors.  The paged steps update
the pools IN PLACE (the JAX package returns new, donated arrays) and
return them for symmetry with the JAX signatures.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .._device import resolve_device, resolve_dtype
from .encoder import (EncoderConfig, _act, _layer_norm, _proj, init_params,
                      params_to)


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


def _embed_rows(embed, tokens):
    """Tied-embedding lookup."""
    return embed[tokens]


def _proj_p(layer, x, w_name: str, b_name: str):
    return _proj(layer, x, w_name, b_name)


_row_proj = _proj_p  # row-parallel projection: identical at tp = 1


def _qkv_proj(layer, x):
    """Q/K/V: ONE fused gemm against the decode plan's ``wqkv`` leaf when
    present, else the three separate gemms."""
    if "wqkv" in layer:
        return _proj_p(layer, x, "wqkv", "bqkv").chunk(3, dim=-1)
    return (_proj(layer, x, "wq", "bq"), _proj(layer, x, "wk", "bk"),
            _proj(layer, x, "wv", "bv"))


def _head_weight(params):
    """The vocab-head operand: the plan's pre-transposed [D, V]
    ``embed_t`` as a ``(w, None)`` tuple (orientation explicit, never
    shape-guessed), or the raw tied [V, D] table."""
    if "embed_t" in params:
        return (params["embed_t"], None)
    return params["embed"]


def _head_out(head_w, x):
    """(B, D) -> (B, V) f32 logits for the tied-embedding head."""
    if isinstance(head_w, tuple):
        return (x @ head_w[0].to(x.dtype)).float()
    return (x @ head_w.to(x.dtype).T).float()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab; ties go to the smallest id (torch.argmax
    returns the first maximal index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def plan_decode_params(cfg: DecoderConfig, params: dict) -> dict:
    """The fused decode plan the paged engine dispatches with (tp = 1,
    no quantization): Q/K/V folded into one [D, 3D] ``wqkv`` per layer,
    and the tied head pre-materialized as [D, V] ``embed_t``.  Both are
    exact, so the plan is token-identical to the raw parameters."""
    plan = {k: v for k, v in params.items() if k != "layers"}
    plan["embed_t"] = params["embed"].T.contiguous()
    layers = []
    for layer in params["layers"]:
        new = {k: v for k, v in layer.items()
               if k not in ("wq", "wk", "wv", "bq", "bk", "bv")}
        new["wqkv"] = torch.cat([layer["wq"], layer["wk"], layer["wv"]],
                                dim=-1)
        if layer.get("bq") is not None:
            new["bqkv"] = torch.cat([layer["bq"], layer["bk"], layer["bv"]])
        layers.append(new)
    plan["layers"] = layers
    return plan


def prefill(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
            n_valid: torch.Tensor):
    """Dense full-context forward over the (padded) prompt: returns the
    logits at position ``n_valid - 1`` and the per-layer K/V cache
    (``{"k", "v"}`` of shape (B, T, H, hd)).  The plain einsum path (the
    JAX package's ``flash=False``): the in-port identity oracle."""
    dtype = resolve_dtype(cfg.dtype, token_ids.device)
    B, T = token_ids.shape
    hd = cfg.d_model // cfg.n_heads
    x = _embed_rows(params["embed"].to(dtype), token_ids)
    x = x + params["pos_embed"].to(dtype)[:T][None, :, :]
    eps = cfg.ln_eps
    act = _act_fn(cfg)
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
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        scores = scores.masked_fill(~causal[None, None], -1e9)
        probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, -1)
        x = x + _row_proj(layer, a, "wo", "bo")
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + _row_proj(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    last = x[torch.arange(B, device=x.device), n_valid.long() - 1]
    return _head_out(_head_weight(params), last), cache


def decode_step(params: dict, cfg: DecoderConfig, cache: list[dict],
                token: torch.Tensor, pos: int):
    """One incremental token: (B,) ids at position ``pos`` -> (B, V)
    logits; the dense cache is updated in place at ``pos`` and returned.
    Attention reads the cache rows <= pos only."""
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
        x = x + _proj(layer, a, "wo", "bo")
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj(layer, h, "w_up", "b_up"))
        x = x + _proj(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return _head_out(_head_weight(params), x[:, 0, :]), cache


def paged_decode_step(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                      token, positions, block_tables, slot_blocks,
                      slot_offsets):
    """One batched incremental token through the paged cache: each row's
    K/V lands at ``(slot_blocks[b], slot_offsets[b])`` and attention
    reads back through ``block_tables`` masked to ``positions + 1``
    tokens — the fused append+attend op (the kernel on the card).

    token/positions/slot_blocks/slot_offsets: (B,) int;
    block_tables: (B, NB) int.  Returns ``(logits, k_pool, v_pool)``."""
    from ..kvcache.paged_attention import append_attend_fn

    dtype = resolve_dtype(cfg.dtype, token.device)
    B = token.shape[0]
    hd = cfg.d_model // cfg.n_heads
    x = _embed_rows(params["embed"].to(dtype), token)[:, None, :]
    x = x + params["pos_embed"].to(dtype)[positions][:, None, :]
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
        x = x + _row_proj(layer, a.reshape(B, 1, -1), "wo", "bo")
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + _row_proj(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return _head_out(_head_weight(params), x[:, 0, :]), k_pool, v_pool


def paged_mixed_step(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                     tokens, positions, row_tables, row_start, row_nvalid,
                     row_token_idx, tok_row, tok_col, slot_blocks,
                     slot_offsets, logit_idx):
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
    LAST run token.  Returns ``(logits (B, V), k_pool, v_pool)``."""
    from ..kvcache.paged_attention import paged_attention_fn

    dtype = resolve_dtype(cfg.dtype, tokens.device)
    T = tokens.shape[0]
    hd = cfg.d_model // cfg.n_heads
    # clamp so a caller bug cannot index past the position table
    pos = torch.clamp(positions, max=cfg.max_len - 1)
    x = _embed_rows(params["embed"].to(dtype), tokens)
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
        x = x + _row_proj(layer, a.reshape(T, -1), "wo", "bo")
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        ff = act(_proj_p(layer, h, "w_up", "b_up"))
        x = x + _row_proj(layer, ff, "w_down", "b_down")
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return _head_out(_head_weight(params), x[logit_idx]), k_pool, v_pool


def paged_chained_decode(params: dict, cfg: DecoderConfig, k_pool, v_pool,
                         token, positions, block_tables, slot_blocks,
                         slot_offsets):
    """K greedy decode steps, step t's ids feeding step t+1 (the JAX
    package's ``lax.scan`` as a loop over :func:`paged_decode_step`).

    slot_blocks/slot_offsets: (B, K) per-step write slots, pre-reserved
    by the host; rows whose budget is < K point their surplus steps at
    the null block (their ids are discarded host-side).  Returns
    ``(ids (B, K) int32, k_pool, v_pool)``."""
    K = slot_blocks.shape[1]
    maxp = cfg.max_len - 1
    tok = token.to(torch.int32)
    ids = []
    for t in range(K):
        # surplus steps of a budget-exhausted row run at a clamped
        # position; real steps never reach the clamp
        pos = torch.clamp(positions + t, max=maxp)
        logits, k_pool, v_pool = paged_decode_step(
            params, cfg, k_pool, v_pool, tok, pos, block_tables,
            slot_blocks[:, t], slot_offsets[:, t],
        )
        tok = greedy(logits)
        ids.append(tok)
    return torch.stack(ids, dim=1), k_pool, v_pool


class TorchDecoderLM:
    """Host-facing text generator over the paged engine (counterpart of
    ``JaxDecoderLM``'s batched path)."""

    def __init__(self, cfg: DecoderConfig | None = None, seed: int = 0,
                 params: dict | None = None, tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or DecoderConfig()
        self.params = (params if params is not None
                       else init_decoder_params(self.cfg, seed, self.device))
        if tokenizer is None:
            from .tokenizer import HashTokenizer

            tokenizer = HashTokenizer(self.cfg.vocab_size)
        self.tokenizer = tokenizer
        self._engine = None

    def paged_engine(self, **kwargs):
        """The paged decode engine over this LM's weights, built on first
        use (keyed on the params object, so reassigning ``params``
        rebuilds it).  ``kwargs`` are ``PagedDecodeEngine`` sizes; they
        apply when the engine is built."""
        if self._engine is not None and self._engine[0] is self.params:
            return self._engine[1]
        from ..kvcache.engine import PagedDecodeEngine

        eng = PagedDecodeEngine(self.cfg, self.params, device=self.device,
                                **kwargs)
        self._engine = (self.params, eng)
        return eng

    def encode_prompts(self, prompts: list[str], max_new_tokens: int):
        """Token ids per prompt, trimmed to leave room for every new
        token (the JAX package's trimming rule)."""
        keep = self.cfg.max_len - max_new_tokens
        return [self.tokenizer.encode(p)[-max(keep, 1):] or [4]
                for p in prompts]

    def generate_batch(self, prompts: list[str], max_new_tokens: int = 32,
                       stop_token: int | None = None) -> list[str]:
        """Batched greedy completion through the paged KV cache: one
        engine pass decodes every prompt (mixed lengths, shared prefixes
        mapped to shared physical blocks)."""
        reqs = [(ids, max_new_tokens)
                for ids in self.encode_prompts(prompts, max_new_tokens)]
        outs = self.paged_engine().generate_batch(reqs, stop_token=stop_token)
        # the hash tokenizer cannot invert ids: each comes back as "<id>"
        return [" ".join(f"<{t}>" for t in toks) for toks in outs]


__all__ = [
    "DecoderConfig", "TorchDecoderLM", "decode_step", "greedy",
    "init_decoder_params", "paged_chained_decode", "paged_decode_step",
    "paged_mixed_step", "params_to", "plan_decode_params", "prefill",
]
