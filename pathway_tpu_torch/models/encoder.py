"""Transformer text encoder — the query/document embedder of the RAG path.

Plain functions on a parameter dict (the JAX package's pytree layout:
``[In, Out]`` matmul weights, ``x @ w``), so the same weights run in both
packages (``models/convert.py``).  Attention is plain einsum + f32
softmax, as in the JAX package: the encoder has no TPU kernel.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device, resolve_dtype
from ..ops._tiling import bucket_for


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 1536
    max_len: int = 512
    dtype: Any = "auto"  # bf16 on the card, f32 on the CPU
    # "pre" (training-friendly) or "post" (BERT family)
    ln_placement: str = "pre"
    act: str = "gelu_tanh"  # gelu (exact erf) | gelu_tanh | relu
    ln_eps: float = 1e-6


def init_params(cfg: EncoderConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from ``seed`` (drawn on the CPU with a
    ``torch.Generator``, so a seed gives the same weights on any device),
    f32, on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def ones():
        return torch.ones(cfg.d_model, device=dev)

    def zeros():
        return torch.zeros(cfg.d_model, device=dev)

    params: dict = {
        "embed": dense((cfg.vocab_size, cfg.d_model), 0.02),
        "pos_embed": dense((cfg.max_len, cfg.d_model), 0.02),
        "ln_f_scale": ones(),
        "ln_f_bias": zeros(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense((cfg.d_model, cfg.d_model)),
            "wk": dense((cfg.d_model, cfg.d_model)),
            "wv": dense((cfg.d_model, cfg.d_model)),
            "wo": dense((cfg.d_model, cfg.d_model)),
            "w_up": dense((cfg.d_model, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, cfg.d_model)),
            "ln1_scale": ones(), "ln1_bias": zeros(),
            "ln2_scale": ones(), "ln2_bias": zeros(),
        })
    return params


def params_to(params, device, dtype: torch.dtype):
    """Every tensor on ``device``; float matrices (embeddings and matmul
    weights) in the compute ``dtype``, so no per-call cast reads them
    again.  Vectors (layer norms, biases, an int8 plan's f32 ``{w}_s``
    scales) stay f32, as they are applied in f32, and integer tensors
    (an int8 plan's ``{w}_q`` weights) keep their dtype: they stay
    resident in int8."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    t = params.to(device)
    return t.to(dtype) if t.ndim >= 2 and t.is_floating_point() else t


def _layer_norm(x, scale, bias, eps=1e-6):
    """Layer norm computed in f32, cast back to the compute dtype."""
    out = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def _proj(layer, x, w_name: str, b_name: str):
    out = x @ layer[w_name].to(x.dtype)
    b = layer.get(b_name)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _act(name: str):
    if name == "gelu":
        return lambda v: F.gelu(v, approximate="none")
    if name == "gelu_tanh":
        return lambda v: F.gelu(v, approximate="tanh")
    return F.relu


def _attention(layer, x, mask, n_heads: int):
    """mask=None means every position is real (exact-fit bucket).  Q/K/V
    projections fused into one (D, 3D) matmul."""
    B, T, D = x.shape
    H = n_heads
    hd = D // H
    wqkv = torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=1).to(x.dtype)
    qkv = x @ wqkv
    if layer.get("bq") is not None:
        qkv = qkv + torch.cat(
            [layer["bq"], layer["bk"], layer["bv"]]
        ).to(x.dtype)
    q, k, v = qkv.split(D, dim=-1)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, H, hd)
    v = v.reshape(B, T, H, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    return _proj(layer, out, "wo", "bo")


def encode_tokens(params: dict, cfg: EncoderConfig, token_ids: torch.Tensor,
                  mask: torch.Tensor | None) -> torch.Tensor:
    """(B, T) -> (B, T, d_model) contextual embeddings."""
    dtype = resolve_dtype(cfg.dtype, token_ids.device)
    x = params["embed"].to(dtype)[token_ids]
    T = token_ids.shape[1]
    x = x + params["pos_embed"].to(dtype)[:T][None, :, :]
    eps = cfg.ln_eps
    if cfg.ln_placement == "post" and "ln_e_scale" in params:
        x = _layer_norm(x, params["ln_e_scale"], params["ln_e_bias"], eps)
    act = _act(cfg.act)
    for layer in params["layers"]:
        if cfg.ln_placement == "pre":
            h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
            x = x + _attention(layer, h, mask, cfg.n_heads)
            h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
            ff = act(_proj(layer, h, "w_up", "b_up"))
            x = x + _proj(layer, ff, "w_down", "b_down")
        else:  # post-LN (BERT family)
            a = _attention(layer, x, mask, cfg.n_heads)
            x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"], eps)
            ff = act(_proj(layer, x, "w_up", "b_up"))
            x = _layer_norm(
                x + _proj(layer, ff, "w_down", "b_down"),
                layer["ln2_scale"], layer["ln2_bias"], eps,
            )
    if cfg.ln_placement == "pre":
        x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], eps)
    return x


def encode(params: dict, cfg: EncoderConfig, token_ids: torch.Tensor,
           mask: torch.Tensor | None) -> torch.Tensor:
    """(B, T) int tokens + (B, T) bool mask -> (B, d_model) L2-normed f32;
    mask=None is the exact-fit path (all positions real)."""
    x = encode_tokens(params, cfg, token_ids, mask).float()
    # masked mean pooling + L2 norm (SentenceTransformer-style)
    if mask is None:
        pooled = x.mean(dim=1)
    else:
        m = mask[:, :, None].float()
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return pooled / (torch.linalg.norm(pooled, dim=-1, keepdim=True) + 1e-12)


class TorchEncoder:
    """Host-facing embedder: tokenize -> pad to a (batch, sequence)
    bucket -> forward on ``device``.  Counterpart of ``JaxEncoder``.

    ``stats`` accumulates per-stage wall time (``tokenize_s``, ``pad_s``,
    ``device_s``: the time to issue the forward, which on the card does
    not wait for it) and counts (``texts``, ``calls``)."""

    def __init__(self, cfg: EncoderConfig | None = None, seed: int = 0,
                 seq_buckets=(32, 128, 512), batch_buckets=(1, 8, 64, 256),
                 params: dict | None = None, tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        cfg = cfg or EncoderConfig()
        if isinstance(cfg.dtype, str):
            cfg = dataclasses.replace(
                cfg, dtype=resolve_dtype(cfg.dtype, self.device)
            )
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed, self.device)
        self.params = params_to(params, self.device, cfg.dtype)
        self.stats = {"tokenize_s": 0.0, "pad_s": 0.0, "device_s": 0.0,
                      "texts": 0, "calls": 0}
        self.seq_buckets = [b for b in seq_buckets if b <= cfg.max_len] or [
            cfg.max_len
        ]
        self.batch_buckets = list(batch_buckets)
        if tokenizer is None:
            from .tokenizer import HashTokenizer

            tokenizer = HashTokenizer(cfg.vocab_size)
        self.tokenizer = tokenizer
        self._store = None
        self._query_encoder = None
        self._host_batch = None
        self._cpu_mirror = None

    @classmethod
    def from_hf(cls, model_name_or_path: str, **kwargs) -> "TorchEncoder":
        """A locally stored BERT-family model (``models/hf_import.py``;
        needs ``transformers``)."""
        from .hf_import import load_hf_encoder

        params, cfg, hf_tok = load_hf_encoder(model_name_or_path)
        tok = _HFTokenizerAdapter(hf_tok) if hf_tok is not None else None
        return cls(cfg, params=params, tokenizer=tok, **kwargs)

    @property
    def dimensions(self) -> int:
        return self.cfg.d_model

    def _prepare(self, texts: list[str]):
        """Tokenize and pad one chunk: ``(ids (B, T) int64, mask (B, T)
        bool or None for an exact-fit bucket, n_valid)``."""
        t0 = time.perf_counter()
        toks = [self.tokenizer.encode(t)[: self.cfg.max_len] for t in texts]
        t1 = time.perf_counter()
        T = bucket_for(max(1, max(len(t) for t in toks)), self.seq_buckets)
        B = bucket_for(len(texts), self.batch_buckets)
        ids = np.zeros((B, T), np.int64)
        mask = np.zeros((B, T), bool)
        for i, t in enumerate(toks):
            t = t[:T]
            ids[i, : len(t)] = t
            mask[i, : len(t)] = True
        # exact-fit bucket: no padding anywhere -> no mask at all
        exact = len(texts) == B and bool(mask.all())
        self.stats["tokenize_s"] += t1 - t0
        self.stats["pad_s"] += time.perf_counter() - t1
        return ids, None if exact else mask, len(texts)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host -> device; on the card from pinned memory, without waiting
        (the pinned block is held until the copy has run)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _forward(self, ids: np.ndarray, mask) -> torch.Tensor:
        t0 = time.perf_counter()
        out = encode(self.params, self.cfg, self._to_device(ids),
                     None if mask is None else self._to_device(mask))
        self.stats["device_s"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        return out

    def _chunks(self, texts: list[str]):
        max_b = self.batch_buckets[-1]
        return [texts[i: i + max_b] for i in range(0, len(texts), max_b)]

    def embed_batch(self, texts: list[str]) -> torch.Tensor:
        """(len(texts), d_model) f32 embeddings, on the encoder's device;
        oversized batches are chunked at the largest batch bucket."""
        if not texts:
            return torch.zeros((0, self.cfg.d_model), device=self.device)
        outs = []
        for chunk in self._chunks(texts):
            ids, mask, n = self._prepare(chunk)
            outs.append(self._forward(ids, mask)[:n])
            self.stats["texts"] += n
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def embed_batch_device(self, texts: list[str], store=None) -> list:
        """Device-resident embed: the forward of each chunk (the largest
        batch bucket) is issued without synchronising or fetching, and its
        rows go into ``store`` (the encoder's own ``DeviceVecStore`` when
        None); returns one ``DeviceVec`` handle per text.  The ingest path:
        the KNN index takes the handles and consolidates rows on the
        device (``ops/device_store.py``)."""
        if store is None:
            if self._store is None:
                from ..ops.device_store import DeviceVecStore

                self._store = DeviceVecStore(self.cfg.d_model,
                                             device=self.device)
            store = self._store
        out = []
        for chunk in self._chunks(texts):
            ids, mask, n = self._prepare(chunk)
            out.extend(store.append_batch(self._forward(ids, mask),
                                          n_valid=n))
            self.stats["texts"] += n
        return out

    def host_batch(self):
        """The batched host tier (``models/host_encoder.py``
        ``TorchBatchEncoder``): ``encode`` over an f32 CPU copy of the
        weights, whichever device the encoder is on.  Built once."""
        if self._host_batch is None:
            from .host_encoder import TorchBatchEncoder

            self._host_batch = TorchBatchEncoder(self.cfg, self.params,
                                                 self.tokenizer)
        return self._host_batch

    def embed_batch_host(self, texts: list[str], chunk: int = 128
                         ) -> np.ndarray:
        """(len(texts), d_model) f32 embeddings as numpy, computed on the
        host in chunks of ``chunk`` texts (each padded to its own longest
        text); stage times land in ``stats``."""
        return self.host_batch().embed_batch(texts, chunk=chunk,
                                             stats=self.stats)

    def embed_batch_fastest(self, texts: list[str]):
        """Bulk embedding by device: device-resident handles on the card
        (nothing fetched), ``embed_batch`` on the CPU."""
        if self.device.type == "cuda":
            return self.embed_batch_device(texts)
        return self.embed_batch(texts)

    def cpu_mirror(self):
        """The host mirror for single texts (``models/host_encoder.py``
        ``make_host_mirror``): an f32 CPU copy of the weights.  Built
        once."""
        if self._cpu_mirror is None:
            from .host_encoder import make_host_mirror

            self._cpu_mirror = make_host_mirror(self.cfg, self.params,
                                                self.tokenizer)
        return self._cpu_mirror

    def compiled_query_encoder(self):
        """The single-query serving tier (``models/host_encoder.py``
        ``CompiledQueryEncoder``): one CUDA graph per query bucket on the
        card, the same function run eagerly on the CPU.  Built once."""
        if self._query_encoder is None:
            from .host_encoder import CompiledQueryEncoder

            self._query_encoder = CompiledQueryEncoder(
                self.cfg, self.params, self.tokenizer, device=self.device)
        return self._query_encoder

    def embed(self, text: str) -> torch.Tensor:
        return self.embed_batch([text])[0]


class _HFTokenizerAdapter:
    def __init__(self, hf_tok):
        self._tok = hf_tok

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def count_tokens(self, text: str) -> int:
        return len(self.encode(text))
