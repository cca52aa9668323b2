"""CLIP-class dual encoder — the multimodal model of the RAG path
(``BASELINE.md`` config 5, multimodal RAG): images and texts land in one
embedding space, so a text query retrieves images through the port's
``BruteForceKnn``.

Counterpart of ``pathway_tpu/models/clip.py``: plain functions on the
JAX package's parameter-dict layout (``[In, Out]`` matmul weights,
``x @ w``), so the same weights run in both (``models/convert.py``
``clip_params_from_numpy``), and HF ``CLIPModel`` weights map onto them
(:func:`params_from_clip_state_dict`).  Attention is plain einsum with an
f32 softmax, as in the JAX package: CLIP's towers have no TPU kernel.

Patch embedding is the conv-as-matmul identity: a stride-P conv over
P x P patches equals reshaping to (B, n_patches, P*P*3) and one matmul.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from .encoder import _layer_norm, params_to

# images a forward of ``TorchClip.embed_image_batch``
IMAGE_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    ln_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_len: int = 77
    d_model: int = 512
    n_layers: int = 12
    n_heads: int = 8
    d_ff: int = 2048
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    vision: ClipVisionConfig = ClipVisionConfig()
    text: ClipTextConfig = ClipTextConfig()
    projection_dim: int = 512
    dtype: Any = "auto"  # bf16 on the card, f32 on the CPU


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def init_clip_params(cfg: ClipConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from ``seed`` (drawn on the CPU with a
    ``torch.Generator``, so a seed gives the same weights on any device),
    f32, on ``device``; the JAX initialiser's scales."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    v, t = cfg.vision, cfg.text

    def normal(*shape, scale=0.02):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def ones(n):
        return torch.ones(n, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    def block(d, ff):
        def dense(i, o):
            return normal(i, o, scale=1.0 / math.sqrt(i))

        return {
            "wq": dense(d, d), "bq": zeros(d), "wk": dense(d, d),
            "bk": zeros(d), "wv": dense(d, d), "bv": zeros(d),
            "wo": dense(d, d), "bo": zeros(d),
            "w_up": dense(d, ff), "b_up": zeros(ff),
            "w_down": dense(ff, d), "b_down": zeros(d),
            "ln1_scale": ones(d), "ln1_bias": zeros(d),
            "ln2_scale": ones(d), "ln2_bias": zeros(d),
        }

    return {
        "v_patch": normal(v.patch_size * v.patch_size * 3, v.d_model),
        "v_class": normal(v.d_model),
        "v_pos": normal(v.n_patches + 1, v.d_model),
        "v_pre_scale": ones(v.d_model), "v_pre_bias": zeros(v.d_model),
        "v_post_scale": ones(v.d_model), "v_post_bias": zeros(v.d_model),
        "v_proj": normal(v.d_model, cfg.projection_dim),
        "t_embed": normal(t.vocab_size, t.d_model),
        "t_pos": normal(t.max_len, t.d_model),
        "t_final_scale": ones(t.d_model), "t_final_bias": zeros(t.d_model),
        "t_proj": normal(t.d_model, cfg.projection_dim),
        "logit_scale": torch.tensor(math.log(1 / 0.07), device=dev),
        "v_layers": [block(v.d_model, v.d_ff) for _ in range(v.n_layers)],
        "t_layers": [block(t.d_model, t.d_ff) for _ in range(t.n_layers)],
    }


def _lin(h, layer, w: str, b: str):
    return h @ layer[w].to(h.dtype) + layer[b].to(h.dtype)


def _block(layer, x, n_heads: int, eps: float, causal: bool):
    B, T, D = x.shape
    hd = D // n_heads
    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
    q = _lin(h, layer, "wq", "bq").reshape(B, T, n_heads, hd)
    k = _lin(h, layer, "wk", "bk").reshape(B, T, n_heads, hd)
    v = _lin(h, layer, "wv", "bv").reshape(B, T, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=x.device))
        scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
    a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    x = x + _lin(a, layer, "wo", "bo")
    h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
    ff = _quick_gelu(_lin(h, layer, "w_up", "b_up"))
    return x + _lin(ff, layer, "w_down", "b_down")


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches, patch*patch*3), channel-major per
    patch to match the conv kernel layout (C, P, P) flattened."""
    B, H, W, C = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, ph, pw)
    return x.reshape(B, gh * gw, C * patch * patch)


def _normalised(out: torch.Tensor) -> torch.Tensor:
    out = out.float()
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)


def encode_image(params: dict, cfg: ClipConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float pixels -> (B, projection_dim) L2-normed f32."""
    v = cfg.vision
    dtype = resolve_dtype(cfg.dtype, pixels.device)
    patches = patchify(pixels.to(dtype), v.patch_size)
    x = patches @ params["v_patch"].to(dtype)
    cls = params["v_class"].to(dtype)[None, None, :].expand(
        x.shape[0], 1, v.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["v_pos"].to(dtype)[None, :, :]
    x = _layer_norm(x, params["v_pre_scale"], params["v_pre_bias"], v.ln_eps)
    for layer in params["v_layers"]:
        x = _block(layer, x, v.n_heads, v.ln_eps, causal=False)
    pooled = _layer_norm(x[:, 0, :], params["v_post_scale"],
                         params["v_post_bias"], v.ln_eps)
    return _normalised(pooled @ params["v_proj"].to(pooled.dtype))


def encode_text(params: dict, cfg: ClipConfig, token_ids: torch.Tensor,
                n_valid: torch.Tensor) -> torch.Tensor:
    """(B, T) int tokens (+ per-row valid count) -> (B, projection_dim).
    Pooling takes the hidden state at position n_valid-1 (the EOT token),
    as HF CLIPTextModel does."""
    t = cfg.text
    dtype = resolve_dtype(cfg.dtype, token_ids.device)
    token_ids = token_ids.long()
    x = params["t_embed"].to(dtype)[token_ids]
    T = token_ids.shape[1]
    x = x + params["t_pos"].to(dtype)[:T][None, :, :]
    for layer in params["t_layers"]:
        x = _block(layer, x, t.n_heads, t.ln_eps, causal=True)
    x = _layer_norm(x, params["t_final_scale"], params["t_final_bias"],
                    t.ln_eps)
    eot = x[torch.arange(x.shape[0], device=x.device), n_valid.long() - 1]
    return _normalised(eot @ params["t_proj"].to(eot.dtype))


def params_from_clip_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """A transformers ``CLIPModel`` state dict -> CLIP params (f32 CPU
    tensors; :class:`TorchClip` moves them to its device)."""

    def g(name):
        return sd[name].detach().cpu().float().clone()

    def block(prefix, i):
        p = f"{prefix}.encoder.layers.{i}"
        return {
            "wq": g(f"{p}.self_attn.q_proj.weight").T.contiguous(),
            "bq": g(f"{p}.self_attn.q_proj.bias"),
            "wk": g(f"{p}.self_attn.k_proj.weight").T.contiguous(),
            "bk": g(f"{p}.self_attn.k_proj.bias"),
            "wv": g(f"{p}.self_attn.v_proj.weight").T.contiguous(),
            "bv": g(f"{p}.self_attn.v_proj.bias"),
            "wo": g(f"{p}.self_attn.out_proj.weight").T.contiguous(),
            "bo": g(f"{p}.self_attn.out_proj.bias"),
            "w_up": g(f"{p}.mlp.fc1.weight").T.contiguous(),
            "b_up": g(f"{p}.mlp.fc1.bias"),
            "w_down": g(f"{p}.mlp.fc2.weight").T.contiguous(),
            "b_down": g(f"{p}.mlp.fc2.bias"),
            "ln1_scale": g(f"{p}.layer_norm1.weight"),
            "ln1_bias": g(f"{p}.layer_norm1.bias"),
            "ln2_scale": g(f"{p}.layer_norm2.weight"),
            "ln2_bias": g(f"{p}.layer_norm2.bias"),
        }

    conv = g("vision_model.embeddings.patch_embedding.weight")  # (D, 3, P, P)
    return {
        "v_patch": conv.reshape(conv.shape[0], -1).T.contiguous(),
        "v_class": g("vision_model.embeddings.class_embedding"),
        "v_pos": g("vision_model.embeddings.position_embedding.weight"),
        "v_pre_scale": g("vision_model.pre_layrnorm.weight"),
        "v_pre_bias": g("vision_model.pre_layrnorm.bias"),
        "v_post_scale": g("vision_model.post_layernorm.weight"),
        "v_post_bias": g("vision_model.post_layernorm.bias"),
        "v_proj": g("visual_projection.weight").T.contiguous(),
        "t_embed": g("text_model.embeddings.token_embedding.weight"),
        "t_pos": g("text_model.embeddings.position_embedding.weight"),
        "t_final_scale": g("text_model.final_layer_norm.weight"),
        "t_final_bias": g("text_model.final_layer_norm.bias"),
        "t_proj": g("text_projection.weight").T.contiguous(),
        "logit_scale": g("logit_scale"),
        "v_layers": [block("vision_model", i)
                     for i in range(cfg.vision.n_layers)],
        "t_layers": [block("text_model", i)
                     for i in range(cfg.text.n_layers)],
    }


def clip_config_from_hf(hf_cfg) -> ClipConfig:
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    return ClipConfig(
        vision=ClipVisionConfig(
            image_size=v.image_size, patch_size=v.patch_size,
            d_model=v.hidden_size, n_layers=v.num_hidden_layers,
            n_heads=v.num_attention_heads, d_ff=v.intermediate_size,
            ln_eps=v.layer_norm_eps,
        ),
        text=ClipTextConfig(
            vocab_size=t.vocab_size, max_len=t.max_position_embeddings,
            d_model=t.hidden_size, n_layers=t.num_hidden_layers,
            n_heads=t.num_attention_heads, d_ff=t.intermediate_size,
            ln_eps=t.layer_norm_eps,
        ),
        projection_dim=hf_cfg.projection_dim,
        dtype=torch.float32,
    )


class TorchClip:
    """Host-facing multimodal embedder (counterpart of ``JaxClip``):
    images and texts land in ONE shared embedding space, so a text query
    retrieves images directly.  Its weights live on ``device`` (matrices
    in the compute dtype: bf16 on the card, f32 on the CPU)."""

    def __init__(self, cfg: ClipConfig | None = None, seed: int = 0,
                 params: dict | None = None, tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        cfg = cfg or ClipConfig()
        if isinstance(cfg.dtype, str):
            cfg = dataclasses.replace(
                cfg, dtype=resolve_dtype(cfg.dtype, self.device))
        self.cfg = cfg
        if params is None:
            params = init_clip_params(cfg, seed, self.device)
        self.params = params_to(params, self.device, cfg.dtype)
        if tokenizer is None:
            from .tokenizer import HashTokenizer

            tokenizer = HashTokenizer(cfg.text.vocab_size)
        self.tokenizer = tokenizer

    @classmethod
    def from_hf(cls, model_name_or_path: str, **kwargs) -> "TorchClip":
        """A locally stored HF CLIP model (``transformers`` is imported
        only here; no network).  ``kwargs`` are the constructor's."""
        from transformers import CLIPModel

        try:
            from transformers import CLIPTokenizer

            tok = CLIPTokenizer.from_pretrained(model_name_or_path)
        except (OSError, ValueError, TypeError):
            # no tokenizer files beside the weights: the hash tokenizer
            tok = None
        model = CLIPModel.from_pretrained(model_name_or_path)
        cfg = clip_config_from_hf(model.config)
        params = params_from_clip_state_dict(model.state_dict(), cfg)
        adapter = _ClipTokenizerAdapter(tok) if tok is not None else None
        return cls(cfg, params=params, tokenizer=adapter, **kwargs)

    @property
    def dimensions(self) -> int:
        return self.cfg.projection_dim

    def _pixels(self, image) -> np.ndarray:
        """(H, W, 3) in [0, 1] or [0, 255] -> f32 in [0, 1] at the
        model's size (nearest-neighbour), as ``JaxClip.embed_image``."""
        px = np.asarray(image, np.float32)
        if px.max() > 2.0:
            px = px / 255.0
        v = self.cfg.vision
        if px.shape[:2] != (v.image_size, v.image_size):
            px = _resize_nearest(px, v.image_size)
        return px

    def _image_rows(self, px: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(px)).to(self.device)
            return encode_image(self.params, self.cfg, x).cpu().numpy()

    def embed_image(self, image) -> np.ndarray:
        """One image's (projection_dim,) f32 embedding; the image is
        resized or cropped by the caller (parsers decode it)."""
        return self._image_rows(self._pixels(image)[None])[0]

    def embed_image_batch(self, images) -> np.ndarray:
        """(N, projection_dim) f32: the images in forwards of
        ``IMAGE_CHUNK``, each row :meth:`embed_image` of its image."""
        px = np.stack([self._pixels(im) for im in images])
        return np.concatenate([self._image_rows(px[i:i + IMAGE_CHUNK])
                               for i in range(0, len(px), IMAGE_CHUNK)])

    def embed_text(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text)[: self.cfg.text.max_len] or [0]
        buf = np.zeros((1, self.cfg.text.max_len), np.int64)
        buf[0, : len(ids)] = ids
        with torch.no_grad():
            out = encode_text(
                self.params, self.cfg, torch.from_numpy(buf).to(self.device),
                torch.tensor([len(ids)], device=self.device))
        return out.cpu().numpy()[0]

    def similarity(self, text: str, image) -> float:
        tv = self.embed_text(text)
        iv = self.embed_image(image)
        scale = float(np.exp(float(self.params["logit_scale"])))
        return float(scale * tv @ iv)


class _ClipTokenizerAdapter:
    def __init__(self, tok):
        self._tok = tok

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)


def _resize_nearest(px: np.ndarray, size: int) -> np.ndarray:
    h, w = px.shape[:2]
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    return px[yi][:, xi]
