"""Plain BERT encoder in float32 with mean pooling: the yardstick of the
query encoder (all-MiniLM-L6-v2's architecture, Reimers & Gurevych 2019,
as sentence-transformers runs it: BERT post-LN blocks, exact-erf GELU,
the mean of the token states, L2-normalised).

Weights are in the layout of ``weights.py`` (HuggingFace BERT names,
``x @ w``).  One departure from the published model: the tokenizer is the
configuration's hash tokenizer (``tokenizer.py``), which adds no [CLS] or
[SEP] token.  ``round_fn`` rounds each product's two inputs: the identity
for the reference, ``precision.fp8_round`` for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import tokenizer
from .precision import exact_f32


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"].float(),
                        p[name + ".bias"].float(), eps)


def embed(weights: dict, cfg: dict, text: str, round_fn=None) -> torch.Tensor:
    """(hidden,) float32 unit vector of one text."""
    r = round_fn or (lambda t: t)
    ids = tokenizer.encode(text, cfg["vocab_size"])[: cfg[
        "max_position_embeddings"]] or [0]
    dev = weights["embeddings.word_embeddings.weight"].device
    ids = torch.tensor(ids, dtype=torch.long, device=dev)
    T, D = len(ids), cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    hd = D // H
    eps = cfg["layer_norm_eps"]

    def lin(x, name):
        return (r(x) @ r(weights[name + ".weight"].float())
                + weights[name + ".bias"].float())

    with exact_f32():
        x = (weights["embeddings.word_embeddings.weight"].float()[ids]
             + weights["embeddings.position_embeddings.weight"].float()[:T]
             + weights["embeddings.token_type_embeddings.weight"].float()[0])
        x = _ln(x, weights, "embeddings.LayerNorm", eps)
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layer.{i}."
            q = lin(x, p + "attention.self.query").view(T, H, hd)
            k = lin(x, p + "attention.self.key").view(T, H, hd)
            v = lin(x, p + "attention.self.value").view(T, H, hd)
            att = torch.einsum("qhd,khd->hqk", r(q), r(k)) / math.sqrt(hd)
            a = torch.einsum("hqk,khd->qhd", r(att.softmax(-1)),
                             r(v)).reshape(T, D)
            x = _ln(x + lin(a, p + "attention.output.dense"), weights,
                    p + "attention.output.LayerNorm", eps)
            f = F.gelu(lin(x, p + "intermediate.dense"))
            x = _ln(x + lin(f, p + "output.dense"), weights,
                    p + "output.LayerNorm", eps)
        pooled = x.mean(0)
        return pooled / pooled.norm().clamp(min=1e-12)
