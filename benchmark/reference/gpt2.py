"""Plain GPT-2 in float32, the yardstick of the decoder cells.

The published architecture (Radford et al. 2019; the ``gpt2`` model of
HuggingFace transformers): learned token and position embeddings, pre-LN
blocks of causal multi-head attention and a tanh-GELU MLP, a final layer
norm and a head tied to the token table.  Weights are in the layout of
``weights.py`` (HuggingFace names, ``x @ w``).  Every product runs in
float32 with TF32 off, one layer at a time over all the sequences, so that
a 48-layer model needs one layer's weights in float32 at a time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import exact_f32


def _ln(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w.float(), b.float(), eps)


def _block(x, p, i, cfg, mask):
    """One pre-LN block over (S, T, D) hidden states."""
    S, T, D = x.shape
    H = cfg["n_head"]
    hd = D // H
    eps = cfg["layer_norm_epsilon"]
    g = lambda name: p[f"h.{i}.{name}"].float()  # noqa: E731
    h = _ln(x, g("ln_1.weight"), g("ln_1.bias"), eps)
    qkv = h @ g("attn.c_attn.weight") + g("attn.c_attn.bias")
    q, k, v = qkv.split(D, dim=-1)
    q = q.view(S, T, H, hd).transpose(1, 2)
    k = k.view(S, T, H, hd).transpose(1, 2)
    v = v.view(S, T, H, hd).transpose(1, 2)
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    att = att.masked_fill(~mask, float("-inf")).softmax(dim=-1)
    a = (att @ v).transpose(1, 2).reshape(S, T, D)
    x = x + a @ g("attn.c_proj.weight") + g("attn.c_proj.bias")
    h = _ln(x, g("ln_2.weight"), g("ln_2.bias"), eps)
    m = F.gelu(h @ g("mlp.c_fc.weight") + g("mlp.c_fc.bias"),
               approximate="tanh")
    return x + m @ g("mlp.c_proj.weight") + g("mlp.c_proj.bias")


def logits_at(weights: dict, cfg: dict, seqs: list[torch.Tensor],
              positions: list[torch.Tensor], chunk: int = 8) -> list:
    """The (len(positions[s]), vocab) float32 logits of each sequence
    ``seqs[s]`` (token ids) at the given positions.  Sequences run in
    groups of ``chunk``, each padded on the right to its longest member
    (causal attention: padding never reaches a real position)."""
    out = []
    with exact_f32():
        for c0 in range(0, len(seqs), chunk):
            group = seqs[c0:c0 + chunk]
            T = max(len(s) for s in group)
            dev = weights["wte.weight"].device
            ids = torch.zeros((len(group), T), dtype=torch.long, device=dev)
            for j, s in enumerate(group):
                ids[j, : len(s)] = s.to(dev)
            x = (weights["wte.weight"].float()[ids]
                 + weights["wpe.weight"].float()[:T][None])
            mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
            for i in range(cfg["n_layer"]):
                x = _block(x, weights, i, cfg, mask)
            for j, pos in enumerate(positions[c0:c0 + chunk]):
                h = _ln(x[j, pos.to(dev)], weights["ln_f.weight"],
                        weights["ln_f.bias"], cfg["layer_norm_epsilon"])
                out.append(h @ weights["wte.weight"].float().T)
    return out


def greedy_gaps(weights: dict, cfg: dict, prompts: list, served: list,
                chunk: int = 8) -> list[torch.Tensor]:
    """For each request, the gap by which each served token's reference
    logit lies below the reference's best at its position (0 where the
    served token is the reference's argmax).  ``prompts[r]`` and
    ``served[r]`` are token-id sequences; token ``j`` of ``served[r]`` was
    chosen at position ``len(prompt) - 1 + j``."""
    seqs, poss = [], []
    for p, s in zip(prompts, served):
        p = torch.as_tensor(p, dtype=torch.long)
        s = torch.as_tensor(s, dtype=torch.long)
        seqs.append(torch.cat([p, s[:-1]]))
        poss.append(torch.arange(len(p) - 1, len(p) - 1 + len(s)))
    gaps = []
    for logits, s in zip(logits_at(weights, cfg, seqs, poss, chunk), served):
        s = torch.as_tensor(s, dtype=torch.long, device=logits.device)
        best = logits.max(dim=-1).values
        gaps.append((best - logits.gather(1, s[:, None])[:, 0]).cpu())
    return gaps
