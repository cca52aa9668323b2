"""Random weights and index rows made from the run's seed, on the device,
in the type they are served in, with a few large draws.

The layouts are HuggingFace's names with every matrix as ``[in, out]``
(``x @ w``; GPT-2's own Conv1D layout).  Each model's tensors are views
of one flat buffer filled by one normal draw: matrices and biases keep the
draw (standard deviation ``initializer_range``), layer-norm gains are one
plus it.  The benchmark hands the same tensors to the program and to the
reference.
"""

from __future__ import annotations

import torch


def _views(shapes: list[tuple[str, tuple]], seed: int, std: float, device,
           dtype) -> dict:
    total = sum(_numel(s) for _n, s in shapes)
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat.normal_(0.0, std, generator=g)
    out, off = {}, 0
    for name, shape in shapes:
        n = _numel(shape)
        t = flat[off:off + n].view(shape)
        if name.endswith("ln_1.weight") or name.endswith("ln_2.weight") \
                or name.endswith("ln_f.weight") or name.endswith(
                    "LayerNorm.weight"):
            t.add_(1.0)
        out[name] = t
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def gpt2_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    D, F = cfg["n_embd"], cfg["n_inner"] or 4 * cfg["n_embd"]
    shapes = [("wte.weight", (cfg["vocab_size"], D)),
              ("wpe.weight", (cfg["n_positions"], D))]
    for i in range(cfg["n_layer"]):
        p = f"h.{i}."
        shapes += [(p + "ln_1.weight", (D,)), (p + "ln_1.bias", (D,)),
                   (p + "attn.c_attn.weight", (D, 3 * D)),
                   (p + "attn.c_attn.bias", (3 * D,)),
                   (p + "attn.c_proj.weight", (D, D)),
                   (p + "attn.c_proj.bias", (D,)),
                   (p + "ln_2.weight", (D,)), (p + "ln_2.bias", (D,)),
                   (p + "mlp.c_fc.weight", (D, F)), (p + "mlp.c_fc.bias", (F,)),
                   (p + "mlp.c_proj.weight", (F, D)),
                   (p + "mlp.c_proj.bias", (D,))]
    return shapes + [("ln_f.weight", (D,)), ("ln_f.bias", (D,))]


def gpt2_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    return _views(gpt2_shapes(cfg), seed, cfg["initializer_range"], device,
                  dtype)


def bert_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    e = "embeddings."
    shapes = [(e + "word_embeddings.weight", (cfg["vocab_size"], D)),
              (e + "position_embeddings.weight",
               (cfg["max_position_embeddings"], D)),
              (e + "token_type_embeddings.weight",
               (cfg["type_vocab_size"], D)),
              (e + "LayerNorm.weight", (D,)), (e + "LayerNorm.bias", (D,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            shapes += [(p + name + ".weight", (D, D)), (p + name + ".bias",
                                                        (D,))]
        shapes += [(p + "attention.output.LayerNorm.weight", (D,)),
                   (p + "attention.output.LayerNorm.bias", (D,)),
                   (p + "intermediate.dense.weight", (D, F)),
                   (p + "intermediate.dense.bias", (F,)),
                   (p + "output.dense.weight", (F, D)),
                   (p + "output.dense.bias", (D,)),
                   (p + "output.LayerNorm.weight", (D,)),
                   (p + "output.LayerNorm.bias", (D,))]
    return shapes


def bert_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    return _views(bert_shapes(cfg), seed, cfg["initializer_range"], device,
                  dtype)


def index_blocks(n_rows: int, dim: int, seed: int, device,
                 block_rows: int = 1 << 18):
    """The index's rows, standard normal float32, as (block_rows, dim)
    blocks (the last one shorter), drawn in order from one generator: the
    same seed gives the same rows, so the reference can draw them again."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for start in range(0, n_rows, block_rows):
        n = min(block_rows, n_rows - start)
        yield torch.randn((n, dim), generator=g, device=device,
                          dtype=torch.float32)
