"""Carry weights across: the JAX package's parameter pytree (as numpy
arrays) -> the port's parameter dict on a device.

Both packages use the same layout — ``embed``/``pos_embed`` tables,
``ln_f_*`` vectors and a ``layers`` list of ``[In, Out]`` matmul weights
and layer-norm vectors — so conversion is a checked leaf-by-leaf copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .decoder import DecoderConfig
from .encoder import EncoderConfig


def _layer_shapes(d: int, f: int, h: int | None = None) -> dict:
    """A layer's leaves and their shapes; ``h`` (a decoder's heads) adds
    the SSD decay projections ``ssd_augment_params`` grafts."""
    ssd = {"w_a": (d, h), "b_a": (h,)} if h is not None else {}
    return {**ssd,
        "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
        "w_up": (d, f), "w_down": (f, d),
        "ln1_scale": (d,), "ln1_bias": (d,),
        "ln2_scale": (d,), "ln2_bias": (d,),
        "bq": (d,), "bk": (d,), "bv": (d,), "bo": (d,),
        "b_up": (f,), "b_down": (d,),
    }


def _convert(tree: dict, vocab: int, d: int, f: int, max_len: int,
             n_layers: int, device, n_heads: int | None = None) -> dict:
    dev = resolve_device(device)
    top = {"embed": (vocab, d), "pos_embed": (max_len, d),
           "ln_f_scale": (d,), "ln_f_bias": (d,),
           "ln_e_scale": (d,), "ln_e_bias": (d,)}
    required = ("embed", "pos_embed", "ln_f_scale", "ln_f_bias")
    layer_required = ("wq", "wk", "wv", "wo", "w_up", "w_down",
                      "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")

    def leaf(value, shape, where):
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{where}: shape {arr.shape}, expected {shape}")
        return torch.from_numpy(arr.copy()).to(dev)

    def convert(src: dict, shapes: dict, req, where: str) -> dict:
        missing = [k for k in req if k not in src]
        unknown = [k for k in src if k not in shapes and k != "layers"]
        if missing or unknown:
            raise ValueError(f"{where}: missing {missing}, unknown {unknown}")
        return {k: leaf(v, shapes[k], f"{where}.{k}")
                for k, v in src.items() if k != "layers"}

    out = convert(tree, top, required, "params")
    layers = tree.get("layers", [])
    if len(layers) != n_layers:
        raise ValueError(f"params: {len(layers)} layers, expected {n_layers}")
    out["layers"] = [
        convert(layer, _layer_shapes(d, f, n_heads), layer_required,
                f"params.layers[{i}]")
        for i, layer in enumerate(layers)
    ]
    return out


def encoder_params_from_numpy(tree: dict, cfg: EncoderConfig,
                              device="cuda") -> dict:
    """An encoder pytree of numpy arrays -> the port's f32 params."""
    return _convert(tree, cfg.vocab_size, cfg.d_model, cfg.d_ff,
                    cfg.max_len, cfg.n_layers, device)


def decoder_params_from_numpy(tree: dict, cfg: DecoderConfig,
                              device="cuda") -> dict:
    """A decoder pytree of numpy arrays -> the port's f32 params (an
    SSD-grafted pytree's ``w_a``/``b_a`` included)."""
    return _convert(tree, cfg.vocab_size, cfg.d_model, cfg.d_ff,
                    cfg.max_len, cfg.n_layers, device, cfg.n_heads)
