"""Carry weights across: the JAX package's parameter pytree (as numpy
arrays) -> the port's parameter dict on a device.

Both packages use the same layout — ``embed``/``pos_embed`` tables,
``ln_f_*`` vectors and a ``layers`` list of ``[In, Out]`` matmul weights
and layer-norm vectors; CLIP's ``v_*``/``t_*`` leaves and its two layer
lists — so conversion is a checked leaf-by-leaf copy.  A gradient tree
has its parameters' layout and converts the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .clip import ClipConfig
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


_LAYER_REQUIRED = ("wq", "wk", "wv", "wo", "w_up", "w_down",
                   "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _convert_dict(src: dict, shapes: dict, required, where: str, dev,
                  lists=("layers",)) -> dict:
    """The leaves of ``src`` (its ``lists`` aside) as f32 tensors on
    ``dev``, each checked against its shape in ``shapes``."""
    missing = [k for k in required if k not in src]
    unknown = [k for k in src if k not in shapes and k not in lists]
    if missing or unknown:
        raise ValueError(f"{where}: missing {missing}, unknown {unknown}")
    out = {}
    for k, v in src.items():
        if k in lists:
            continue
        arr = np.asarray(v, dtype=np.float32)
        if arr.shape != shapes[k]:
            raise ValueError(
                f"{where}.{k}: shape {arr.shape}, expected {shapes[k]}")
        out[k] = torch.from_numpy(arr.copy()).to(dev)
    return out


def _convert_layers(layers, n_layers: int, shapes: dict, required,
                    where: str, dev) -> list:
    if len(layers) != n_layers:
        raise ValueError(f"{where}: {len(layers)} layers, expected {n_layers}")
    return [_convert_dict(layer, shapes, required, f"{where}[{i}]", dev)
            for i, layer in enumerate(layers)]


def _convert(tree: dict, vocab: int, d: int, f: int, max_len: int,
             n_layers: int, device, n_heads: int | None = None) -> dict:
    dev = resolve_device(device)
    top = {"embed": (vocab, d), "pos_embed": (max_len, d),
           "ln_f_scale": (d,), "ln_f_bias": (d,),
           "ln_e_scale": (d,), "ln_e_bias": (d,)}
    required = ("embed", "pos_embed", "ln_f_scale", "ln_f_bias")
    out = _convert_dict(tree, top, required, "params", dev)
    out["layers"] = _convert_layers(
        tree.get("layers", []), n_layers, _layer_shapes(d, f, n_heads),
        _LAYER_REQUIRED, "params.layers", dev)
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


def clip_params_from_numpy(tree: dict, cfg: ClipConfig,
                           device="cuda") -> dict:
    """A CLIP pytree of numpy arrays (``pathway_tpu/models/clip.py``'s
    layout) -> the port's f32 CLIP params, every leaf required and
    checked against its shape."""
    dev = resolve_device(device)
    v, t, p = cfg.vision, cfg.text, cfg.projection_dim
    top = {"v_patch": (v.patch_size * v.patch_size * 3, v.d_model),
           "v_class": (v.d_model,), "v_pos": (v.n_patches + 1, v.d_model),
           "v_pre_scale": (v.d_model,), "v_pre_bias": (v.d_model,),
           "v_post_scale": (v.d_model,), "v_post_bias": (v.d_model,),
           "v_proj": (v.d_model, p),
           "t_embed": (t.vocab_size, t.d_model),
           "t_pos": (t.max_len, t.d_model),
           "t_final_scale": (t.d_model,), "t_final_bias": (t.d_model,),
           "t_proj": (t.d_model, p), "logit_scale": ()}
    lists = ("v_layers", "t_layers")
    out = _convert_dict(tree, top, tuple(top) + lists, "params", dev, lists)
    for name, c in (("v_layers", v), ("t_layers", t)):
        shapes = _layer_shapes(c.d_model, c.d_ff)
        out[name] = _convert_layers(tree[name], c.n_layers, shapes,
                                    tuple(shapes), f"params.{name}", dev)
    return out
