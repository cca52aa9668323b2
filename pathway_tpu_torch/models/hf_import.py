"""Import HuggingFace weights into the port's encoder and decoder.

Counterpart of ``pathway_tpu/models/hf_import.py``: a BERT-family state
dict maps onto ``EncoderConfig(ln_placement="post")`` parameters, and a
GPT-2-family one onto ``DecoderConfig`` parameters, in the layout both
packages share (``[In, Out]`` matmul weights, ``x @ w``).  The converters
read numpy arrays or torch tensors and return f32 CPU tensors; the model
classes move them to their device.  ``load_hf_*`` read a locally stored
model through ``transformers``, imported only when called (no network).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .decoder import DecoderConfig
from .encoder import EncoderConfig

_ACT_MAP = {
    "gelu": "gelu",  # HF "gelu" is the exact erf form
    "gelu_new": "gelu_tanh",
    "gelu_pytorch_tanh": "gelu_tanh",
    "gelu_fast": "gelu_tanh",
    "relu": "relu",
}


def _getter(state: dict[str, Any], prefixes: tuple[str, ...]):
    def get(name: str) -> np.ndarray:
        for prefix in prefixes:
            key = prefix + name
            if key in state:
                v = state[key]
                if isinstance(v, torch.Tensor):
                    v = v.detach().cpu().numpy()
                return np.asarray(v)
        raise KeyError(name)

    return get


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def config_from_hf(hf_config) -> EncoderConfig:
    if getattr(hf_config, "model_type", None) != "bert":
        raise ValueError(
            f"expected a BERT-family config, got model_type="
            f"{getattr(hf_config, 'model_type', None)!r} (GPT-2-family models "
            "load via config_from_gpt2)"
        )
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in _ACT_MAP:
        raise ValueError(
            f"unsupported hidden_act {act!r}; supported: {sorted(_ACT_MAP)}"
        )
    pos_type = getattr(hf_config, "position_embedding_type", "absolute")
    if pos_type != "absolute":
        raise ValueError(
            f"unsupported position_embedding_type {pos_type!r}; only "
            "'absolute' BERT-family models map onto this encoder"
        )
    return EncoderConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_ff=hf_config.intermediate_size,
        max_len=hf_config.max_position_embeddings,
        dtype=torch.float32,
        ln_placement="post",
        act=_ACT_MAP[act],
        ln_eps=float(getattr(hf_config, "layer_norm_eps", 1e-12)),
    )


def params_from_bert_state_dict(state: dict[str, Any],
                                cfg: EncoderConfig) -> dict:
    """A BERT state dict (``bert.`` prefix or none) -> encoder params.
    Linear weights transpose (torch stores (out, in)); the segment-0
    token-type embedding folds into the word embedding table."""
    get = _getter(state, ("", "bert."))

    def lin_w(name: str) -> torch.Tensor:
        return _t(get(name).T)

    embed = get("embeddings.word_embeddings.weight").astype(np.float32)
    try:
        tt = get("embeddings.token_type_embeddings.weight")[0]
        embed = embed + tt.astype(np.float32)[None, :]
    except KeyError:
        pass
    params: dict = {
        "embed": _t(embed),
        "pos_embed": _t(get("embeddings.position_embeddings.weight")),
        "ln_e_scale": _t(get("embeddings.LayerNorm.weight")),
        "ln_e_bias": _t(get("embeddings.LayerNorm.bias")),
        # post-LN models have no final LN; identity keeps the layout
        "ln_f_scale": torch.ones(cfg.d_model),
        "ln_f_bias": torch.zeros(cfg.d_model),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        params["layers"].append({
            "wq": lin_w(p + "attention.self.query.weight"),
            "bq": _t(get(p + "attention.self.query.bias")),
            "wk": lin_w(p + "attention.self.key.weight"),
            "bk": _t(get(p + "attention.self.key.bias")),
            "wv": lin_w(p + "attention.self.value.weight"),
            "bv": _t(get(p + "attention.self.value.bias")),
            "wo": lin_w(p + "attention.output.dense.weight"),
            "bo": _t(get(p + "attention.output.dense.bias")),
            "w_up": lin_w(p + "intermediate.dense.weight"),
            "b_up": _t(get(p + "intermediate.dense.bias")),
            "w_down": lin_w(p + "output.dense.weight"),
            "b_down": _t(get(p + "output.dense.bias")),
            "ln1_scale": _t(get(p + "attention.output.LayerNorm.weight")),
            "ln1_bias": _t(get(p + "attention.output.LayerNorm.bias")),
            "ln2_scale": _t(get(p + "output.LayerNorm.weight")),
            "ln2_bias": _t(get(p + "output.LayerNorm.bias")),
        })
    return params


def config_from_gpt2(hf_config) -> DecoderConfig:
    """GPT-2-family config -> DecoderConfig (pre-LN, tanh gelu, tied head)."""
    if getattr(hf_config, "model_type", None) != "gpt2":
        raise ValueError(
            f"expected a GPT-2-family config, got model_type="
            f"{getattr(hf_config, 'model_type', None)!r} (BERT-family models "
            "load via TorchEncoder.from_hf)"
        )
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in _ACT_MAP:
        raise ValueError(f"unsupported activation_function {act!r}")
    return DecoderConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        d_ff=getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd,
        max_len=hf_config.n_positions,
        dtype=torch.float32,
        ln_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        act=_ACT_MAP[act],
    )


def params_from_gpt2_state_dict(state: dict[str, Any], cfg) -> dict:
    """A GPT-2 state dict (``transformer.`` prefix or none) -> decoder
    params.  GPT-2's Conv1D weights are already (in, out); the fused
    c_attn splits into q, k, v; the head is tied to ``wte``."""
    get = _getter(state, ("", "transformer."))
    D = cfg.d_model
    params: dict = {
        "embed": _t(get("wte.weight")),
        "pos_embed": _t(get("wpe.weight")),
        "ln_f_scale": _t(get("ln_f.weight")),
        "ln_f_bias": _t(get("ln_f.bias")),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        c_attn_w = get(p + "attn.c_attn.weight")  # (D, 3D)
        c_attn_b = get(p + "attn.c_attn.bias")    # (3D,)
        params["layers"].append({
            "wq": _t(c_attn_w[:, :D]),
            "bq": _t(c_attn_b[:D]),
            "wk": _t(c_attn_w[:, D: 2 * D]),
            "bk": _t(c_attn_b[D: 2 * D]),
            "wv": _t(c_attn_w[:, 2 * D:]),
            "bv": _t(c_attn_b[2 * D:]),
            "wo": _t(get(p + "attn.c_proj.weight")),
            "bo": _t(get(p + "attn.c_proj.bias")),
            "w_up": _t(get(p + "mlp.c_fc.weight")),
            "b_up": _t(get(p + "mlp.c_fc.bias")),
            "w_down": _t(get(p + "mlp.c_proj.weight")),
            "b_down": _t(get(p + "mlp.c_proj.bias")),
            "ln1_scale": _t(get(p + "ln_1.weight")),
            "ln1_bias": _t(get(p + "ln_1.bias")),
            "ln2_scale": _t(get(p + "ln_2.weight")),
            "ln2_bias": _t(get(p + "ln_2.bias")),
        })
    return params


def _load(model_name_or_path: str, to_config, to_params):
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    hf_cfg = AutoConfig.from_pretrained(model_name_or_path)
    cfg = to_config(hf_cfg)  # validates before the heavy model load
    model = AutoModel.from_pretrained(model_name_or_path)
    params = to_params(model.state_dict(), cfg)
    try:
        tok = AutoTokenizer.from_pretrained(model_name_or_path)
    except (OSError, ValueError, TypeError):
        # no tokenizer files beside the weights (transformers raises one of
        # these, by version): the caller's default tokenizer serves
        tok = None
    return params, cfg, tok


def load_hf_decoder(model_name_or_path: str):
    """A local GPT-2-family model -> (params, cfg, hf_tokenizer or None)."""
    return _load(model_name_or_path, config_from_gpt2,
                 params_from_gpt2_state_dict)


def load_hf_encoder(model_name_or_path: str):
    """A local BERT-family model -> (params, cfg, hf_tokenizer or None).
    No network: the model must be stored locally."""
    return _load(model_name_or_path, config_from_hf,
                 params_from_bert_state_dict)
