"""pathway_tpu_torch encoder and tokenizer against the JAX package.

``encode`` (pre- and post-LN, masked and exact-fit) and the bucketed
``TorchEncoder.embed_batch`` are held against the JAX ``encode`` /
``JaxEncoder.embed_batch`` with the same weights (numpy, through
``models/convert.py``), f32 at ``atol=rtol=1e-4``; tokenizer ids must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from pathway_tpu_torch.internals.value import hash_values
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.models.tokenizer import HashTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)
WIDTHS = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=64)


def _np_params(seed: int, *, post_ln: bool) -> dict:
    rng = np.random.default_rng(seed)
    d, f = WIDTHS["d_model"], WIDTHS["d_ff"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def vec(center):
        return (center + 0.1 * rng.standard_normal(d)).astype(np.float32)

    p = {"embed": dense((WIDTHS["vocab_size"], d), 0.1),
         "pos_embed": dense((WIDTHS["max_len"], d), 0.1),
         "ln_f_scale": vec(1.0), "ln_f_bias": vec(0.0), "layers": []}
    if post_ln:  # BERT-family embedding layer norm
        p["ln_e_scale"], p["ln_e_bias"] = vec(1.0), vec(0.0)
    for _ in range(WIDTHS["n_layers"]):
        layer = {w: dense(s) for w, s in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w_up", (d, f)), ("w_down", (f, d)))}
        layer.update(ln1_scale=vec(1.0), ln1_bias=vec(0.0),
                     ln2_scale=vec(1.0), ln2_bias=vec(0.0))
        if post_ln:  # BERT carries projection biases
            for b in ("bq", "bk", "bv", "bo", "b_down"):
                layer[b] = vec(0.0)
            layer["b_up"] = (0.1 * rng.standard_normal(f)).astype(np.float32)
        p["layers"].append(layer)
    return p


def _configs(placement: str):
    kw = dict(WIDTHS, ln_placement=placement,
              act="gelu" if placement == "post" else "gelu_tanh",
              ln_eps=1e-12 if placement == "post" else 1e-6)
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


@pytest.mark.parametrize("placement", ["pre", "post"])
@pytest.mark.parametrize("masked", [True, False])
def test_encode_matches_jax(placement, masked):
    cfg_j, cfg_t = _configs(placement)
    tree = _np_params(0, post_ln=placement == "post")
    rng = np.random.default_rng(1)
    ids = rng.integers(4, WIDTHS["vocab_size"], size=(3, 16))
    mask = None
    if masked:
        mask = np.zeros((3, 16), bool)
        for i, n in enumerate((16, 5, 1)):
            mask[i, :n] = True
    want = jenc.encode(
        jax.tree_util.tree_map(jnp.asarray, tree), cfg_j,
        jnp.asarray(ids, jnp.int32),
        None if mask is None else jnp.asarray(mask),
    )
    got = tenc.encode(
        encoder_params_from_numpy(tree, cfg_t, device="cpu"), cfg_t,
        torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_batch_bucketing_matches_jax():
    cfg_j, cfg_t = _configs("post")
    tree = _np_params(2, post_ln=True)
    texts = ["the quick brown fox", "jumps over", "the lazy dog " * 5,
             "a", "pathway serves retrieval augmented generation"]
    jax_enc = jenc.JaxEncoder(cfg_j, params=jax.tree_util.tree_map(
        jnp.asarray, tree), seq_buckets=(8, 32), batch_buckets=(2, 8))
    port = tenc.TorchEncoder(
        cfg_t, params=encoder_params_from_numpy(tree, cfg_t, device="cpu"),
        seq_buckets=(8, 32), batch_buckets=(2, 8), device="cpu",
    )
    got = port.embed_batch(texts)
    np.testing.assert_allclose(got.numpy(), jax_enc.embed_batch(texts), **TOL)
    # oversized batches chunk at the largest bucket; exact fit skips masks
    many = [f"doc {i} about topic {i % 3}" for i in range(19)]
    np.testing.assert_allclose(port.embed_batch(many).numpy(),
                               jax_enc.embed_batch(many), **TOL)
    assert tuple(port.embed_batch([]).shape) == (0, 64)


def test_tokenizer_ids_match_jax():
    texts = ["Hello, World!", "RAG: retrieve, then generate.",
             "ÜNICODE wörds and digits 123", "", "a  b\tc\nd"]
    for vocab in (512, 30522, 50257):
        jt, tt = JaxTokenizer(vocab), HashTokenizer(vocab)
        for text in texts:
            assert tt.encode(text) == jt.encode(text)
            assert tt.count_tokens(text) == jt.count_tokens(text)


@pytest.mark.parametrize("value", [
    None, True, False, 0, -7, 2**70, 1.5, float("nan"), "w", b"\x00b",
    ("a", 1, (2.0, None)), [1, 2], {"k": [1, "v"], "j": None},
    np.arange(3, dtype=np.int32), np.float32(2.5),
])
def test_hash_values_copy_is_byte_identical(value):
    from pathway_tpu.internals.value import hash_values as jax_hash

    assert hash_values("#tok", value) == jax_hash("#tok", value)
