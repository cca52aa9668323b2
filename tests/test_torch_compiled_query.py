"""pathway_tpu_torch ``CompiledQueryEncoder`` against the JAX package's.

On the CPU both classes run the same bf16 torch function eagerly (the
JAX class with ``mode="eager"``) on the same weights, built from the same
numpy tree: outputs must be identical (bound 0, ``assert_array_equal``).
Both must also stay above 0.995 cosine to the f32 encoder
(``tests/test_compiled_query.py``'s bound: bf16 rounding), at a query
that fills its bucket, at padded (masked) ones, and at one longer than
the largest bucket, which both truncate to that bucket as the f32
encoder's buckets do; pre- and post-LN (BERT-style, with biases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathway_tpu.models import encoder as jenc
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.models.host_encoder import CompiledQueryEncoder

from .test_torch_encoder import _configs, _np_params

# the f32 encoders' sequence buckets reach the query tier's largest (64:
# its buckets clamp to max_len), so a long query truncates alike
SEQ = (16, 32, 64)


@pytest.fixture(scope="module", params=["pre", "post"])
def pair(request):
    cfg_j, cfg_t = _configs(request.param)
    tree = _np_params(5, post_ln=request.param == "post")
    j = jenc.JaxEncoder(cfg_j, params=jax.tree_util.tree_map(jnp.asarray, tree),
                        seq_buckets=SEQ, batch_buckets=(1, 8))
    t = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), seq_buckets=SEQ, batch_buckets=(1, 8),
        device="cpu")
    return j, t


def _words(n, offset=0):
    return " ".join(f"w{offset + i}" for i in range(n))


TEXTS = {
    "exact_16": _words(16),
    "exact_48": _words(48, 7),
    "masked_5": _words(5, 3),
    "masked_20": _words(20, 11),
    "masked_1": "hello",
    "empty": "",
    "longer_than_largest_bucket": _words(200, 2),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_matches_the_jax_class_and_the_f32_encoder(pair, name):
    j, t = pair
    text = TEXTS[name]
    want = j.compiled_query_encoder(mode="eager").embed(text)
    cq = t.compiled_query_encoder()
    assert isinstance(cq, CompiledQueryEncoder)
    assert cq is t.compiled_query_encoder()  # built once
    got = cq.embed(text)
    assert got.dtype == np.float32 and got.shape == (t.dimensions,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cq.embed_eager(text), got)
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-3
    if text:  # the f32 encoders embed "" as one masked pad token
        ref = t.embed(text).numpy()
        assert float(ref @ got) > 0.995, (name, float(ref @ got))
        assert float(j.embed(text) @ want) > 0.995


def test_buckets_clamp_to_max_len_and_warmup_is_a_no_op_on_the_cpu(pair):
    _j, t = pair
    cq = t.compiled_query_encoder()
    assert cq.buckets == (16, 32, 48, 64)
    assert cq.dimensions == t.dimensions
    cq.warmup()
    cq.warmup_all()
    assert cq._graphs == {}  # graphs exist only on the card
    np.testing.assert_array_equal(cq(TEXTS["masked_5"]),
                                  cq.embed(TEXTS["masked_5"]))
