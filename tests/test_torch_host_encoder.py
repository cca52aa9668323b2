"""The port's host encoder tier held to the JAX package's: the single-text
mirrors (``cpu_mirror``, ``NumpyEncoderMirror``) and the batched host tier
(``embed_batch_host`` over ``TorchBatchEncoder``), on weights converted
from the JAX encoder's numpy tree with the port's converter, pre- and
post-LN, and on a post-LN BERT imported from ``transformers``; and the
host search tier over the encoder's device-resident rows.  The bounds are
the JAX tests' own: 2e-3, scores 5e-3 (``tests/test_device_store.py``).
The tier leaves torch's thread count as it found it.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.models import host_encoder as jhost
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models import host_encoder as thost
from pathway_tpu_torch.models.convert import encoder_params_from_numpy

from .test_torch_encoder import _configs, _np_params

TOL = 2e-3


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}"
                     for _ in range(rng.integers(1, 20))) for _ in range(n)]


def _pair(cfg_j, cfg_t, tree):
    kw = dict(seq_buckets=(16, 32, 64), batch_buckets=(1, 8))
    j = jenc.JaxEncoder(cfg_j, params=jax.tree_util.tree_map(jnp.asarray,
                                                             tree), **kw)
    t = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu", **kw)
    return j, t


@pytest.fixture(scope="module", params=["pre", "post"])
def pair(request):
    cfg_j, cfg_t = _configs(request.param)
    return _pair(cfg_j, cfg_t, _np_params(7, post_ln=request.param == "post"))


def test_cpu_mirror_embeds_like_the_jax_mirror_and_the_encoder(pair):
    j, t = pair
    mirror = t.cpu_mirror()
    assert isinstance(mirror, thost.TorchEncoderMirror)
    assert t.cpu_mirror() is mirror  # cached
    texts = _texts(4, seed=4)
    got = mirror.embed_batch(texts)
    want = j.cpu_mirror().embed_batch(texts)
    assert got.dtype == np.float32 and got.shape == (4, t.dimensions)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, t.embed_batch(texts).numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mirror(texts[0]), got[0], rtol=TOL, atol=TOL)


def test_numpy_mirror_equals_the_jax_numpy_mirror(pair):
    j, t = pair
    got = thost.NumpyEncoderMirror(t.cfg, t.params, t.tokenizer)
    want = jhost.NumpyEncoderMirror(j.cfg, j.params, j.tokenizer)
    texts = _texts(3, seed=5) + [""]
    np.testing.assert_allclose(got.embed_batch(texts), want.embed_batch(texts),
                               rtol=TOL, atol=TOL)
    assert got.dimensions == want.dimensions


def test_embed_batch_host_equals_the_jax_host_tier(pair):
    j, t = pair
    texts = _texts(11, seed=6)
    before = dict(t.stats)
    got = t.embed_batch_host(texts, chunk=4)
    want = j.embed_batch_host(texts, chunk=4)
    assert isinstance(got, np.ndarray) and got.shape == (11, t.dimensions)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, t.embed_batch(texts).numpy(),
                               rtol=TOL, atol=TOL)
    # three chunks of at most four texts, each a host forward
    after = t.stats
    assert after["calls"] - before["calls"] >= 3
    assert t.host_batch() is t.host_batch()
    assert t.embed_batch_host([]).shape == (0, t.dimensions)


def test_post_ln_bert_mirrors_match_the_encoder():
    """Imported BERT-family weights (post-LN, biases, exact gelu):
    ``tests/test_device_store.py``'s case, held against the JAX mirror."""
    from transformers import BertConfig, BertModel

    from pathway_tpu.models.hf_import import (config_from_hf,
                                              params_from_bert_state_dict)

    torch.manual_seed(0)
    hf_cfg = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64, hidden_act="gelu")
    model = BertModel(hf_cfg).eval()
    cfg_j = config_from_hf(hf_cfg)
    tree = params_from_bert_state_dict(model.state_dict(), cfg_j)
    fields = {f: getattr(cfg_j, f) for f in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff", "max_len",
        "ln_placement", "act", "ln_eps")}
    j, t = _pair(cfg_j, tenc.EncoderConfig(**fields), tree)
    for text in ["hello world", "a b c d e"]:
        got = t.cpu_mirror().embed(text)
        np.testing.assert_allclose(got, j.cpu_mirror().embed(text),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, t.embed(text).numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            thost.NumpyEncoderMirror(t.cfg, t.params, t.tokenizer).embed(text),
            got, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scipy", [True, False])
def test_erf_equals_the_jax_packages(scipy, monkeypatch):
    """``_erf_vec`` through scipy, and its polynomial without it."""
    if not scipy:
        monkeypatch.setitem(sys.modules, "scipy.special", None)
    x = np.linspace(-4, 4, 257, dtype=np.float32)
    np.testing.assert_array_equal(thost._erf_vec(x), jhost._erf_vec(x))
    import math

    want = np.array([math.erf(v) for v in x.astype(np.float64)])
    assert float(np.abs(thost._erf_vec(x) - want).max()) < 2e-6


def test_the_host_tier_leaves_torch_threads_alone(pair):
    """The JAX mirrors set ``torch.set_num_threads(os.cpu_count())`` when
    built; the port's do not (the count is process-wide: it would change
    the threads of the process that drives the card too)."""
    _j, t = pair
    saved = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        fresh = tenc.TorchEncoder(t.cfg, params=t.params, device="cpu")
        fresh.host_batch()
        fresh.cpu_mirror()
        fresh.embed_batch_host(["a b c"])
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(saved)


def test_the_cpu_search_tier_over_encoder_rows_equals_the_jax_packages(pair):
    """``tests/test_device_store.py``'s serving-tier case: device-resident
    encoder rows searched on the device and on the host tier give the same
    keys, scores within its 5e-3, in both packages alike."""
    from pathway_tpu.stdlib.indexing.inner_index import BruteForceKnn as JKnn
    from pathway_tpu_torch.stdlib.indexing.inner_index import (
        BruteForceKnn as TKnn)

    j, t = pair
    texts = _texts(12, seed=3)
    got = {}
    for name, enc, index in (("jax", j, JKnn(j.dimensions)),
                             ("torch", t, TKnn(t.dimensions, device="cpu"))):
        for i, ref in enumerate(enc.embed_batch_device(texts)):
            index.add(i, ref)
        q = np.asarray(enc.embed(texts[5]), np.float32)
        got[name] = (index.search(q, 4), index.search(q, 4, tier="cpu"))
    for dev, cpu in got.values():
        assert [k for k, _ in dev] == [k for k, _ in cpu]
        assert all(abs(a - b) < 5e-3 for (_, a), (_, b) in zip(dev, cpu))
    assert [k for k, _ in got["torch"][0]] == [k for k, _ in got["jax"][0]]
