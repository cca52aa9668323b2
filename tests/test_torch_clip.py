"""pathway_tpu_torch ``models/clip.py`` against transformers and the JAX
package's ``JaxClip``.

- the port's towers against HF ``get_image_features`` /
  ``get_text_features`` on the tiny random ``CLIPModel`` of
  ``tests/test_clip.py`` (f32, within 2e-4, that file's tolerance), with
  the weights carried by ``params_from_clip_state_dict`` and loaded by
  ``TorchClip.from_hf`` from a saved copy;
- against ``JaxClip`` on the same weights (a JAX ``init_clip_params``
  tree carried by ``clip_params_from_numpy``), within 1e-5: image,
  text (the empty text too) and similarity, and the pixel rescale and
  nearest resize bit for bit;
- ``embed_image_batch`` against row-wise ``embed_image``, within 1e-6
  (a batched product rounds in another order: 1.2e-7 apart here);
- shared-space retrieval through the port's ``BruteForceKnn``, and the
  port's ``TorchClip`` inside the JAX ``ImageParser`` pipeline.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.models import clip as jclip
from pathway_tpu_torch.models import clip as tclip
from pathway_tpu_torch.models.convert import clip_params_from_numpy

from .test_clip import _tiny_hf_clip

HF_TOL = dict(rtol=2e-4, atol=2e-4)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


def _small(mod, dtype):
    return mod.ClipConfig(
        vision=mod.ClipVisionConfig(image_size=32, patch_size=8, d_model=64,
                                    n_layers=2, n_heads=4, d_ff=128),
        text=mod.ClipTextConfig(vocab_size=2048, max_len=16, d_model=64,
                                n_layers=2, n_heads=4, d_ff=128),
        projection_dim=32, dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    """(JaxClip, TorchClip) on one random JAX tree."""
    cfg_j = _small(jclip, np.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(cfg_j, jax.random.PRNGKey(3)))
    cfg_t = _small(tclip, torch.float32)
    return (jclip.JaxClip(cfg_j, params=jax.tree_util.tree_map(
                jax.numpy.asarray, tree)),
            tclip.TorchClip(cfg_t, params=clip_params_from_numpy(
                tree, cfg_t, device="cpu"), device="cpu"))


def test_towers_match_hf_features():
    model = _tiny_hf_clip()
    cfg = tclip.clip_config_from_hf(model.config)
    assert cfg.dtype == torch.float32
    clip = tclip.TorchClip(cfg, params=tclip.params_from_clip_state_dict(
        model.state_dict(), cfg), device="cpu")
    rng = np.random.default_rng(0)
    px = rng.random((32, 32, 3), np.float32)
    with torch.no_grad():
        ref = model.get_image_features(
            pixel_values=torch.from_numpy(px.transpose(2, 0, 1))[None]
        )[0].numpy()
    np.testing.assert_allclose(clip.embed_image(px),
                               ref / np.linalg.norm(ref), **HF_TOL)

    # eos at the last valid position: HF pools argmax(ids == eos), the
    # port's encode_text pools n_valid - 1; both land there
    ids = rng.integers(1, 399, 7)
    ids[-1] = model.config.text_config.eos_token_id
    with torch.no_grad():
        ref_t = model.get_text_features(
            input_ids=torch.from_numpy(ids)[None])[0].numpy()
        buf = torch.zeros((1, 32), dtype=torch.int64)
        buf[0, :7] = torch.from_numpy(ids)
        ours = tclip.encode_text(clip.params, clip.cfg, buf,
                                 torch.tensor([7]))[0].numpy()
    np.testing.assert_allclose(ours, ref_t / np.linalg.norm(ref_t), **HF_TOL)


def test_from_hf_loads_as_jax_clip(tmp_path):
    model = _tiny_hf_clip()
    model.save_pretrained(tmp_path)
    clip = tclip.TorchClip.from_hf(str(tmp_path), device="cpu")
    jc = jclip.JaxClip.from_hf(str(tmp_path))
    assert clip.dimensions == jc.dimensions == 32
    px = np.random.default_rng(1).random((40, 24, 3), np.float32)
    np.testing.assert_allclose(clip.embed_image(px), jc.embed_image(px),
                               **JAX_TOL)
    np.testing.assert_allclose(clip.embed_text("a photo of a cat"),
                               jc.embed_text("a photo of a cat"), **JAX_TOL)


def test_clip_params_from_numpy_checks_every_leaf(pair):
    cfg = _small(tclip, torch.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(_small(jclip, np.float32),
                                           jax.random.PRNGKey(0)))
    bad = dict(tree, v_proj=tree["v_proj"][:, :8])
    with pytest.raises(ValueError, match="v_proj: shape"):
        clip_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        clip_params_from_numpy({k: v for k, v in tree.items()
                                if k != "t_proj"}, cfg, device="cpu")
    short = dict(tree, t_layers=tree["t_layers"][:1])
    with pytest.raises(ValueError, match="1 layers, expected 2"):
        clip_params_from_numpy(short, cfg, device="cpu")


@pytest.mark.parametrize("shape,scale", [((32, 32, 3), 1.0),
                                         ((32, 32, 3), 255.0),
                                         ((17, 45, 3), 255.0),
                                         ((64, 48, 3), 1.0)])
def test_towers_match_jax_clip(pair, shape, scale):
    jc, tc = pair
    rng = np.random.default_rng(int(sum(shape) + scale))
    image = (rng.random(shape) * scale).astype(np.float32)
    if scale > 2:
        image = np.round(image)
    # the rescale and the nearest resize decide which pixels are read
    want_px = np.asarray(image, np.float32)
    if want_px.max() > 2.0:
        want_px = want_px / 255.0
    if want_px.shape[:2] != (32, 32):
        want_px = jclip._resize_nearest(want_px, 32)
    assert np.array_equal(tc._pixels(image), want_px)
    np.testing.assert_allclose(tc.embed_image(image), jc.embed_image(image),
                               **JAX_TOL)


@pytest.mark.parametrize("text", ["", "a photo of a cat",
                                  " ".join(f"w{i}" for i in range(40))])
def test_text_tower_matches_jax_clip(pair, text):
    """The empty text pools position 0 (``or [0]``); a long one is cut at
    ``max_len``."""
    jc, tc = pair
    np.testing.assert_allclose(tc.embed_text(text), jc.embed_text(text),
                               **JAX_TOL)
    image = np.random.default_rng(7).random((32, 32, 3), np.float32)
    np.testing.assert_allclose(tc.similarity(text, image),
                               jc.similarity(text, image), rtol=1e-5)


def test_image_batch_equals_embed_image(pair, monkeypatch):
    _jc, tc = pair
    rng = np.random.default_rng(8)
    images = [rng.random((32, 32, 3), np.float32) for _ in range(5)]
    images.append((rng.random((20, 30, 3)) * 255).astype(np.float32))
    monkeypatch.setattr(tclip, "IMAGE_CHUNK", 4)  # two forwards
    batch = tc.embed_image_batch(images)
    assert batch.shape == (6, 32) and batch.dtype == np.float32
    rows = np.stack([tc.embed_image(im) for im in images])
    np.testing.assert_allclose(batch, rows, rtol=0, atol=1e-6)


def test_shared_space_retrieval_through_the_port_index(pair):
    from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn

    _jc, clip = pair
    rng = np.random.default_rng(1)
    images = [rng.random((32, 32, 3), np.float32) for _ in range(4)]
    index = BruteForceKnn(clip.dimensions, device="cpu")
    for i, row in enumerate(clip.embed_image_batch(images)):
        index.add(i, row)
    assert index.search(clip.embed_image(images[2]), 1)[0][0] == 2
    res = index.search(clip.embed_text("a photo"), 2)
    assert len(res) == 2
    assert np.isfinite(clip.similarity("a photo", images[0]))


def test_port_clip_runs_inside_the_jax_image_parser(pair):
    from pathway_tpu.xpacks.llm.parsers import ImageParser

    jc, tc = pair
    rng = np.random.default_rng(2)
    px = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    ppm = b"P6\n16 16\n255\n" + px.tobytes()
    [(text, meta)] = ImageParser(clip_model=tc)(ppm)
    [(j_text, j_meta)] = ImageParser(clip_model=jc)(ppm)
    assert "image" in text and text == j_text
    np.testing.assert_allclose(np.asarray(meta["clip_embedding"]),
                               np.asarray(j_meta["clip_embedding"]),
                               **JAX_TOL)


def test_default_config_is_vit_b32():
    cfg = tclip.ClipConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jclip.ClipConfig())
    assert (cfg.vision.d_model, cfg.vision.n_layers, cfg.vision.patch_size,
            cfg.text.d_model, cfg.projection_dim) == (768, 12, 32, 512, 512)
