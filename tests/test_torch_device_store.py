"""pathway_tpu_torch ``DeviceVecStore`` / ``DeviceVec`` and the encoder's
device-resident ingest against the JAX package.

The store's cases are ``tests/test_device_store.py``'s and
``tests/test_advice_r3_fixes.py``'s (gather order, the empty store's
``pad_to``, value semantics, pickling), run through both packages on the
same numpy rows: gathered rows must be identical (a gather copies, it
computes nothing).  ``embed_batch_device`` rows are held against the
JAX ``embed_batch_device`` (f32, ``atol=rtol=1e-5``) and against the
port's own ``embed_batch`` (same buckets, so identical).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.ops import device_store as jds
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.ops.device_store import DeviceVec, DeviceVecStore

from .test_torch_encoder import WIDTHS, _configs, _np_params

TOL = dict(atol=1e-5, rtol=1e-5)


def _stores(d=4, buf_rows=None):
    j, t = jds.DeviceVecStore(d), DeviceVecStore(d, device="cpu")
    if buf_rows is not None:  # small buffers: the next-buffer path
        j.BUF_ROWS = t.BUF_ROWS = buf_rows
    return j, t


def _append(stores, rows: np.ndarray, n_valid=None):
    j, t = stores
    return (j.append_batch(jnp.asarray(rows), n_valid),
            t.append_batch(torch.from_numpy(rows), n_valid))


def test_gather_order_matches_jax():
    stores = _stores()
    b1 = _append(stores, np.arange(8.0, dtype=np.float32).reshape(2, 4))
    b2 = _append(stores, np.arange(100.0, 112.0, dtype=np.float32)
                 .reshape(3, 4))
    got = []
    for side, store in enumerate(stores):
        refs = [(b2[side][1].batch, b2[side][1].row_idx),
                (b1[side][0].batch, b1[side][0].row_idx)]
        got.append(np.asarray(store.gather(refs)))
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1], [[104, 105, 106, 107],
                                           [0, 1, 2, 3]])


def test_batches_that_do_not_fit_start_the_next_buffer():
    """Buffers of 8 rows: a 5-row batch after 5 rows opens buffer 1, a
    third opens buffer 2 (the port's arena doubles), and every handle
    gathers its own row, as in the JAX store; padding repeats row 0."""
    rng = np.random.default_rng(0)
    stores = _stores(d=6, buf_rows=8)
    batches = [rng.standard_normal((5, 6)).astype(np.float32)
               for _ in range(3)]
    handles = [_append(stores, b, n_valid=4) for b in batches]
    for side in (0, 1):
        assert [h[side][0].batch for h in handles] == [0, 1, 2]
        assert len(handles[0][side]) == 4  # n_valid rows get handles
    refs = [[(h.batch, h.row_idx) for hs in handles for h in hs[side]]
            for side in (0, 1)]
    want = np.concatenate([b[:4] for b in batches])
    for side in (0, 1):
        got = np.asarray(stores[side].gather(refs[side][::-1], pad_to=16))
        np.testing.assert_array_equal(got[:12], want[::-1])
        np.testing.assert_array_equal(got[12:], np.repeat(batches[0][:1], 4,
                                                          axis=0))


def test_oversized_batch_is_rejected():
    store = DeviceVecStore(2, device="cpu")
    store.BUF_ROWS = 4
    with pytest.raises(ValueError, match="exceeds DeviceVecStore buffer"):
        store.append_batch(torch.zeros(5, 2))


@pytest.mark.parametrize("pad_to,rows", [(8, 8), (0, 0), (None, 0)])
def test_gather_on_an_empty_store(pad_to, rows):
    for store in _stores():
        out = np.asarray(store.gather([], pad_to=pad_to))
        assert out.shape == (rows, 4)
        assert not out.any()


def test_device_vec_value_semantics_and_pickling():
    stores = _stores(d=3)
    rows = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]], np.float32)
    (j1, j2), (r1, r2) = _append(stores, rows)
    assert r1 != r2 and j1 != j2  # distinct rows, identical content
    assert r1 == DeviceVec(r1.store, r1.batch, r1.row_idx)
    assert hash(r1) == hash(DeviceVec(r1.store, r1.batch, r1.row_idx))
    assert r1 != DeviceVec(DeviceVecStore(3, device="cpu"), 0, 0)
    for ours, theirs in ((r1, j1), (r2, j2)):
        np.testing.assert_array_equal(pickle.loads(pickle.dumps(ours)),
                                      pickle.loads(pickle.dumps(theirs)))
        np.testing.assert_array_equal(np.asarray(ours), theirs.to_numpy())
        assert np.asarray(ours, dtype=np.float64).dtype == np.float64
    # the host copy is the caller's: writing it leaves the store intact
    r1.to_numpy()[:] = 0.0
    np.testing.assert_array_equal(r1.to_numpy(), rows[0])


@pytest.fixture(scope="module")
def encoders():
    cfg_j, cfg_t = _configs("post")
    tree = _np_params(3, post_ln=True)
    kw = dict(seq_buckets=(16, 32), batch_buckets=(1, 8))
    j = jenc.JaxEncoder(cfg_j, params=jnp_tree(tree), **kw)
    t = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu", **kw)
    return j, t


def jnp_tree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}"
                     for _ in range(rng.integers(3, 40))) for _ in range(n)]


def test_embed_batch_device_matches_jax(encoders):
    j, t = encoders
    texts = _texts(13)  # two chunks at the largest batch bucket (8)
    want = np.stack([r.to_numpy() for r in j.embed_batch_device(texts)])
    refs = t.embed_batch_device(texts)
    assert len(refs) == 13 and all(isinstance(r, DeviceVec) for r in refs)
    assert refs[0].store is refs[-1].store is t._store
    assert [r.batch for r in refs] == [0] * 13  # 8 + 8 rows: one buffer
    got = np.stack([r.to_numpy() for r in refs])
    np.testing.assert_allclose(got, want, **TOL)
    # same chunks, same buckets: the rows embed_batch returns, exactly
    np.testing.assert_array_equal(got, t.embed_batch(texts).numpy())
    assert t.embed_batch_device([]) == []


def test_embed_batch_device_into_a_given_store(encoders):
    _j, t = encoders
    store = DeviceVecStore(device="cpu")
    refs = t.embed_batch_device(_texts(3, seed=1), store=store)
    assert store.dim == WIDTHS["d_model"]
    assert all(r.store is store for r in refs)
    np.testing.assert_array_equal(
        store.gather([(r.batch, r.row_idx) for r in refs]).numpy(),
        t.embed_batch(_texts(3, seed=1)).numpy())


def test_stats_and_the_fastest_tier_on_the_cpu(encoders):
    _j, t = encoders
    before = dict(t.stats)
    texts = _texts(9, seed=2)
    out = t.embed_batch_fastest(texts)  # the CPU: embed_batch
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (9, 64)
    assert t.stats["texts"] - before["texts"] == 9
    assert t.stats["calls"] - before["calls"] == 2
    for k in ("tokenize_s", "pad_s", "device_s"):
        assert t.stats[k] > before[k]


def test_append_rejects_a_batch_on_another_device():
    store = DeviceVecStore(2, device="cpu")
    store.device = torch.device("meta")  # stands for a card
    with pytest.raises(ValueError, match="store on meta"):
        store.append_batch(torch.zeros(1, 2))
