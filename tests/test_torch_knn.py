"""pathway_tpu_torch KNN scoring and index against the JAX package.

``knn_topk`` for each metric against the JAX ``knn_topk(use_pallas=False)``,
the plain scores against the Pallas ``_scores_kernel`` run in interpret
mode, and ``BruteForceKnn`` add/remove/search_batch against the JAX
index — f32, ``atol=rtol=1e-4`` on scores, indices identical.
"""

import numpy as np
import pytest
import torch

from pathway_tpu.ops.knn_pallas import knn_topk as jax_knn_topk
from pathway_tpu.ops.knn_pallas import pallas_scores
from pathway_tpu.stdlib.indexing.inner_index import BruteForceKnn as JaxKnn
from pathway_tpu_torch.ops import _cuda
from pathway_tpu_torch.ops.knn_cuda import (knn_scores, knn_scores_cuda,
                                            knn_topk)
from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn

TOL = dict(atol=1e-4, rtol=1e-4)


def _data(seed, Q=7, N=300, d=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, d)).astype(np.float32),
            rng.standard_normal((Q, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_knn_topk_matches_jax(metric):
    m, q = _data(0)
    vals_j, idx_j = jax_knn_topk(m, q, 10, metric, use_pallas=False)
    vals_t, idx_t = knn_topk(m, q, 10, metric, device="cpu")
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(vals_t.numpy(), vals_j, **TOL)


def test_knn_topk_caps_k_at_the_index_size():
    m, q = _data(1, N=5)
    vals, idx = knn_topk(m, q, 10, "dot", device="cpu")
    assert tuple(idx.shape) == (q.shape[0], 5)


def test_plain_scores_match_the_interpreted_pallas_kernel():
    m, q = _data(2, Q=5, N=300, d=24)
    want = np.asarray(pallas_scores(q, m, interpret=True))
    _cuda.reset_launches()
    got = knn_scores(torch.from_numpy(q), torch.from_numpy(m))
    assert sum(_cuda.LAUNCHES.values()) == 0  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_scores_cuda(torch.from_numpy(q), torch.from_numpy(m))


@pytest.mark.parametrize("Q,d", [(1, 24), (3, 37), (16, 37), (65, 24)])
def test_plain_scores_at_both_kernel_variants_shapes(Q, d):
    """The shapes the kernel splits at (GEMV below 16 queries, GEMM from
    16; a d that is not a multiple of 4 takes the scalar copies): the
    plain version against the interpreted Pallas kernel."""
    m, q = _data(10 + Q, Q=Q, N=300, d=d)
    want = np.asarray(pallas_scores(q, m, interpret=True))
    got = knn_scores(torch.from_numpy(q), torch.from_numpy(m))
    assert tuple(got.shape) == (Q, 300)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unknown_metric_is_rejected():
    m, q = _data(3)
    with pytest.raises(ValueError, match="unknown metric"):
        knn_topk(m, q, 3, "hamming", device="cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        BruteForceKnn(4, metric="hamming", device="cpu")


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_index_add_remove_search_matches_jax(metric):
    m, q = _data(4, Q=4, N=40, d=8)
    jax_idx = JaxKnn(8, reserved_space=16, metric=metric)
    port = BruteForceKnn(8, reserved_space=16, metric=metric, device="cpu")
    for i, row in enumerate(m):
        jax_idx.add(100 + i, row)
        port.add(100 + i, torch.from_numpy(row))
    for key in (100, 117, 139, 120):  # first, middle, last, middle
        jax_idx.remove(key)
        port.remove(key)
    jax_idx.add(117, m[0] * 2.0)  # re-add a removed key
    port.add(117, m[0] * 2.0)
    fresh = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
    jax_idx.add(101, fresh)  # replace a live key in place
    port.add(101, fresh)
    assert port.n == jax_idx.n == 37 and port.capacity == 64
    got = port.search_batch(q, 5)
    want = jax_idx.search_batch(q, 5)
    assert [[k for k, _ in row] for row in got] == \
        [[k for k, _ in row] for row in want]
    np.testing.assert_allclose(
        [[s for _, s in row] for row in got],
        [[s for _, s in row] for row in want], **TOL,
    )


def test_empty_index_returns_empty_rows():
    port = BruteForceKnn(4, device="cpu")
    assert port.search_batch(np.zeros((2, 4), np.float32), 3) == [[], []]
