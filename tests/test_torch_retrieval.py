"""pathway_tpu_torch ``BruteForceKnn`` and the KNN top-k functions against
the JAX package.

``BruteForceKnn`` in four modes — host rows, device-resident rows (one
``DeviceVecStore``), mixed, and rows from two stores — goes through add,
replace, remove and re-add of a removed key beside the JAX index, fed
the JAX package's own ``DeviceVec``s for the same rows; then ``search``
on every tier (``"auto"``, ``"cpu"``), every metric, with and without a
metadata filter, at k below and above the index size, and
``search_batch``.  Keys must be equal and scores within ``atol=rtol=
1e-5`` (f32; rows of norm ~1, so every score is O(1)).  The port scores
a filtered search over device-resident rows on its f32 device matrix,
where the JAX index scores an f16 host mirror; so filtered searches are
held against a third index, the JAX index fed every row as a host row
(f32 numpy scores, the same keys and order).

Top-k order: duplicate vectors with more tied rows than k give the keys
of ``lax.top_k``, in its order (lower index first), through
``knn_topk``, ``batched_topk`` (with bucket padding masked), ``device_topk``
and ``BruteForceKnn.search`` / ``search_batch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import device_store as jds
from pathway_tpu.ops import knn as jknn
from pathway_tpu.ops.knn_pallas import knn_topk as jax_knn_topk
from pathway_tpu.stdlib.indexing.inner_index import BruteForceKnn as JaxKnn
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.device_store import DeviceVecStore
from pathway_tpu_torch.ops.knn_cuda import knn_topk
from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn

TOL = dict(atol=1e-5, rtol=1e-5)
D = 48
METRICS = ("cos", "dot", "l2sq")
FILTER = "grp == `1` || grp == `2`"


def _rows(seed, n, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


class _Pair:
    """A JAX index and a port index fed the same rows, each kind of row
    (host, or a handle into store 0 or 1) made in its own package, and
    ``jh``, the JAX index fed every row as a host row."""

    def __init__(self, metric, threshold):
        self.j = JaxKnn(D, reserved_space=16, metric=metric,
                        device_threshold=threshold)
        self.jh = JaxKnn(D, reserved_space=16, metric=metric,
                         device_threshold=threshold)
        self.t = BruteForceKnn(D, reserved_space=16, metric=metric,
                               device="cpu")
        self.stores = [(jds.DeviceVecStore(D), DeviceVecStore(D, device="cpu"))
                       for _ in range(2)]

    def add(self, key, row, kind, meta=None):
        self.jh.add(key, row, meta)
        if kind == "host":
            self.j.add(key, row, meta)
            self.t.add(key, torch.from_numpy(row), meta)
            return
        js, ts = self.stores[kind]
        [jv] = js.append_batch(jnp.asarray(row[None]))
        [tv] = ts.append_batch(torch.from_numpy(row[None].copy()))
        self.j.add(key, jv, meta)
        self.t.add(key, tv, meta)

    def remove(self, key):
        self.j.remove(key)
        self.jh.remove(key)
        self.t.remove(key)


def _kind(mode, i):
    return {"host": "host", "device": 0,
            "mixed": ("host", 0)[i % 2], "two_stores": i % 2}[mode]


def _build(mode, metric, threshold=2048):
    pair = _Pair(metric, threshold)
    rows = _rows(1, 40)
    for i, row in enumerate(rows):
        pair.add(100 + i, row, _kind(mode, i), {"grp": i % 3})
    for key in (100, 117, 139, 120):  # first, middle, last, middle
        pair.remove(key)
    extra = _rows(2, 2)
    pair.add(117, extra[0], _kind(mode, 1), {"grp": 1})  # re-add
    pair.add(101, extra[1], _kind(mode, 0), {"grp": 2})  # replace in place
    assert pair.t.n == pair.j.n == 37 and pair.t.capacity == pair.j.capacity
    assert pair.t.keys == pair.j.keys
    return pair


def _same(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               **TOL)


CASES = [(m, metric) for m in ("host", "device", "mixed", "two_stores")
         for metric in METRICS]


@pytest.mark.parametrize("mode,metric", CASES)
def test_index_matches_jax(mode, metric):
    pair = _build(mode, metric)
    queries = _rows(3, 5)
    for q in queries:
        for k in (5, 100):  # k above the index size returns every row
            for tier in ("auto", "cpu"):
                _same(pair.t.search(q, k, tier=tier),
                      pair.j.search(q, k, tier=tier))
            _same(pair.t.search(q, k, FILTER), pair.jh.search(q, k, FILTER))
    got = pair.t.search_batch(list(queries), 4)
    want = pair.j.search_batch(list(queries), 4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("metric", METRICS)
def test_large_host_index_takes_the_device_branch(metric):
    """``device_threshold=0`` on the JAX index: its host-row searches take
    its device branch (the pre-normalised ``to_device`` copy and
    ``device_topk``), filtered ones the full device score vector; the
    port's take its device matrix at every size."""
    pair = _build("host", metric, threshold=0)
    queries = _rows(4, 4)
    for q in queries:
        _same(pair.t.search(q, 6), pair.j.search(q, 6))
        _same(pair.t.search(q, 6, FILTER), pair.j.search(q, 6, FILTER))
    for g, w in zip(pair.t.search_batch(queries, 6),
                    pair.j.search_batch(queries, 6)):
        _same(g, w)


def test_device_matrix_is_cached_per_version_and_bucketed():
    pair = _build("device", "cos")
    t = pair.t
    m = t._device_matrix(prenorm=True)
    assert tuple(m.shape) == (256, D) and t._dev_valid == 37
    assert t._device_matrix(prenorm=True) is m  # no mutation: cached
    np.testing.assert_allclose(torch.linalg.norm(m[:37], dim=1).numpy(),
                               1.0, atol=1e-6)
    # padding rows repeat the store's row 0; searches mask them by n_valid
    assert torch.equal(m[37:], m[255:].expand(219, D))
    t.remove(101)
    assert t._device_matrix(prenorm=True) is not m
    assert t._dev_valid == 36
    assert BruteForceKnn._bucket_rows(257) == 512


def test_query_as_a_tensor_or_a_handle():
    pair = _build("device", "dot")
    q = _rows(5, 1)[0]
    want = pair.j.search(q, 3)
    _same(pair.t.search(torch.from_numpy(q), 3), want)
    [h] = DeviceVecStore(D, device="cpu").append_batch(
        torch.from_numpy(q[None].copy()))
    _same(pair.t.search(h, 3), want)
    _same(pair.t.search_batch(torch.from_numpy(q[None]), 3)[0], want)


def test_empty_index_and_mismatched_devices():
    t = BruteForceKnn(4, device="cpu")
    assert t.search(np.zeros(4, np.float32), 3) == []
    assert t.search_batch([np.zeros(4, np.float32)], 3) == [[]]
    store = DeviceVecStore(4, device="cpu")
    store.device = torch.device("meta")  # stands for a card
    [h] = store.append_batch(torch.zeros((1, 4), device="meta"))
    with pytest.raises(ValueError, match="index on cpu"):
        t.add(1, h)


# -- top-k order under ties -------------------------------------------------

def _tied(seed=7, n_base=5, copies=12):
    """A matrix whose rows repeat ``n_base`` vectors ``copies`` times,
    interleaved, so each score is shared by 12 rows (more than k = 10);
    entries are multiples of 1/4, so every dot product is exact."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(-4, 5, size=(n_base, D)) / 4).astype(np.float32)
    m = np.tile(base, (copies, 1))
    q = (rng.integers(-4, 5, size=(3, D)) / 4).astype(np.float32)
    return m, q


@pytest.mark.parametrize("metric", METRICS)
def test_knn_topk_ties_in_lax_top_k_order(metric):
    m, q = _tied()
    vals_j, idx_j = jax_knn_topk(m, q, 10, metric, use_pallas=False)
    vals_t, idx_t = knn_topk(m, q, 10, metric, device="cpu")
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(vals_t.numpy(), vals_j, **TOL)
    assert len(set(vals_t.numpy()[0])) < 10  # ties inside the top 10


@pytest.mark.parametrize("metric", METRICS + ("cos_prenorm",))
def test_batched_and_single_topk_ties_with_padding(metric):
    m, q = _tied()
    if metric == "cos_prenorm":
        m = m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)
    padded = np.concatenate([m, np.zeros((4, D), np.float32)])  # bucket 64
    n_valid = m.shape[0]
    mt = tknn.to_device(padded, "cpu")
    if metric != "cos_prenorm":
        vals_j, idx_j = jknn.batched_topk(padded, q, 10, metric, n_valid)
        vals_t, idx_t = tknn.batched_topk(mt, q, 10, metric, n_valid)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_allclose(vals_t, vals_j, **TOL)
    for qi in q:
        vals_j, idx_j = jknn.device_topk(jnp.asarray(padded), qi, 10, metric,
                                         n_valid)
        vals_t, idx_t = tknn.device_topk(mt, qi, 10, metric, n_valid)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_allclose(vals_t, vals_j, **TOL)
        assert idx_t.max() < n_valid


@pytest.mark.parametrize("mode,threshold", [("device", 2048), ("host", 0)])
def test_index_ties_in_lax_top_k_order(mode, threshold):
    m, q = _tied()
    pair = _Pair("dot", threshold)
    for i, row in enumerate(m):
        pair.add(1000 + i, row, _kind(mode, i))
    for qi in q:
        got, want = pair.t.search(qi, 10), pair.j.search(qi, 10)
        assert [k for k, _ in got] == [k for k, _ in want]
    for g, w in zip(pair.t.search_batch(q, 10), pair.j.search_batch(q, 10)):
        assert [k for k, _ in g] == [k for k, _ in w]


def test_topk_order_on_the_reported_row():
    """The row from the fault report: ``lax.top_k`` gives lower indices
    first among the 0.9s."""
    row = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.9, 0.5] * 300, np.float32)
    _vals, idx = tknn.topk_lower_index_first(torch.from_numpy(row), 10)
    assert idx.tolist() == [1, 3, 5, 8, 10, 12, 15, 17, 19, 22]
    s = np.array([-0.0, 0.0, -0.0, 0.0, np.nan, 1.0, -np.inf], np.float32)
    _vals, idx = tknn.topk_lower_index_first(torch.from_numpy(s), 7)
    # lax.top_k's total order: NaN first, +0 above -0
    assert idx.tolist() == [4, 5, 1, 3, 0, 2, 6]


@pytest.mark.parametrize("mode", ["host", "device", "mixed"])
def test_auto_tier_scores_the_device_matrix_at_every_size(mode, monkeypatch):
    """A small index (37 rows) serves ``tier="auto"`` searches, filtered or
    not, from its device matrix: the numpy host-mirror scoring runs only
    for ``tier="cpu"``.  Ties among host rows come back in ``lax.top_k``'s
    order too."""
    pair = _build(mode, "cos")
    q = _rows(6, 1)[0]
    want_cpu = pair.t.search(q, 5, tier="cpu")

    def host_scoring(*_a, **_k):
        raise AssertionError("host-mirror scoring on the auto tier")

    monkeypatch.setattr(pair.t, "_scores", host_scoring)
    _same(pair.t.search(q, 5), pair.jh.search(q, 5))
    _same(pair.t.search(q, 5, FILTER), pair.jh.search(q, 5, FILTER))
    _same(pair.t.search_batch([q], 5)[0], pair.jh.search(q, 5))
    assert [k for k, _ in pair.t.search(q, 5)] == [k for k, _ in want_cpu]
    m, qs = _tied()
    t = BruteForceKnn(D, metric="dot", device="cpu")
    for i, row in enumerate(m):
        t.add(1000 + i, torch.from_numpy(row))
    _vals, idx = jax_knn_topk(m, qs, 10, "dot", use_pallas=False)
    for qi, ii in zip(qs, idx):
        assert [k for k, _ in t.search(qi, 10)] == [1000 + int(i) for i in ii]
