"""pathway_tpu_torch paged engine and block pool against the JAX package.

``PagedDecodeEngine.generate_batch`` greedy tokens must be identical to
the JAX ``PagedDecodeEngine(attn="reference")`` on mixed-length prompts
with a shared prefix (chunked prefill, chained decode, prefix sharing,
preemption under a small pool); ``BlockPool`` allocate/extend/truncate/
COW invariants are checked directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu_torch.kvcache.block_pool import BlockPool, PoolExhausted
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
from pathway_tpu_torch.kvcache.prefix_cache import PrefixCache
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

WIDTHS = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f = WIDTHS["d_model"], WIDTHS["d_ff"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"embed": dense((WIDTHS["vocab_size"], d), 0.1),
         "pos_embed": dense((WIDTHS["max_len"], d), 0.1),
         "ln_f_scale": np.ones(d, np.float32),
         "ln_f_bias": np.zeros(d, np.float32), "layers": []}
    for _ in range(WIDTHS["n_layers"]):
        layer = {w: dense(s) for w, s in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w_up", (d, f)), ("w_down", (f, d)))}
        for ln in ("ln1", "ln2"):
            layer[f"{ln}_scale"] = np.ones(d, np.float32)
            layer[f"{ln}_bias"] = np.zeros(d, np.float32)
        p["layers"].append(layer)
    return p


@pytest.fixture(autouse=True)
def _jax_registry_as_found():
    """The JAX package's own profiler tests read its process-wide program
    registry, and a whole-bucket JAX engine leaves a program-level
    record there (several prefill buckets, dispatches, no counted work):
    the records this test's JAX engines add are removed after it."""
    reg = jprof.registry()
    keys = set(reg._records)
    yield
    with reg._lock:
        for k in set(reg._records) - keys:
            del reg._records[k]


@pytest.fixture(scope="module")
def weights():
    tree = _np_params(0)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, CFG_T, device="cpu"))


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(4, 512, 20)]  # 2.5 blocks
    tails = (3, 11, 30, 0, 45)
    return [shared + [int(t) for t in rng.integers(4, 512, n)]
            for n in tails] + [[7]]


# (num_blocks, max_batch_size, prefill_chunk, chain_steps): the default
# shape, per-step decode only, and a pool small enough to preempt
@pytest.mark.parametrize("sizes", [(64, 4, 16, 4), (64, 3, 8, 1),
                                   (12, 4, 16, 4)])
def test_generate_batch_tokens_match_jax_engine(weights, sizes):
    pj, pt = weights
    nb, mb, chunk, chain = sizes
    kw = dict(num_blocks=nb, block_size=8, max_batch_size=mb,
              prefill_chunk=chunk, chain_steps=chain)
    reqs = [(p, n) for p, n in zip(_prompts(), (12, 5, 9, 16, 1, 7))]
    want = JaxEngine(CFG_J, pj, attn="reference", name=f"t_torch_{nb}_{mb}",
                     **kw).generate_batch(reqs)
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", **kw)
    assert eng.generate_batch(reqs) == want
    assert eng.rounds["mixed"] > 0
    if chain > 1:
        assert eng.rounds["chain"] > 0
    if nb == 12:
        assert eng.pool.n_preemptions > 0
    # every sequence released: only the prefix cache's holds remain
    assert not eng.pool.sequences()
    eng.pool.check_invariants(eng.prefix.external_refs())
    # a second batch hits the now-registered shared prefix
    assert eng.generate_batch(reqs[:2]) == want[:2]


def test_serve_batch_and_stop_token(weights):
    _pj, pt = weights
    eng = PagedDecodeEngine(CFG_T, pt, num_blocks=64, block_size=8,
                            max_batch_size=4, device="cpu")
    reqs = [(p, 6) for p in _prompts()[:3]]
    full = eng.generate_batch(reqs)
    stop = full[0][2]
    assert eng.serve_batch([(p, n, 0) for p, n in reqs]) == full
    out = eng.generate_batch(reqs, stop_token=stop)
    assert out[0] == full[0][:3]
    assert eng.generate(reqs[1][0], 6) == full[1]
    assert eng.generate(reqs[1][0], 0) == []


def test_decoder_lm_generate_batch_matches_jax(weights):
    pj, pt = weights
    prompts = ["the quick brown fox jumps", "over the lazy dog " * 3, "a"]
    jax_lm = jdec.JaxDecoderLM(CFG_J, params=pj)
    want = jax_lm.generate_batch(prompts, max_new_tokens=6)
    lm = tdec.TorchDecoderLM(CFG_T, params=pt, device="cpu")
    lm.paged_engine(num_blocks=64, block_size=8, max_batch_size=4)
    assert lm.generate_batch(prompts, max_new_tokens=6) == want


def _pool(num_blocks=8):
    return BlockPool(num_blocks=num_blocks, block_size=4, n_layers=2,
                     n_heads=2, head_dim=4, device="cpu")


def test_block_pool_allocate_extend_truncate():
    pool = _pool()
    with pytest.raises(ValueError, match="block 0 is reserved"):
        BlockPool(num_blocks=1, block_size=4, n_layers=1, n_heads=1,
                  head_dim=4, device="cpu")
    s = pool.allocate(1, 6)
    assert len(s.block_ids) == 2 and 0 not in s.block_ids
    assert pool.extend_slots(1, 3) == [(s.block_ids[1], 2),
                                      (s.block_ids[1], 3),
                                      (s.block_ids[2], 0)]
    assert pool.sequence(1).n_tokens == 9
    pool.check_invariants()
    # atomic: a request the free list cannot cover changes nothing
    before = (pool.num_free, list(s.block_ids), s.n_tokens)
    with pytest.raises(PoolExhausted) as err:
        pool.extend_slots(1, 40)
    assert err.value.needed > err.value.free
    assert (pool.num_free, list(s.block_ids), s.n_tokens) == before
    pool.truncate_slots(1, 5)
    assert pool.sequence(1).n_tokens == 4 and len(s.block_ids) == 1
    with pytest.raises(ValueError, match="cannot roll back"):
        pool.truncate_slots(1, 5)
    pool.free_sequence(1)
    assert pool.num_free == pool.num_blocks - 1
    pool.check_invariants()


def test_block_pool_fork_copy_on_write_keeps_parent_bytes():
    pool = _pool()
    parent = pool.allocate(1, 6)
    tail = parent.block_ids[-1]
    pool.k[0][:, tail] = 3.0
    pool.v[0][:, tail] = -3.0
    pool.fork(1, 2)
    assert pool.refcount(tail) == 2
    blk, off = pool.append_slot(2)  # diverging append copies the tail
    assert blk != tail and off == 2 and pool.n_cow == 1
    assert torch.equal(pool.k[0][:, blk], pool.k[0][:, tail])
    pool.k[0][:, blk, off] = 9.0  # the child's write
    assert bool((pool.k[0][:, tail] == 3.0).all())  # the parent is untouched
    assert pool.refcount(tail) == 1
    pool.check_invariants()
    victim = pool.preempt()
    assert victim.seq_id == 2  # most recent arrival in the same class
    pool.check_invariants()


def test_prefix_cache_shares_full_blocks_and_evicts_lru():
    pool = _pool(num_blocks=16)
    cache = PrefixCache(pool)
    tokens = list(range(10))  # two full blocks + a partial one
    shared, keys = cache.match(tokens)
    assert shared == [] and len(keys) == 2
    s = pool.allocate(1, len(tokens))
    assert cache.insert(keys, s.block_ids) == 2
    shared, _ = cache.match(tokens[:8] + [99, 98])
    assert shared == s.block_ids[:2]
    pool.free_sequence(1)
    pool.check_invariants(cache.external_refs())
    assert cache.evict(5) == 2 and len(cache) == 0
    pool.check_invariants()


# (num_blocks, max_batch_size, chain_steps): the default shape, per-step
# decode only, and a pool small enough to preempt
@pytest.mark.parametrize("sizes", [(64, 4, 4), (64, 3, 1), (12, 4, 4)])
def test_whole_bucket_prefill_matches_jax_and_chunked(weights, sizes):
    pj, pt = weights
    nb, mb, chain = sizes
    kw = dict(num_blocks=nb, block_size=8, max_batch_size=mb,
              chain_steps=chain)
    reqs = [(p, n) for p, n in zip(_prompts(), (12, 5, 9, 16, 1, 7))]
    want = JaxEngine(CFG_J, pj, attn="reference", chunked_prefill=False,
                     name=f"t_torch_whole_{nb}_{mb}_{chain}",
                     **kw).generate_batch(reqs)
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", chunked_prefill=False,
                            **kw)
    assert eng.generate_batch(reqs) == want
    assert eng.rounds["prefill"] >= len(reqs) and eng.rounds["mixed"] == 0
    chunked = PagedDecodeEngine(CFG_T, pt, device="cpu", prefill_chunk=16,
                                **kw)
    assert chunked.generate_batch(reqs) == want
    if nb == 12:
        assert eng.pool.n_preemptions > 0
    assert not eng.pool.sequences()
    eng.pool.check_invariants(eng.prefix.external_refs())


def test_whole_bucket_prefill_keeps_shared_blocks(weights, monkeypatch):
    pj, pt = weights
    kw = dict(num_blocks=64, block_size=8, max_batch_size=4)
    first, second = _prompts()[1], _prompts()[2]  # 20 shared tokens
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", chunked_prefill=False,
                            **kw)
    assert eng.generate_batch([(first, 6)]) == JaxEngine(
        CFG_J, pj, attn="reference", chunked_prefill=False,
        name="t_torch_whole_shared", **kw).generate_batch([(first, 6)])
    shared, _ = eng.prefix.match(second)
    assert len(shared) == 2  # the two full blocks of the shared prefix
    before_k = eng.pool.k[0][:, shared].clone()
    before_v = eng.pool.v[0][:, shared].clone()
    tables = []
    orig = tdec.paged_prefill

    def spy(params, cfg, ids, n_valid, k_pool, v_pool, bt, **kwargs):
        tables.append(bt.clone())
        return orig(params, cfg, ids, n_valid, k_pool, v_pool, bt, **kwargs)

    # the engine binds its step programs when it builds them
    monkeypatch.setattr(tdec, "paged_prefill", spy)
    eng._build_programs()
    got = eng.generate_batch([(second, 9)])
    # the prefix-shared leading entries scatter to the null block
    assert tables and tables[0][0, :2].tolist() == [0, 0]
    assert bool((tables[0][0, 2:3] != 0).all())
    assert torch.equal(eng.pool.k[0][:, shared], before_k)
    assert torch.equal(eng.pool.v[0][:, shared], before_v)
    # and the sharer's tokens are those of a fresh engine
    fresh = PagedDecodeEngine(CFG_T, pt, device="cpu", chunked_prefill=False,
                              **kw)
    assert got == fresh.generate_batch([(second, 9)])


def test_whole_bucket_prefill_failure_frees_blocks(weights, monkeypatch):
    _pj, pt = weights
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", chunked_prefill=False,
                            num_blocks=64, block_size=8, max_batch_size=4)

    def boom(*a, **k):
        raise RuntimeError("prefill failed")

    monkeypatch.setattr(tdec, "paged_prefill", boom)
    eng._build_programs()
    with pytest.raises(RuntimeError, match="prefill failed"):
        eng.generate_batch([(_prompts()[0], 4)])
    assert not eng.pool.sequences()
    assert eng.pool.num_free == eng.pool.num_blocks - 1
