"""pathway_tpu_torch.kvcache.tiering.SessionStore over the port's BlockPool.

- suspend then resume gives back every K/V byte of the session's blocks,
  into other blocks of the pool;
- ``match`` returns an entry whose context prefixes the new turn and
  drops a diverged one; ``drop`` and ``clear`` release the bytes;
- for one sequence of suspends under one ``host_budget_bytes`` the byte
  charges (the power-of-two padded width, as the JAX store pads it), the
  payloads and the evicted session ids equal the JAX store's over the JAX
  ``BlockPool``, suspend by suspend;
- through the engine: a session's second turn resumes and gives the JAX
  engine's tokens; a suspend that raises is counted in
  ``n_suspend_failures``, frees the blocks, and the next turn recomputes
  to the same tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache import BlockPool as JaxPool
from pathway_tpu.kvcache import PagedDecodeEngine as JaxEngine
from pathway_tpu.kvcache import SessionStore as JaxStore
from pathway_tpu_torch.kvcache import BlockPool, PagedDecodeEngine, SessionStore

from .test_torch_fleet import CFG_J, CFG_T, EKW, fleet_weights

DIMS = dict(num_blocks=16, block_size=4, n_layers=2, n_heads=2, head_dim=4)


def _pools(seed=0):
    """A JAX and a port pool holding the same random K/V."""
    rng = np.random.default_rng(seed)
    shape = (DIMS["n_layers"], DIMS["num_blocks"], DIMS["block_size"],
             DIMS["n_heads"], DIMS["head_dim"])
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jp = JaxPool(**DIMS, name=f"tt_tier_pool_{seed}")
    jp.k, jp.v = jnp.asarray(k), jnp.asarray(v)
    tp = BlockPool(**DIMS, device="cpu")
    tp.k[0].copy_(torch.from_numpy(k))
    tp.v[0].copy_(torch.from_numpy(v))
    return jp, tp


def test_suspend_then_resume_gives_back_kv_bit_for_bit():
    _jp, pool = _pools()
    pool.allocate(1, 10)  # 3 blocks, the last one partly filled
    blocks = list(pool.sequence(1).block_ids)
    k0, v0 = pool.k[0][:, blocks].clone(), pool.v[0][:, blocks].clone()
    store = SessionStore(name="tt_tier_exact")
    assert store.suspend("s", pool, 1, list(range(10))) == 10
    assert pool.sequences() == [] and pool.num_free == DIMS["num_blocks"] - 1
    # the suspended bytes live on the host: scribble over the whole pool
    pool.allocate(7, 8)
    pool.k[0].fill_(-3.0)
    pool.v[0].fill_(5.0)
    pool.allocate(2, 14)
    ent = store.match("s", list(range(14)))
    assert ent is not None and ent.payload["nb"] == 3
    new = list(pool.sequence(2).block_ids)
    assert set(new[:3]) != set(blocks)
    assert store.resume_into(pool, ent, new) == 10
    assert torch.equal(pool.k[0][:, new[:3]], k0)
    assert torch.equal(pool.v[0][:, new[:3]], v0)
    # the padded lane (width 4) went to the null block only
    assert bool((pool.k[0][:, new[3]] == -3.0).all())
    assert store.n_resumes == 1 and store.resumed_tokens == 10
    pool.check_invariants()


def test_match_drops_a_diverged_entry():
    _jp, pool = _pools()
    store = SessionStore(name="tt_tier_match")
    pool.allocate(1, 8)
    store.suspend("s", pool, 1, list(range(1, 9)))
    assert store.match("s", list(range(1, 12))) is not None
    assert store.n_misses == 0 and len(store) == 1
    assert store.match("s", [1, 2, 99, 4, 5, 6, 7, 8, 9]) is None
    assert len(store) == 0 and store.host_bytes == 0
    assert store.n_misses == 1
    assert store.match("s", list(range(1, 12))) is None  # gone
    for i, sid in ((2, "t"), (3, "u")):
        pool.allocate(i, 5)
        store.suspend(sid, pool, i, list(range(5)))
    assert store.drop("t") and not store.drop("t")
    assert len(store) == 1 and store.host_bytes > 0
    store.clear()
    assert len(store) == 0 and store.host_bytes == 0


# (session, context tokens) in suspend order: replaced sessions, a
# token-less one (nothing stored) and lengths padded to 1, 2, 4 and 8
# blocks
SUSPENDS = [("a", 8), ("b", 3), ("c", 13), ("a", 5), ("d", 17), ("e", 0),
            ("f", 1), ("b", 9), ("g", 30), ("h", 4)]


@pytest.mark.parametrize("budget", [None, 3000, 1300])
def test_charges_and_evictions_equal_the_jax_store(budget):
    jp, tp = _pools(seed=1)
    jst = JaxStore(host_budget_bytes=budget, name=f"tt_tier_j_{budget}")
    tst = SessionStore(host_budget_bytes=budget, name=f"tt_tier_t_{budget}")
    for i, (sid, n) in enumerate(SUSPENDS):
        toks = list(range(100 + i, 100 + i + n))
        jp.allocate(i, max(n, 1))
        tp.allocate(i, max(n, 1))
        assert jst.suspend(sid, jp, i, toks) == tst.suspend(sid, tp, i, toks)
        assert list(tst._sessions) == list(jst._sessions), (i, sid)
        assert tst.host_bytes == jst.host_bytes
        assert tst.n_evictions == jst.n_evictions
        for key, ent in jst._sessions.items():
            mine = tst._sessions[key]
            assert mine.nbytes == ent.nbytes
            assert mine.tokens == ent.tokens
            for part in ("k", "v"):
                np.testing.assert_array_equal(
                    mine.payload[part][0].numpy(), np.asarray(ent.payload[part]))
        assert [s.seq_id for s in tp.sequences()] == \
            [s.seq_id for s in jp.sequences()] == []
    if budget is not None:
        assert tst.n_evictions > 0
        assert tst.host_bytes <= budget or len(tst) == 1
    assert tst.stats()["evictions"] == jst.stats()["evictions"]


@pytest.fixture(scope="module")
def weights():
    return fleet_weights()


def test_engine_session_turns_match_the_jax_engine(weights):
    store = SessionStore(name="tt_tier_engine")
    eng = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                            session_store=store, **EKW)
    ref = JaxEngine(CFG_J, weights[0], name="tt_tier_ref", **EKW)
    p1 = [5, 4, 3, 2, 1, 0, 1, 2, 7, 7, 3]
    out1 = eng.generate_batch([(p1, 9, {"session": "c1"})])[0]
    assert out1 == ref.generate(p1, 9)
    # the suspend stored admitted + all emitted tokens but the last
    assert store._sessions["c1"].tokens == p1 + out1[:-1]
    assert eng.pool.sequences() == []
    p2 = p1 + out1 + [9, 9, 1]
    out2 = eng.generate_batch([(p2, 9, {"session": "c1"})])[0]
    assert store.n_resumes == 1
    assert store.resumed_tokens == len(p1) + len(out1) - 1
    assert out2 == ref.generate(p2, 9)
    # an edited history misses and recomputes
    p3 = [1] + p2[1:]
    assert eng.generate_batch([(p3, 5, {"session": "c1"})])[0] == \
        ref.generate(p3, 5)
    assert store.n_resumes == 1 and store.n_misses >= 2


def test_failed_suspend_is_counted_frees_blocks_and_recomputes(
        weights, monkeypatch):
    store = SessionStore(name="tt_tier_fail")
    eng = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                            session_store=store, **EKW)
    p1 = [3, 3, 1, 4, 1, 5, 9]

    def broken(seq_id, context_tokens):
        raise RuntimeError("host copy failed")

    monkeypatch.setattr(eng.pool, "suspend_host", broken)
    out1 = eng.generate_batch([(p1, 6, {"session": "s"})])[0]
    assert store.n_suspend_failures == 1 and store.n_suspends == 0
    assert store.stats()["suspend_failures"] == 1
    assert eng.pool.sequences() == []
    assert eng.pool.num_free == EKW["num_blocks"] - 1
    eng.pool.check_invariants()
    monkeypatch.undo()
    p2 = p1 + out1 + [2]
    fresh = PagedDecodeEngine(CFG_T, weights[1], device="cpu", **EKW)
    assert eng.generate_batch([(p2, 6, {"session": "s"})])[0] == \
        fresh.generate(p2, 6)
    assert store.n_resumes == 0 and store.n_suspends == 1
