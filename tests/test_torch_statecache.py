"""pathway_tpu_torch constant-memory SSD state cache against the JAX
package.

Weights are made from a seed with numpy, grafted with the JAX package's
``ssd_augment_params`` and carried across by ``models/convert.py`` (which
accepts ``w_a``/``b_a``), at the JAX state-cache tests' widths
(``tests/test_statecache.py``):

- the port's own graft equals the JAX graft within 1e-6 (the same
  threefry bits; ``erfinv`` and ``linspace`` round differently);
- ``ssd_mixed_step`` / ``ssd_decode_step`` / ``ssd_chained_decode`` and
  their sampled twins: logits and states within 1e-5 (f32) of JAX's, ids
  equal; the chunk form equals the recurrent form; the chain freezes
  rows past their budget or EOS;
- ``StateDecodeEngine``: the JAX engine's greedy tokens (mixed lengths,
  beyond ``max_len``), sampled tokens identical across suspend/resume,
  restart and fleet failover, a reused slot starting from zero, the
  restart rebuilt through ``make_backend``, and ``check_invariants``
  before every round of every engine run (no two live rows share a
  slot);
- ``StateCache``: flags, unsupported ops, a slot-lifecycle fuzz, real
  bytes charged by the session store; the paged engine's pool built
  through ``make_backend("paged")`` with unchanged results.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu import faults as jfaults
from pathway_tpu.kvcache import StateDecodeEngine as JaxState
from pathway_tpu.models import decoder as jdec
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache import (BlockPool, CacheBackend,
                                       PagedDecodeEngine, PoolExhausted,
                                       SessionStore, StateCache,
                                       StateDecodeEngine, UnsupportedCacheOp,
                                       make_backend)
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.serve import ReplicaFleet

TOL = dict(atol=1e-5, rtol=1e-5)  # f32: summation order only
WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
L, H = WIDTHS["n_layers"], WIDTHS["n_heads"]
HD = WIDTHS["d_model"] // H
SKW = dict(max_slots=24, max_batch_size=4, prefill_chunk=8, chain_steps=4)
SAMPLING = {"sampling": (0.8, 8, 0.95, 1234)}


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f = WIDTHS["d_model"], WIDTHS["d_ff"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"embed": dense((WIDTHS["vocab_size"], d), 0.5),
         "pos_embed": dense((WIDTHS["max_len"], d), 0.1),
         "ln_f_scale": np.ones(d, np.float32),
         "ln_f_bias": np.zeros(d, np.float32), "layers": []}
    for _ in range(L):
        layer = {w: dense(s) for w, s in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w_up", (d, f)), ("w_down", (f, d)))}
        for ln in ("ln1", "ln2"):
            layer[f"{ln}_scale"] = np.ones(d, np.float32)
            layer[f"{ln}_bias"] = np.zeros(d, np.float32)
        p["layers"].append(layer)
    return p


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's params): the JAX graft of the numpy
    weights, carried across leaf by leaf."""
    pj = jdec.ssd_augment_params(
        jax.tree_util.tree_map(jnp.asarray, _np_params(0)), CFG_J)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, decoder_params_from_numpy(tree, CFG_T, device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, WIDTHS["vocab_size"], size=n)]
            for n in lengths]


def _checked(eng):
    """``eng`` with ``check_invariants`` run before every round: no two
    live rows ever share a slot (idle rows alone write slot 0)."""
    step = eng._step_round

    def checked(*args, **kwargs):
        eng.pool.check_invariants()
        return step(*args, **kwargs)

    eng._step_round = checked
    return eng


def _engine(weights, **kw):
    return _checked(StateDecodeEngine(CFG_T, weights[1], device="cpu",
                                      **dict(SKW, **kw)))


def _jax_engine(weights, name, **kw):
    return JaxState(CFG_J, weights[0], name=name, **dict(SKW, **kw))


def _zeros(B):
    return torch.zeros((L, B, H, HD, HD))


def _ref_greedy(params, prompt, n_new):
    """The pure token-by-token recurrence of the port, one sequence."""
    s = _zeros(1)
    logits = None
    for t in prompt:
        logits, s = tdec._ssd_forward_step(params, CFG_T, s,
                                           torch.tensor([t]), None)
    out = []
    for _ in range(n_new):
        out.append(int(tdec.greedy(logits)[0]))
        logits, s = tdec._ssd_forward_step(params, CFG_T, s,
                                           torch.tensor([out[-1]]), None)
    return out


# -- the graft and the converter -----------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_ssd_augment_params_matches_jax_graft(seed):
    tree = _np_params(1)
    pj = jdec.ssd_augment_params(
        jax.tree_util.tree_map(jnp.asarray, tree), CFG_J, seed=seed)
    pt = tdec.ssd_augment_params(
        decoder_params_from_numpy(tree, CFG_T, device="cpu"), CFG_T,
        seed=seed)
    for lj, lt in zip(pj["layers"], pt["layers"]):
        for k in ("w_a", "b_a"):
            assert lt[k].dtype == torch.float32
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]),
                                       atol=1e-6, rtol=0)
        assert lt["wq"] is not None
    again = tdec.ssd_augment_params(
        decoder_params_from_numpy(tree, CFG_T, device="cpu"), CFG_T,
        seed=seed)
    assert all(torch.equal(a["w_a"], b["w_a"])
               for a, b in zip(pt["layers"], again["layers"]))


def test_converter_accepts_ssd_leaves_and_rejects_others(weights):
    tree = jax.tree_util.tree_map(np.asarray, weights[0])
    out = decoder_params_from_numpy(tree, CFG_T, device="cpu")
    assert tuple(out["layers"][0]["w_a"].shape) == (WIDTHS["d_model"], H)
    assert tuple(out["layers"][0]["b_a"].shape) == (H,)
    bad = dict(tree, layers=[dict(tree["layers"][0], w_b=np.zeros(3))]
               + tree["layers"][1:])
    with pytest.raises(ValueError, match="unknown \\['w_b'\\]"):
        decoder_params_from_numpy(bad, CFG_T, device="cpu")
    wrong = dict(tree, layers=[dict(tree["layers"][0],
                                    w_a=np.zeros((WIDTHS["d_model"], 3)))]
                 + tree["layers"][1:])
    with pytest.raises(ValueError, match="w_a"):
        decoder_params_from_numpy(wrong, CFG_T, device="cpu")


# -- the SSD programs ----------------------------------------------------------


@pytest.mark.parametrize("C", [8, 5])
def test_chunk_recurrent_primitive_identity(weights, C):
    """One prompt through ssd_mixed_step in chunks of C (a partial tail
    chunk included) against the token-by-token recurrence: the same
    final state and last-token logits."""
    pt = weights[1]
    prompt = _prompts((21,), seed=3)[0]
    state = _zeros(4)
    out = None
    for i in range(0, len(prompt), C):
        run = prompt[i:i + C]
        tokens = torch.zeros((1, C), dtype=torch.long)
        tokens[0, :len(run)] = torch.tensor(run)
        out, state = tdec.ssd_mixed_step(pt, CFG_T, state, tokens,
                                         torch.tensor([len(run)]),
                                         torch.tensor([2]))
    s = _zeros(1)
    ref = None
    for t in prompt:
        ref, s = tdec._ssd_forward_step(pt, CFG_T, s, torch.tensor([t]),
                                        None)
    np.testing.assert_allclose(state[:, 2].numpy(), s[:, 0].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=1e-4)
    assert not state[:, [0, 1, 3]].any()  # only the row's slot moved


def _state(seed, S=6):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((L, S, H, HD, HD))).astype(np.float32)


def test_ssd_mixed_step_matches_jax(weights):
    pj, pt = weights
    rng = np.random.default_rng(11)
    B, C = 4, 8
    tokens = rng.integers(0, WIDTHS["vocab_size"], size=(B, C))
    n_valid = np.array([8, 3, 1, 0])  # full, partial, decode, idle
    slots = np.array([2, 5, 1, 0])
    st0 = _state(1)
    oj, sj = jdec.ssd_mixed_step(pj, CFG_J, jnp.asarray(st0),
                                 jnp.asarray(tokens, jnp.int32),
                                 jnp.asarray(n_valid, jnp.int32),
                                 jnp.asarray(slots, jnp.int32))
    st = torch.from_numpy(st0.copy())
    ot, st2 = tdec.ssd_mixed_step(pt, CFG_T, st, torch.from_numpy(tokens),
                                  torch.from_numpy(n_valid),
                                  torch.from_numpy(slots))
    assert st2 is st  # in place
    np.testing.assert_allclose(ot.numpy()[:3], np.asarray(oj)[:3], **TOL)
    np.testing.assert_allclose(st.numpy()[:, 1:], np.asarray(sj)[:, 1:],
                               **TOL)


def test_ssd_decode_step_matches_jax(weights):
    pj, pt = weights
    token = np.array([3, 17, 40])
    slots = np.array([4, 1, 0])
    st0 = _state(2)
    oj, sj = jdec.ssd_decode_step(pj, CFG_J, jnp.asarray(st0),
                                  jnp.asarray(token, jnp.int32),
                                  jnp.asarray(slots, jnp.int32))
    st = torch.from_numpy(st0.copy())
    ot, _ = tdec.ssd_decode_step(pt, CFG_T, st, torch.from_numpy(token),
                                 torch.from_numpy(slots))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def _chain_inputs():
    token = np.array([5, 9, 33, 0])
    slots = np.array([1, 3, 4, 0])
    rem = np.array([6, 2, 6, 0])  # unequal budgets; an idle row
    return token, slots, rem


@pytest.mark.parametrize("eos", [False, True])
def test_ssd_chained_decode_matches_jax(weights, eos):
    pj, pt = weights
    token, slots, rem = _chain_inputs()
    K = 6
    st0 = _state(3)
    stop = -1
    if eos:
        # the third row's third greedy id becomes the EOS: it must freeze
        ids0, _ = tdec.ssd_chained_decode(
            pt, CFG_T, torch.from_numpy(st0.copy()), torch.from_numpy(token),
            torch.from_numpy(slots), torch.arange(K), torch.from_numpy(rem),
            torch.tensor(-1))
        stop = int(ids0[2, 2])
    ij, sj = jdec.ssd_chained_decode(
        pj, CFG_J, jnp.asarray(st0), jnp.asarray(token, jnp.int32),
        jnp.asarray(slots, jnp.int32), jnp.arange(K, dtype=jnp.int32),
        jnp.asarray(rem, jnp.int32), jnp.asarray(stop, jnp.int32))
    st = torch.from_numpy(st0.copy())
    it, _ = tdec.ssd_chained_decode(
        pt, CFG_T, st, torch.from_numpy(token), torch.from_numpy(slots),
        torch.arange(K), torch.from_numpy(rem), torch.tensor(stop))
    assert it.dtype == torch.int32 and tuple(it.shape) == (4, K)
    np.testing.assert_array_equal(it.numpy()[:3], np.asarray(ij)[:3])
    np.testing.assert_allclose(st.numpy()[:, 1:], np.asarray(sj)[:, 1:],
                               **TOL)
    # frozen rows repeat their last id
    assert (it[1, 2:] == it[1, 1]).all()
    if eos:
        stop_at = int((it[2] == stop).nonzero()[0])
        assert (it[2, stop_at:] == stop).all()


def test_ssd_chain_freeze_equals_stepwise(weights):
    """The budget-2 row of a 6-step chain FREEZES after its 2 steps: its
    state is bit-identical to a 2-step chain's over the same batch, and
    equals its 2 steps taken one at a time (batch 1: BLAS rounding
    only); its id repeats once frozen."""
    pt = weights[1]
    token, slots, rem = _chain_inputs()
    st0 = torch.from_numpy(_state(4))

    def chain(K):
        st = st0.clone()
        ids, _ = tdec.ssd_chained_decode(
            pt, CFG_T, st, torch.from_numpy(token), torch.from_numpy(slots),
            torch.arange(K), torch.from_numpy(rem), torch.tensor(-1))
        return ids, st

    ids, chained = chain(6)
    ids2, short = chain(2)
    assert torch.equal(chained[:, 3], short[:, 3])
    assert torch.equal(ids[:, :2], ids2)
    step = st0.clone()
    tok = torch.from_numpy(token[1:2])
    for t in range(2):
        logits, _ = tdec.ssd_decode_step(pt, CFG_T, step, tok,
                                         torch.tensor([3]))
        tok = tdec.greedy(logits)
        assert int(tok[0]) == int(ids[1, t])
    np.testing.assert_allclose(chained[:, 3].numpy(), step[:, 3].numpy(),
                               **TOL)
    assert (ids[1, 2:] == ids[1, 1]).all()


def test_ssd_sampled_programs_match_jax(weights):
    pj, pt = weights
    token, slots, rem = _chain_inputs()
    B = 4
    temp = np.array([0.8, 0.0, 1.2, 0.7], np.float32)
    top_k = np.array([8, 0, 0, 5])
    top_p = np.array([0.95, 1.0, 0.9, 1.0], np.float32)
    seed = np.array([1, 2, 3, 4])
    emit = np.array([0, 5, 2, 1])
    sj_args = [jnp.asarray(temp), jnp.asarray(top_k, jnp.int32),
               jnp.asarray(top_p), jnp.asarray(seed, jnp.int32),
               jnp.asarray(emit, jnp.int32)]
    st_args = [torch.from_numpy(a) for a in (temp, top_k, top_p, seed, emit)]
    st0 = _state(5)
    # one decode step
    ij, _ = jdec.ssd_decode_step_sampled(
        pj, CFG_J, jnp.asarray(st0), jnp.asarray(token, jnp.int32),
        jnp.asarray(slots, jnp.int32), *sj_args)
    it, _ = tdec.ssd_decode_step_sampled(
        pt, CFG_T, torch.from_numpy(st0.copy()), torch.from_numpy(token),
        torch.from_numpy(slots), *st_args)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # one mixed step
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, WIDTHS["vocab_size"], size=(B, 8))
    n_valid = np.array([8, 2, 1, 0])
    ij, _ = jdec.ssd_mixed_step_sampled(
        pj, CFG_J, jnp.asarray(st0), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(n_valid, jnp.int32), jnp.asarray(slots, jnp.int32),
        *sj_args)
    it, _ = tdec.ssd_mixed_step_sampled(
        pt, CFG_T, torch.from_numpy(st0.copy()), torch.from_numpy(tokens),
        torch.from_numpy(n_valid), torch.from_numpy(slots), *st_args)
    np.testing.assert_array_equal(it.numpy()[:3], np.asarray(ij)[:3])
    # a chain
    ij, sj = jdec.ssd_chained_decode_sampled(
        pj, CFG_J, jnp.asarray(st0), jnp.asarray(token, jnp.int32),
        jnp.asarray(slots, jnp.int32), jnp.arange(5, dtype=jnp.int32),
        jnp.asarray(rem, jnp.int32), jnp.asarray(-1, jnp.int32), *sj_args)
    st = torch.from_numpy(st0.copy())
    it, _ = tdec.ssd_chained_decode_sampled(
        pt, CFG_T, st, torch.from_numpy(token), torch.from_numpy(slots),
        torch.arange(5), torch.from_numpy(rem), torch.tensor(-1), *st_args)
    np.testing.assert_array_equal(it.numpy()[:3], np.asarray(ij)[:3])
    np.testing.assert_allclose(st.numpy()[:, 1:], np.asarray(sj)[:, 1:],
                               **TOL)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("chain_steps", [1, 4])
def test_engine_greedy_identity_mixed_lengths(weights, chain_steps):
    prompts = _prompts((3, 5, 8, 11, 16, 17, 27, 31), seed=7)
    reqs = [(list(p), 8) for p in prompts]
    want = _jax_engine(weights, f"t_tssd_id_{chain_steps}",
                       chain_steps=chain_steps).generate_batch(reqs)
    eng = _engine(weights, chain_steps=chain_steps)
    assert eng.generate_batch(reqs) == want
    assert want == [_ref_greedy(eng.params, p, 8) for p in prompts]
    assert eng.rounds["mixed"] > 0
    assert eng.rounds["chain" if chain_steps > 1 else "decode"] > 0
    eng.pool.check_invariants()
    assert eng.pool.slots_in_use == 0


def test_engine_greedy_identity_beyond_max_len(weights):
    prompt = _prompts((200,), seed=11)[0]  # past cfg.max_len = 128
    want = _jax_engine(weights, "t_tssd_long").generate(prompt, 4)
    assert _engine(weights).generate(prompt, 4) == want


def test_engine_stop_token_and_serve_batch(weights):
    prompts = _prompts((4, 9, 13), seed=12)
    eng = _engine(weights)
    full = eng.generate_batch([(list(p), 8) for p in prompts])
    stop = full[0][3]
    want = _jax_engine(weights, "t_tssd_stop").generate_batch(
        [(list(p), 8) for p in prompts], stop_token=stop)
    got = eng.generate_batch([(list(p), 8) for p in prompts],
                             stop_token=stop)
    assert got == want
    assert got[0] == full[0][:full[0].index(stop) + 1]
    assert eng.serve_batch([(list(p), 8, 0) for p in prompts]) == full


def test_sampled_identity_across_suspend_resume(weights):
    prompt = _prompts((12,), seed=13)[0]
    clean = _engine(weights)
    t1c = clean.generate_batch([(list(prompt), 8, dict(SAMPLING))])[0]
    t2c = clean.generate_batch(
        [(list(prompt + t1c + [5]), 8, dict(SAMPLING))])[0]
    jax_eng = _jax_engine(weights, "t_tssd_sess_ref")
    assert jax_eng.generate_batch(
        [(list(prompt), 8, dict(SAMPLING))])[0] == t1c
    store = SessionStore()
    eng = _engine(weights, session_store=store)
    opts = dict(SAMPLING, session="s-17")
    t1 = eng.generate_batch([(list(prompt), 8, dict(opts))])[0]
    t2 = eng.generate_batch([(list(prompt + t1 + [5]), 8, dict(opts))])[0]
    assert (t1, t2) == (t1c, t2c)
    st = store.stats()
    assert st["resumes"] >= 1 and st["suspends"] >= 1
    assert st["suspend_failures"] == 0
    snap = eng.pool.stats()
    assert snap["suspends"] >= 1 and snap["resumes"] >= 1


def test_resumed_turn_equals_store_less_recompute(weights):
    """Greedy turn 2 resumed from the store equals a store-less engine on
    the full prompt, and a stored context covering the whole new prompt
    is treated as a miss (recomputed)."""
    prompt = _prompts((10,), seed=14)[0]
    store = SessionStore()
    eng = _engine(weights, session_store=store)
    t1 = eng.generate_batch([(list(prompt), 6, {"session": "c"})])[0]
    turn2 = prompt + t1 + [7, 8]
    t2 = eng.generate_batch([(list(turn2), 6, {"session": "c"})])[0]
    assert t2 == _engine(weights).generate(turn2, 6)
    assert store.stats()["resumes"] == 1
    # a replayed turn whose prompt the stored context already covers
    again = eng.generate_batch([(list(turn2), 6, {"session": "c"})])[0]
    assert again == t2 and store.stats()["resumes"] == 1


def test_sampled_identity_across_engine_restart(weights):
    reqs = [(p, 10, dict(SAMPLING)) for p in _prompts((6, 6, 6), seed=17)]
    clean = _engine(weights).generate_batch(reqs)
    assert clean == _jax_engine(weights, "t_tssd_rs").generate_batch(reqs)
    eng = _engine(weights, max_restarts=1, watchdog_timeout_s=120.0)
    faults.install("engine.dispatch.chain", "raise", nth=2)
    got = eng.generate_batch(reqs)
    faults.clear()
    assert got == clean
    assert eng.n_restarts == 1
    eng.pool.check_invariants()


def test_state_engine_restart_rebuilds_through_seam(weights):
    reqs = [(p, 8) for p in _prompts((6, 6, 6), seed=41)]
    clean = _engine(weights).generate_batch(reqs)
    eng = _engine(weights, max_restarts=1)
    old_pool = eng.pool
    faults.install("engine.dispatch.mixed", "raise", nth=2)
    got = eng.generate_batch(reqs)
    faults.clear()
    assert got == clean
    assert eng.pool is not old_pool and isinstance(eng.pool, StateCache)
    assert eng.n_restarts == 1
    eng.pool.check_invariants()


def test_restarts_spent_fail_typed_or_degrade(weights):
    from pathway_tpu_torch.serve import EngineFailedError

    reqs = [([1, 2, 3], 5), ([4, 5], 4)]
    eng = _engine(weights, max_restarts=0)
    faults.install("engine.dispatch.mixed", "raise", nth=1)
    out = eng.generate_batch(reqs, return_exceptions=True)
    faults.clear()
    assert all(isinstance(r, EngineFailedError) for r in out)
    calls = []

    def degrade(prompt, n, emitted):
        calls.append((list(prompt), n, list(emitted)))
        return [9] * n

    eng = _engine(weights, max_restarts=0, degrade_fn=degrade)
    faults.install("engine.dispatch.chain", "raise", nth=1)
    out = eng.generate_batch(reqs)
    faults.clear()
    assert [len(t) for t in out] == [5, 4] and len(calls) == 2
    for toks, (_p, n, emitted) in zip(out, calls):
        assert toks == emitted + [9] * n


def test_sampled_identity_across_fleet_failover(weights):
    prompts = _prompts((5, 5, 5, 5), seed=19)
    clean = _engine(weights).generate_batch(
        [(list(p), 10, dict(SAMPLING)) for p in prompts])
    fleet = ReplicaFleet(CFG_T, weights[1], replicas=2, cache="state",
                         name="t_tssd_fleet", max_restarts=0, device="cpu",
                         **SKW)
    try:
        assert all(isinstance(r.engine, StateDecodeEngine)
                   for r in fleet.replicas)
        for rep in fleet.replicas:
            _checked(rep.engine)
        faults.install("engine.dispatch.chain", "raise", nth=3)
        results: list = [None] * len(prompts)

        def run(i):
            results[i] = fleet.submit(list(prompts[i]), 10,
                                      sampling=SAMPLING["sampling"])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        faults.clear()
        assert results == clean
        st = fleet.stats()
        assert st["live"] == 1 and st["recovery_s"]
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_fleet_sessions_share_the_store(weights):
    store = SessionStore()
    fleet = ReplicaFleet(CFG_T, weights[1], replicas=2, cache="state",
                         name="t_tssd_fleet_sess", session_store=store,
                         max_restarts=0, device="cpu", **SKW)
    try:
        prompt = _prompts((9,), seed=21)[0]
        t1 = fleet.submit(prompt, 5, session="u")
        turn2 = prompt + t1 + [3]
        fleet.kill(fleet.route(turn2))  # turn 2 lands on the other replica
        t2 = fleet.submit(turn2, 5, session="u")
        assert t2 == _engine(weights).generate(turn2, 5)
        assert store.stats()["resumes"] == 1
    finally:
        fleet.shutdown(drain=False, timeout_s=5.0)


def test_slot_reuse_starts_from_zero_state(weights):
    prompts = _prompts((7, 7, 7), seed=29)
    eng = _engine(weights, max_slots=4)
    first = eng.generate_batch([(list(p), 6) for p in prompts])
    second = eng.generate_batch([(list(p), 6) for p in prompts])
    assert first == second
    assert second == [_ref_greedy(eng.params, p, 6) for p in prompts]


def test_pool_full_waits_then_fails_alone(weights):
    """Four requests through three slots: the fourth waits for a slot;
    alone in a full cache a request fails typed as the JAX engine's."""
    prompts = _prompts((5, 6, 7, 8), seed=31)
    eng = _engine(weights, max_slots=4)
    got = eng.generate_batch([(list(p), 5) for p in prompts])
    assert got == [_ref_greedy(eng.params, p, 5) for p in prompts]
    for i in range(3):
        eng.pool.allocate(100 + i, 1)
    out = eng.generate_batch([(prompts[0], 3)], return_exceptions=True)
    assert isinstance(out[0], RuntimeError) and "no free slot" in str(out[0])


# -- the backend ---------------------------------------------------------------


def test_slot_lifecycle_fuzz_invariants():
    cache = StateCache(max_slots=9, n_layers=2, n_heads=4, head_dim=8,
                       device="cpu")
    rng = np.random.default_rng(23)
    live: dict[int, list[int]] = {}
    value: dict[int, float] = {}  # each live sequence's fill value
    suspended: list = []
    next_id = 0
    for step in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            try:
                st = cache.allocate(next_id, int(rng.integers(1, 40)))
                live[next_id] = [int(t) for t in rng.integers(0, 64, 4)]
                assert st.block_ids[0] != 0
                assert not cache.shards[0][:, st.block_ids[0]].any()
                value[next_id] = float(next_id + 1)
                cache.shards[0][:, st.block_ids[0]] = value[next_id]
                next_id += 1
            except PoolExhausted:
                assert cache.num_free == 0
        elif op == 1 and live:
            sid = int(rng.choice(list(live)))
            cache.free_sequence(sid)
            del live[sid], value[sid]
        elif op == 2 and live:
            sid = int(rng.choice(list(live)))
            payload, nbytes = cache.suspend_host(sid, live.pop(sid))
            assert nbytes == 2 * 4 * 8 * 8 * 4 == payload["s"][0].nbytes
            suspended.append((value.pop(sid), payload))
        elif op == 3 and suspended:
            val, payload = suspended.pop()
            try:
                st = cache.allocate(next_id, 4)
            except PoolExhausted:
                suspended.append((val, payload))
                continue
            cache.resume_host(payload, st.block_ids)
            assert bool((cache.shards[0][:, st.block_ids[0]] == val).all())
            value[next_id] = val
            live[next_id] = [1, 2, 3, 4]
            next_id += 1
        if step % 10 == 0:
            cache.check_invariants()
    cache.check_invariants()
    for sid in list(live):
        cache.free_sequence(sid)
    for i in range(cache.max_slots - 1):
        cache.allocate(10_000 + i, 1)
    before = (cache.num_free, len(cache.sequences()))
    with pytest.raises(PoolExhausted):
        cache.allocate(99_999, 1)
    assert (cache.num_free, len(cache.sequences())) == before
    cache.check_invariants()
    # a corrupted table trips the check
    cache.sequence(10_000).block_ids = [cache.sequence(10_001).block_ids[0]]
    with pytest.raises(AssertionError, match="same slot"):
        cache.check_invariants()


def test_backend_contract_flags_and_unsupported_ops():
    cache = make_backend("state", max_slots=4, n_layers=2, n_heads=4,
                         head_dim=8, device="cpu")
    assert isinstance(cache, StateCache) and isinstance(cache, CacheBackend)
    assert cache.cache_kind == "state"
    assert not (cache.supports_fork or cache.supports_prefix
                or cache.supports_preemption)
    with pytest.raises(UnsupportedCacheOp):
        cache.allocate(0, 4, shared_blocks=[1])
    with pytest.raises(UnsupportedCacheOp):
        cache.fork(0, 1)
    with pytest.raises(UnsupportedCacheOp):
        cache.preempt()
    assert issubclass(UnsupportedCacheOp, NotImplementedError)
    st = cache.allocate(0, 4)
    assert cache.extend_slots(0, 3) == [(st.block_ids[0], 0)] * 3
    assert cache.sequence(0).n_tokens == 7
    assert cache.state_bytes_per_seq(1) == cache.state_bytes_per_seq(4096)
    assert cache.state_bytes_per_seq() == 2 * 4 * 8 * 8 * 4
    assert cache.per_shard_bytes == 4 * cache.state_bytes_per_seq()
    with pytest.raises(ValueError, match="slot 0 is reserved"):
        StateCache(max_slots=1, n_layers=1, n_heads=1, head_dim=2,
                   device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            StateCache(max_slots=4, n_layers=1, n_heads=1, head_dim=2)


def test_paged_engine_builds_pool_through_make_backend(weights):
    import pathway_tpu_torch.kvcache.backend as backend

    made = []
    orig = backend._BACKENDS.get("paged")
    backend.register_backend(
        "paged", lambda **kw: made.append(kw) or BlockPool(**kw))
    try:
        eng = PagedDecodeEngine(CFG_T, weights[1], num_blocks=64,
                                block_size=4, max_batch_size=4,
                                prefill_chunk=8, device="cpu",
                                max_restarts=1)
        assert len(made) == 1 and isinstance(eng.pool, BlockPool)
        assert eng.pool.cache_kind == "paged"
        assert eng.pool.supports_prefix and eng.pool.supports_preemption
        faults.install("engine.dispatch.mixed", "raise", nth=1)
        eng.generate_batch([([1, 2, 3], 4)])
        faults.clear()
        assert eng.n_restarts == 1 and len(made) == 2  # the rebuild too
    finally:
        if orig is None:
            backend._BACKENDS.pop("paged", None)
        else:
            backend.register_backend("paged", orig)


def test_blockpool_parity_through_backend_interface():
    kw = dict(num_blocks=32, block_size=4, n_layers=2, n_heads=H,
              head_dim=HD, device="cpu")
    direct = BlockPool(**kw)
    seamed = make_backend("paged", **kw)
    assert type(seamed) is BlockPool
    for pool in (direct, seamed):
        st = pool.allocate(0, 11)
        assert len(st.block_ids) == pool.blocks_for(11)
        pool.k[0].normal_(generator=torch.Generator().manual_seed(1))
    assert direct.sequence(0).block_ids == seamed.sequence(0).block_ids
    assert direct.state_bytes_per_seq(11) == 3 * 2 * 2 * 4 * H * HD * 4
    p_direct, b_direct = direct.suspend_host(0, list(range(11)))
    p_seamed, b_seamed = seamed.suspend_host(0, list(range(11)))
    assert b_direct == b_seamed
    assert torch.equal(p_direct["k"][0], p_seamed["k"][0])
    direct.check_invariants()
    seamed.check_invariants()
    with pytest.raises(ValueError, match="unknown cache backend"):
        make_backend("bogus")


def test_session_store_charges_real_buffer_bytes():
    store = SessionStore()
    pool = BlockPool(num_blocks=32, block_size=4, n_layers=2, n_heads=4,
                     head_dim=8, device="cpu")
    pool.allocate(0, 11)
    per_block = 2 * 4 * 4 * 8 * 4  # L * bs * H * hd * itemsize
    store.suspend("pg", pool, 0, list(range(11)))
    ent = store.match("pg", list(range(11)))
    assert ent.nbytes == 2 * 4 * per_block  # k + v, 3 blocks padded to 4
    cache = StateCache(max_slots=8, n_layers=2, n_heads=4, head_dim=8,
                       device="cpu")
    expect = 2 * 4 * 8 * 8 * 4  # L * H * hd * hd * itemsize
    cache.allocate(1, 128)
    store.suspend("st-short", cache, 1, list(range(128)))
    cache.allocate(2, 2048)
    store.suspend("st-long", cache, 2, list(range(2048)))
    short = store.match("st-short", list(range(128)))
    long = store.match("st-long", list(range(2048)))
    assert short.nbytes == long.nbytes == expect
    assert short.payload["s"][0].nbytes == expect
    assert store.host_bytes == ent.nbytes + 2 * expect
    assert cache.stats()["suspends"] == 2


def test_bf16_state_drift_is_no_more_than_the_jax_packages(weights):
    """Each package's ``StateDecodeEngine`` in bf16 prefills one 256-token
    prompt (chunks of 8), and its slot's state is held against the
    package's own f32 token-by-token recurrence over the same prompt: the
    port's relative drift (largest absolute difference over the largest
    f32 entry) may be at most 1.5x the JAX package's."""
    pj, pt = weights
    [prompt] = _prompts([256], seed=31)

    def engine_state(eng, as_f32):
        eng.generate_batch([(prompt, 1)])
        state = as_f32(eng.pool)
        live = [s for s in range(state.shape[1])
                if np.abs(state[:, s]).max() > 0]
        assert len(live) == 1, live  # the request's slot; 0 stays null
        return state[:, live[0]]

    eng_t = StateDecodeEngine(dataclasses.replace(CFG_T, dtype=torch.bfloat16),
                              pt, device="cpu", **SKW)
    got_t = engine_state(eng_t, lambda pool: pool.shards[0].float().numpy())
    eng_j = JaxState(dataclasses.replace(CFG_J, dtype=jnp.bfloat16), pj,
                     name="drift_bf16", **SKW)
    got_j = engine_state(
        eng_j, lambda pool: np.asarray(pool.state.astype(jnp.float32)))

    s = _zeros(1)
    for tok in prompt:
        _out, s = tdec._ssd_forward_step(pt, CFG_T, s, torch.tensor([tok]),
                                         None)
    ref_t = s[:, 0].numpy()
    step_j = jax.jit(lambda st, tok: jdec._ssd_forward_step(
        pj, CFG_J, st, tok, None, None))
    sj = jnp.zeros((L, 1, H, HD, HD), jnp.float32)
    for tok in prompt:
        _out, sj = step_j(sj, jnp.asarray([tok], jnp.int32))
    ref_j = np.asarray(sj)[:, 0]
    np.testing.assert_allclose(ref_t, ref_j, **TOL)  # the two f32 oracles

    def drift(got, ref):
        return float(np.abs(got - ref).max() / np.abs(ref).max())

    d_t, d_j = drift(got_t, ref_t), drift(got_j, ref_j)
    assert 0 < d_j and d_t <= 1.5 * d_j, (d_t, d_j)
