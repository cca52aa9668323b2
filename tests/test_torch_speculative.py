"""pathway_tpu_torch speculative decoding against the JAX package.

The port's mirror of ``tests/test_speculative.py``:

- greedy token identity of draft + verify rounds (one ragged
  ``paged_mixed_step`` dispatch at C = k+1 query columns a row) at mixed
  lengths, over shared prefixes, under preemption and across a restart:
  the tokens equal the non-speculative port engine's AND the JAX
  engine's on the same numpy weights;
- the target model drafting for itself accepts every proposal;
- rejected slots are rolled back the same round (``truncate_slots``
  inverts ``extend_slots``), so the pool invariants hold;
- a zero-accept drafter cools off and the engine falls back to the
  chained decode; the n-gram drafter's self-match and chain-hash table;
  the controller's cooloff and re-probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache.block_pool import BlockPool
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
from pathway_tpu_torch.kvcache.speculative import (
    Drafter, DraftModelDrafter, NGramDrafter, SpecController,
    resolve_speculative,
)
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

from .test_torch_engine import CFG_J, CFG_T, WIDTHS, _np_params

EKW = dict(num_blocks=96, block_size=4, max_batch_size=4,
           seq_buckets=(16, 32, 64), prefill_chunk=8, chain_steps=4)


@pytest.fixture(scope="module")
def weights():
    tree = _np_params(0)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, CFG_T, device="cpu"))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _engine(pt, speculative, **kw):
    return PagedDecodeEngine(CFG_T, pt, device="cpu",
                             speculative=speculative, **dict(EKW, **kw))


def _jax_tokens(pj, reqs, name, **kw):
    return JaxEngine(CFG_J, pj, attn="reference", name=name,
                     **dict(EKW, **kw)).generate_batch(reqs)


def _prompts(lengths, seed=7, cyclic=False):
    """Random prompts; ``cyclic`` ones repeat a short motif, which the
    n-gram drafter's self-match proposes from."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        if cyclic:
            motif = [int(t) for t in rng.integers(0, WIDTHS["vocab_size"], 3)]
            out.append((motif * n)[:n])
        else:
            out.append([int(t) for t in
                        rng.integers(0, WIDTHS["vocab_size"], n)])
    return out


# -- token identity -----------------------------------------------------------


@pytest.mark.parametrize("spec", ["ngram", "draft_model"])
def test_spec_identity_mixed_lengths(weights, spec):
    pj, pt = weights
    prompts = (_prompts((3, 5, 8, 11)) + _prompts((9, 16, 17, 27),
                                                  cyclic=True))
    reqs = [(p, 11) for p in prompts]
    want = _jax_tokens(pj, reqs, f"t_torch_spec_{spec}")
    assert _engine(pt, None).generate_batch(reqs) == want
    ctrl = (SpecController(DraftModelDrafter(CFG_T, pt, k=4))
            if spec == "draft_model" else spec)
    on = _engine(pt, ctrl)
    assert on.generate_batch(reqs) == want
    assert on.rounds["verify"] > 0, "the drafter never produced a round"
    assert on._spec.proposed > 0
    # rejected slots were rolled back the same round
    assert not on.pool.sequences()
    on.pool.check_invariants(on.prefix.external_refs())


def test_spec_identity_shared_prefixes(weights):
    pj, pt = weights
    base = _prompts((24,), seed=19, cyclic=True)[0]
    prompts = [base[:20] + p for p in _prompts((4, 7, 9, 11), seed=23)]
    reqs = [(p, 10) for p in prompts]
    want = _jax_tokens(pj, reqs, "t_torch_spec_pfx")
    on = _engine(pt, "ngram")
    assert on.generate_batch(reqs) == want
    # the second pass drafts from the prefix cache AND the learned table
    assert on.generate_batch(reqs) == want
    assert on.rounds["verify"] > 0
    on.pool.check_invariants(on.prefix.external_refs())


def test_spec_identity_under_preemption(weights):
    pj, pt = weights
    prompts = _prompts((3, 5, 8, 11), cyclic=True)
    reqs = [(p, 12) for p in prompts]
    want = _jax_tokens(pj, reqs, "t_torch_spec_pre", num_blocks=14)
    eng = _engine(pt, "ngram", num_blocks=14)
    assert eng.generate_batch(reqs) == want
    assert eng.pool.n_preemptions > 0, "no preemption was forced"
    assert eng.rounds["verify"] > 0
    eng.pool.check_invariants(eng.prefix.external_refs())


def test_spec_restart_token_identical(weights):
    """A failing verify dispatch feeds the supervised restart; the
    drafter is a pure function of its context, so proposals replay."""
    pj, pt = weights
    rng = np.random.default_rng(11)
    reqs = [([int(t) for t in rng.integers(1, WIDTHS["vocab_size"], n)],
             6 + (i % 5)) for i, n in enumerate([3, 5, 7, 9, 12, 15, 21, 27])]
    want = _jax_tokens(pj, reqs, "t_torch_spec_rs", max_batch_size=8)
    eng = _engine(pt, SpecController(DraftModelDrafter(CFG_T, pt, k=4)),
                  max_batch_size=8, max_restarts=1)
    faults.install("engine.dispatch.verify", "raise", nth=2)
    assert eng.generate_batch(reqs) == want
    assert eng.n_restarts == 1
    assert eng.pool.sequences() == []
    assert eng.rounds["verify"] > 0


def test_sampled_rows_fall_through_and_drop_skips_drafting(weights):
    _pj, pt = weights
    prompts = _prompts((5, 9), cyclic=True)
    plain = _engine(pt, None)
    on = _engine(pt, "ngram")
    sampled = [(p, 8, {"sampling": (0.9, 0, 1.0, 5 + i)})
               for i, p in enumerate(prompts)]
    assert on.generate_batch(sampled) == plain.generate_batch(sampled)
    assert on.rounds["verify"] == 0  # sampled rows ride the plain paths
    faults.install("engine.draft", "drop", nth=0)
    greedy = [(p, 8) for p in prompts]
    assert on.generate_batch(greedy) == plain.generate_batch(greedy)
    assert on.rounds["verify"] == 0


# -- multi-token floor --------------------------------------------------------


def test_model_drafter_sustains_multi_token_dispatches(weights):
    """The target drafting for itself over a window that holds the whole
    context accepts every proposal: each verify dispatch advances its
    rows by k + 1 tokens, where budget allows."""
    pj, pt = weights
    prompts = _prompts((3, 5, 9, 14), seed=37)
    reqs = [(p, 12) for p in prompts]
    ctrl = SpecController(DraftModelDrafter(CFG_T, pt, k=4))
    on = _engine(pt, ctrl)
    assert on.generate_batch(reqs) == _jax_tokens(pj, reqs, "t_torch_md")
    assert ctrl.dispatches > 0 and ctrl.accept_rate == 1.0
    assert ctrl.emitted / ctrl.dispatches > 1.5
    on.pool.check_invariants(on.prefix.external_refs())


# -- zero-accept degradation --------------------------------------------------


class _AlwaysWrongDrafter(Drafter):
    """Proposes one token the target always refutes: its own next greedy
    token plus one."""

    name = "always_wrong"
    k = 2

    def __init__(self, oracle):
        self._oracle = oracle

    def propose(self, ctx_tokens, k: int) -> list[int]:
        nxt = self._oracle.generate(list(ctx_tokens), 1)[0]
        return [(nxt + 1) % WIDTHS["vocab_size"]]


def test_zero_accept_degrades_to_chained(weights):
    _pj, pt = weights
    prompts = _prompts((5, 9, 14), seed=41)
    reqs = [(p, 14) for p in prompts]
    want = _engine(pt, None).generate_batch(reqs)
    ctrl = SpecController(_AlwaysWrongDrafter(_engine(pt, None)),
                          accept_floor=0.6, cooloff_rounds=8)
    on = _engine(pt, ctrl)
    assert on.generate_batch(reqs) == want
    assert ctrl.dispatches > 0
    assert ctrl.accepted == 0 and ctrl.proposed > 0
    # every verify round still made progress (the bonus token)
    assert ctrl.emitted >= ctrl.dispatches
    # the cooloff handed the quiet queue back to the chain
    assert on.rounds["chain"] > 0
    on.pool.check_invariants(on.prefix.external_refs())


# -- rollback / pool contract -------------------------------------------------


def test_truncate_slots_inverts_extend():
    pool = BlockPool(num_blocks=8, block_size=4, n_layers=1, n_heads=2,
                     head_dim=4, device="cpu")
    pool.allocate(1, 6)  # 2 blocks, offset 2
    free0 = list(pool._free)
    blocks0 = list(pool.sequence(1).block_ids)
    pool.extend_slots(1, 5)  # -> 11 tokens, 3 blocks
    pool.truncate_slots(1, 5)  # full rollback
    assert pool.sequence(1).n_tokens == 6
    assert pool.sequence(1).block_ids == blocks0
    assert list(pool._free) == free0
    pool.check_invariants()
    # partial rollback: keep 2 of 5 speculative slots
    pool.extend_slots(1, 5)
    pool.truncate_slots(1, 3)
    assert pool.sequence(1).n_tokens == 8
    assert len(pool.sequence(1).block_ids) == 2
    pool.check_invariants()
    with pytest.raises(ValueError):
        pool.truncate_slots(1, 9)
    pool.truncate_slots(1, 0)
    assert pool.sequence(1).n_tokens == 8
    pool.check_invariants()


# -- arrivals stay step-boundary ----------------------------------------------


def test_spec_arrival_admitted_at_step_boundary(weights):
    """An arrival discovered mid-decode is admitted through a mixed
    round at the next step boundary while verify rounds continue around
    it; tokens match the non-speculative run."""
    _pj, pt = weights
    prompts = _prompts((6, 9, 13, 30), seed=17, cyclic=True)
    results, events = {}, []
    for mode in (None, "ngram"):
        eng = _engine(pt, mode)
        got = []
        state = {"rounds": 0}
        if mode is not None:
            for name in ("_mixed_round", "_spec_round"):
                fn = getattr(eng, name)

                def spy(*a, _fn=fn, _name=name):
                    out = _fn(*a)
                    if _name == "_mixed_round" or out:
                        events.append(_name)
                    return out
                setattr(eng, name, spy)

        def poll(n, _s=state, _mode=mode):
            _s["rounds"] += 1
            if _s["rounds"] == 3:
                if _mode is not None:
                    events.append("arrival")
                return [((prompts[3], 6), 1, got.append, got.append)]
            return []

        base = eng.generate_batch([(p, 14) for p in prompts[:3]], poll=poll)
        results[mode] = (base, got)
    assert results["ngram"] == results[None]
    assert "_spec_round" in events, "the drafter never produced a round"
    assert "_mixed_round" in events[events.index("arrival"):]


# -- drafter and controller units ---------------------------------------------


def test_ngram_self_match_prefers_most_recent():
    d = NGramDrafter(k=3, max_n=3)
    ctx = [7, 8, 1, 2, 3, 7, 8, 5, 5, 9, 7, 8]
    assert d.propose(ctx, 3) == [5, 5, 9]
    assert d.propose(ctx, 2) == [5, 5]
    assert d.propose([1, 2, 3], 3) == []
    assert d.propose(ctx, 0) == []


def test_ngram_chain_hash_table_cross_request():
    d = NGramDrafter(k=4, max_n=2)
    d._block_size = 4
    stream = [3, 1, 4, 2, 5, 9, 7, 6, 10, 11, 12, 13]
    d.note_release(stream)
    assert d.propose([3, 1, 4, 2], 4) == [5, 9, 7, 6]
    assert d.propose([3, 1, 4, 2, 5, 9], 4) == [7, 6, 10, 11]
    assert d.propose([3, 1, 4, 2, 8, 9], 4) == []
    assert d.propose([3, 1, 4, 2, 5, 9, 7, 6], 4) == [10, 11, 12, 13]


def test_spec_controller_cooloff_and_reprobe():
    class _Fixed(Drafter):
        name, k = "fixed", 2

        def propose(self, ctx, k):
            return [1, 2][:k]

    ctrl = SpecController(_Fixed(), accept_floor=0.5, cooloff_rounds=3,
                          ewma_alpha=1.0)
    assert ctrl.propose_batch([[0]], [2]) == [[1, 2]]
    ctrl.note_round(proposed=2, accepted=0, emitted=1, ms=1.0)
    for _ in range(3):
        assert ctrl.propose_batch([[0]], [2]) == [[]]
    assert ctrl.propose_batch([[0]], [2]) == [[1, 2]]
    assert (ctrl.proposed, ctrl.accepted, ctrl.emitted,
            ctrl.dispatches) == (2, 0, 1, 1)


def test_resolve_speculative_values(weights):
    _pj, pt = weights
    eng = _engine(pt, None)
    assert eng._spec is None
    for off in (False, "off"):
        assert resolve_speculative(off, eng) is None
    for value in (True, "ngram", "auto"):
        ctrl = resolve_speculative(value, eng)
        assert isinstance(ctrl.drafter, NGramDrafter) and ctrl.k == 4
        assert ctrl.drafter._block_size == eng.pool.block_size
    wrapped = resolve_speculative(NGramDrafter(k=2), eng)
    assert isinstance(wrapped, SpecController) and wrapped.k == 2
    with pytest.raises(ValueError, match="speculative="):
        resolve_speculative("eagle", eng)
    with pytest.raises(RuntimeError, match="not bound"):
        DraftModelDrafter(CFG_T, pt).propose([1, 2], 2)
