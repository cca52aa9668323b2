"""pathway_tpu_torch's full-sequence forward and training step against the
JAX package's.

The JAX params come from ``init_decoder_params`` (converted leaf by leaf
by ``decoder_params_from_numpy``), the token ids and masks from numpy
with a seed; f32 on the CPU.  Bounds: ``forward_logits`` within 1e-4
absolute and relative; ``lm_loss`` within 1e-5 relative; the gradients
against ``jax.value_and_grad``, and params and momentum after three
chained ``make_train_step`` calls, leaf by leaf within 1e-5 absolute and
1e-4 relative (the two packages sum in different orders).  The port's
step leaves its inputs unchanged, and the last position of
``forward_logits`` is the port's own dense ``prefill`` logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as jdec
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
TREE_TOL = dict(atol=1e-5, rtol=1e-4)

SMALL = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_len=64)
# __graft_entry__.py's training configuration, at its B 4, T 16
GRAFT = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_len=64)
CASES = {"gelu": (dict(SMALL, act="gelu"), 3, 24),
         "gelu_tanh": (dict(SMALL, act="gelu_tanh"), 3, 24),
         "relu": (dict(SMALL, act="relu"), 3, 24),
         "graft": (GRAFT, 4, 16)}


def _case(name, seed=0):
    """(cfg_j, cfg_t, params_j, params_t, ids, mask) of one case; the mask
    has zeros in every row."""
    widths, B, T = CASES[name]
    cfg_j, cfg_t = jdec.DecoderConfig(**widths), tdec.DecoderConfig(**widths)
    tree = jax.tree_util.tree_map(
        np.asarray, jdec.init_decoder_params(cfg_j, jax.random.PRNGKey(seed)))
    pt = decoder_params_from_numpy(tree, cfg_t, device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, widths["vocab_size"], (B, T)).astype(np.int32)
    mask = rng.random((B, T)) < 0.7
    mask[:, -2:] = False
    return cfg_j, cfg_t, tree, pt, ids, mask


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_close(got: dict, want, cfg_t, tol=TREE_TOL):
    """``got`` (port tensors) leaf by leaf against ``want`` (a JAX tree of
    the same layout, carried across by the params' converter)."""
    want_t = decoder_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), cfg_t, device="cpu")
    n = []

    def check(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
        n.append(1)

    tdec._tree_map(check, got, want_t)
    assert len(n) == len(jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_logits_matches_jax(name):
    cfg_j, cfg_t, tree, pt, ids, _mask = _case(name)
    want = np.asarray(jdec.forward_logits(_jax_tree(tree), cfg_j,
                                          jnp.asarray(ids)))
    got = tdec.forward_logits(pt, cfg_t, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ids.shape + (cfg_t.vocab_size,)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("masked", ["some_zeros", "all_zero"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lm_loss_matches_jax(name, masked):
    cfg_j, cfg_t, tree, pt, ids, mask = _case(name, seed=1)
    if masked == "all_zero":
        mask = np.zeros_like(mask)  # the max(sum, 1) guard: loss 0
    want = float(jdec.lm_loss(_jax_tree(tree), cfg_j, jnp.asarray(ids),
                              jnp.asarray(mask)))
    got = tdec.lm_loss(pt, cfg_t, torch.from_numpy(ids),
                       torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.ndim == 0
    if masked == "all_zero":
        assert want == 0.0 and float(got) == 0.0
    else:
        assert want > 0
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax_value_and_grad(name):
    """The first step from zero momentum returns the gradients as its
    momentum (0.9 * 0 + g), and the loss before the update."""
    cfg_j, cfg_t, tree, pt, ids, mask = _case(name, seed=2)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jdec.lm_loss(p, cfg_j, jnp.asarray(ids), jnp.asarray(mask))
    )(_jax_tree(tree))
    step = tdec.make_train_step(cfg_t, device="cpu")
    _new, grads_t, loss_t = step(pt, tdec.init_opt_state(pt),
                                 torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    # the tied head: the embedding's gradient comes from the lookup and
    # from the head, checked first for a clearer failure
    np.testing.assert_allclose(grads_t["embed"].numpy(),
                               np.asarray(grads_j["embed"]), **TREE_TOL)
    _assert_tree_close(grads_t, grads_j, cfg_t)


@pytest.mark.parametrize("name", ["gelu_tanh", "graft"])
def test_three_train_steps_match_jax(name):
    cfg_j, cfg_t, tree, pt, ids, mask = _case(name, seed=3)
    rng = np.random.default_rng(3)
    batches = [(ids, mask)] + [
        (rng.integers(4, cfg_t.vocab_size, ids.shape).astype(np.int32),
         rng.random(mask.shape) < 0.8) for _ in range(2)]
    step_j = jdec.make_train_step(cfg_j)
    step_t = tdec.make_train_step(cfg_t, device="cpu")
    pj = _jax_tree(tree)
    mj = jdec.init_opt_state(pj)
    mt = tdec.init_opt_state(pt)
    for b_ids, b_mask in batches:
        pj, mj, loss_j = step_j(pj, mj, jnp.asarray(b_ids),
                                jnp.asarray(b_mask))
        pt, mt, loss_t = step_t(pt, mt, torch.from_numpy(b_ids),
                                torch.from_numpy(b_mask))
        np.testing.assert_allclose(float(loss_t), float(loss_j),
                                   rtol=LOSS_RTOL)
    _assert_tree_close(pt, pj, cfg_t)
    _assert_tree_close(mt, mj, cfg_t)


def test_train_step_leaves_its_inputs_unchanged():
    _cfg_j, cfg_t, _tree, pt, ids, mask = _case("gelu_tanh", seed=4)
    step = tdec.make_train_step(cfg_t, learning_rate=0.1, device="cpu")
    mom = tdec._tree_map(lambda t: torch.full_like(t, 0.01), pt)
    before = [t.clone()
              for t in tdec._tree_leaves(pt) + tdec._tree_leaves(mom)]
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    new_p, new_m, _loss = step(pt, mom, ids_t, mask_t)
    after = tdec._tree_leaves(pt) + tdec._tree_leaves(mom)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert np.array_equal(ids_t.numpy(), ids)
    assert np.array_equal(mask_t.numpy(), mask)
    assert not any(t.requires_grad for t in after)
    moved = [not torch.equal(a, b) for a, b in zip(
        tdec._tree_leaves(new_p), tdec._tree_leaves(pt))]
    assert all(moved)  # every leaf has gradient or momentum
    assert not any(t.requires_grad for t in
                   tdec._tree_leaves(new_p) + tdec._tree_leaves(new_m))


def test_train_step_refuses_params_on_another_device():
    _cfg_j, cfg_t, _tree, pt, ids, mask = _case("relu")
    step = tdec.make_train_step(cfg_t, device="meta")
    with pytest.raises(ValueError, match="params on"):
        step(pt, tdec.init_opt_state(pt), torch.from_numpy(ids),
             torch.from_numpy(mask))


@pytest.mark.parametrize("n", [5, 24])
def test_last_forward_position_is_the_dense_prefill(n):
    """The port against itself: the last of ``forward_logits``' positions
    over a prompt equals the dense einsum ``prefill``'s logits at
    ``n_valid - 1`` over the padded prompt."""
    _cfg_j, cfg_t, _tree, pt, ids, _mask = _case("gelu_tanh", seed=5)
    prompt = torch.from_numpy(ids[:1, :n])
    padded = torch.zeros((1, 32), dtype=torch.int64)
    padded[0, :n] = prompt[0]
    want, _cache = tdec.prefill(pt, cfg_t, padded, torch.tensor([n]),
                                flash=False)
    got = tdec.forward_logits(pt, cfg_t, prompt)[:, -1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
