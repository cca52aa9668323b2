"""pathway_tpu_torch.obs.memory — the HBM ledger and the auto-config
against the JAX package's, byte for byte.

The tiny configuration (vocab 64, d 64, 2 layers, 8 heads, d_ff 128,
max_len 128; 96 blocks of 4, batch 4, chain 8, chunk 8), with the JAX
package's weights carried across by ``models/convert.py``:

- ``hbm_plan(...).as_dict()`` equals the reference's for f32 and bf16
  plans, the analytic weights term, the int8 plan (each tensor at its own
  width), and the state engine's constant-memory term;
- ``fits_with``, ``max_fitting_num_blocks``, ``largest_fitting`` and
  ``reject_message`` agree under explicit budgets, and so does
  ``choose_engine_config`` (its ints, ``chosen``, ``source`` and ledger);
- the engines agree: the same ``hbm_budget_bytes`` gives the same
  ``auto_config``, the same rejection and the same clamped pool, and the
  KV term equals the port pool's own bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu.kvcache.statecache import StateDecodeEngine as JaxState
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu.obs import memory as jmem
from pathway_tpu_torch.kvcache.block_pool import BlockPool
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
from pathway_tpu_torch.kvcache.statecache import StateDecodeEngine
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.obs import memory as tmem

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
SIZES = dict(num_blocks=96, block_size=4, max_batch_size=4, chain_steps=8,
             prefill_chunk=8)



@pytest.fixture(autouse=True)
def _jax_registry_as_found():
    """The JAX package's own profiler tests read its process-wide program
    registry: the records this test's JAX engines add are removed after
    it."""
    reg = jprof.registry()
    keys = set(reg._records)
    yield
    with reg._lock:
        for k in set(reg._records) - keys:
            del reg._records[k]


@pytest.fixture(scope="module")
def weights():
    pj = jdec.init_decoder_params(CFG_J, jax.random.PRNGKey(0))
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   CFG_T, device="cpu")
    return pj, pt


@pytest.fixture(scope="module")
def plans(weights):
    pj, pt = weights
    return (jdec.plan_decode_params(CFG_J, pj),
            tdec.plan_decode_params(CFG_T, pt))


def _both(plans_or_none, dtypes, **kw):
    pj, pt = plans_or_none if plans_or_none else (None, None)
    dj, dt = dtypes
    j = jmem.hbm_plan(CFG_J, params=pj, dtype=dj, **kw)
    t = tmem.hbm_plan(CFG_T, params=pt, dtype=dt, device="cpu", **kw)
    return j, t


def test_f32_plan_ledger_equals_the_reference(plans):
    j, t = _both(plans, (None, None), **SIZES)
    assert t.as_dict() == j.as_dict()
    assert t.temp_source == "analytic"
    # the reference's numbers for this configuration, named
    assert (t.params_bytes, t.kv_bytes, t.temp_bytes) == (330240, 393216,
                                                          431360)


@pytest.mark.parametrize("reference_attn", [True, False])
def test_bf16_plan_ledger_equals_the_reference(plans, reference_attn):
    pj, pt = plans
    pj16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), pj)
    pt16 = _cast(pt, torch.bfloat16)
    j, t = _both((pj16, pt16), (jnp.bfloat16, torch.bfloat16),
                 reference_attn=reference_attn, **SIZES)
    assert t.as_dict() == j.as_dict()
    assert t.params_bytes == 330240 // 2


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


@pytest.mark.parametrize("dtypes", [(None, None),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_analytic_weights_term_equals_the_reference(dtypes):
    j, t = _both(None, dtypes, **SIZES)
    assert t.as_dict() == j.as_dict()


def test_int8_plan_billed_at_its_byte_width(weights, plans):
    """The counterpart of test_fused_int8_decode.py::
    test_hbm_plan_bills_int8_at_true_byte_width: each plan tensor at its
    own width, equal to the reference's int8 plan byte for byte."""
    pj, pt = weights
    i8j = jdec.plan_decode_params(CFG_J, pj, quantize="int8", native=True)
    i8t = tdec.plan_decode_params(CFG_T, pt, quantize="int8", native=True)
    assert i8t["layers"][0]["wqkv_q"].dtype == torch.int8
    j, t = _both((i8j, i8t), (None, None), **SIZES)
    assert t.as_dict() == j.as_dict()
    f32 = _both(plans, (None, None), **SIZES)[1].params_bytes
    assert 0 < t.params_bytes < 0.6 * f32
    assert t.params_bytes == sum(x.numel() * x.element_size()
                                 for x in tmem.tensors(i8t))


def test_state_term_equals_the_reference(plans):
    per_seq = CFG_T.n_layers * CFG_T.n_heads * 8 * 8 * 4
    j, t = _both(plans, (None, None), reference_attn=False,
                 state_bytes_per_seq=per_seq, **SIZES)
    assert t.as_dict() == j.as_dict()
    assert t.kv_bytes == SIZES["num_blocks"] * per_seq


@pytest.mark.parametrize("budget_delta", [1024, -1, -200_000, -700_000,
                                          -1_100_000])
def test_what_ifs_under_explicit_budgets(plans, budget_delta):
    base = _both(plans, (None, None), **SIZES)[1].total_bytes
    budget = base + budget_delta
    j, t = _both(plans, (None, None), budget_bytes=budget, **SIZES)
    assert t.as_dict() == j.as_dict()
    for kw in (dict(num_blocks=192), dict(num_blocks=48),
               dict(chain_steps=16), dict(max_batch_size=8),
               dict(num_blocks=8, max_batch_size=1, chain_steps=1)):
        assert t.fits_with(**kw) == j.fits_with(**kw), kw
    assert t.max_fitting_num_blocks() == j.max_fitting_num_blocks()
    assert t.largest_fitting() == j.largest_fitting()
    if not t.fits:
        assert t.reject_message() == j.reject_message()


@pytest.mark.parametrize("budget", [None, 64 << 20, 2 << 20, 1_400_000,
                                    1_000_000])
@pytest.mark.parametrize("given", [{}, dict(max_batch_size=2),
                                   dict(num_blocks=40, chain_steps=4)])
def test_choose_engine_config_equals_the_reference(plans, budget, given):
    pj, pt = plans

    def run(mod, cfg, params, **kw):
        try:
            return mod.choose_engine_config(cfg, params=params,
                                            budget_bytes=budget, **given,
                                            **kw)
        except (ValueError, AssertionError) as exc:
            # an unfittable budget, or explicit sizes the auto-chosen
            # rest cannot fit beside: the same error, word for word
            return type(exc).__name__, str(exc)

    j = run(jmem, CFG_J, pj)
    t = run(tmem, CFG_T, pt, device="cpu")
    if isinstance(j, tuple):
        assert t == j
        return
    for k in ("num_blocks", "block_size", "max_batch_size", "chain_steps",
              "chosen", "source"):
        assert t[k] == j[k], k
    assert t["plan"].as_dict() == j["plan"].as_dict()
    if budget is None:
        assert t["source"] == "defaults (no HBM budget resolved)"


def test_no_budget_on_the_cpu_and_env_budget(monkeypatch):
    assert tmem.resolve_budget(device="cpu") == (None, "none")
    assert tmem.resolve_budget(12345, device="cpu") == (12345, "explicit")
    monkeypatch.setenv("PW_HBM_BUDGET_BYTES", "2e6")
    assert tmem.resolve_budget(device="cpu") == (2000000,
                                                 "env:PW_HBM_BUDGET_BYTES")
    monkeypatch.setenv("PW_HBM_BUDGET_BYTES", "two megabytes")
    with pytest.raises(ValueError):
        tmem.resolve_budget(device="cpu")


# -- the engines --------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 8 << 20, 1_500_000])
def test_engine_auto_config_equals_the_reference(weights, budget):
    pj, pt = weights
    j = JaxEngine(CFG_J, pj, attn="reference", name="t_obs_auto_j",
                  hbm_budget_bytes=budget)
    t = PagedDecodeEngine(CFG_T, pt, device="cpu", name="t_obs_auto_t",
                          hbm_budget_bytes=budget)
    assert t.auto_config == j.auto_config
    assert t.hbm_plan.as_dict() == j.hbm_plan.as_dict()
    assert t.reference_attn
    assert t.pool.num_blocks == j.pool.num_blocks
    if budget is None:  # no budget on the CPU: the documented defaults
        assert t.auto_config["num_blocks"] == 256
        assert t.auto_config["source"] == "defaults (no HBM budget resolved)"


def test_engine_rejection_and_clamp_equal_the_reference(weights):
    pj, pt = weights
    kw = dict(num_blocks=4096, block_size=16, max_batch_size=4,
              chain_steps=4, hbm_budget_bytes=4 << 20)
    with pytest.raises(ValueError) as ej:
        JaxEngine(CFG_J, pj, attn="reference", name="t_obs_rej_j", **kw)
    with pytest.raises(ValueError) as et:
        PagedDecodeEngine(CFG_T, pt, device="cpu", name="t_obs_rej_t", **kw)
    assert str(et.value) == str(ej.value)
    assert "largest fitting alternative: num_blocks=" in str(et.value)
    j = JaxEngine(CFG_J, pj, attn="reference", name="t_obs_clamp_j",
                  hbm_fit="clamp", **kw)
    t = PagedDecodeEngine(CFG_T, pt, device="cpu", name="t_obs_clamp_t",
                          hbm_fit="clamp", **kw)
    assert t.pool.num_blocks == j.pool.num_blocks < 4096
    assert t.hbm_plan.as_dict() == j.hbm_plan.as_dict()
    assert t.hbm_plan.fits
    reqs = [([1, 2, 3], 5), ([9, 8, 7, 6], 5)]
    assert t.generate_batch(reqs) == j.generate_batch(reqs)
    with pytest.raises(ValueError, match="hbm_fit"):
        PagedDecodeEngine(CFG_T, pt, device="cpu", num_blocks=16,
                          block_size=4, hbm_fit="Clamp")
    off = PagedDecodeEngine(CFG_T, pt, device="cpu", hbm_fit="off", **kw)
    assert off.pool.num_blocks == 4096 and not off.hbm_plan.fits


def test_kv_term_matches_the_port_pool(weights):
    """The counterpart of test_profiler.py::
    test_hbm_plan_kv_term_matches_block_pool."""
    _pj, pt = weights
    plan = tmem.hbm_plan(CFG_T, num_blocks=64, block_size=8,
                         max_batch_size=4, chain_steps=8, params=pt,
                         device="cpu")
    pool = BlockPool(num_blocks=64, block_size=8, n_layers=CFG_T.n_layers,
                     n_heads=CFG_T.n_heads,
                     head_dim=CFG_T.d_model // CFG_T.n_heads, device="cpu",
                     name="t_obs_pool")
    assert plan.kv_bytes == pool.per_shard_bytes
    assert plan.params_bytes == sum(x.numel() * x.element_size()
                                    for x in tmem.tensors(pt))
    assert plan.fits and plan.budget_bytes is None


@pytest.mark.parametrize("budget", [None, 6 << 20])
def test_state_engine_ledger_equals_the_reference(weights, budget):
    pj, pt = weights
    kw = dict(max_slots=24, max_batch_size=4, prefill_chunk=8,
              chain_steps=4, hbm_budget_bytes=budget)
    j = JaxState(CFG_J, pj, name="t_obs_state_j", **kw)
    t = StateDecodeEngine(CFG_T, pt, device="cpu", name="t_obs_state_t",
                          **kw)
    assert t.hbm_plan.as_dict() == j.hbm_plan.as_dict()
    assert t.hbm_plan.kv_bytes == t.pool.per_shard_bytes
    with pytest.raises(ValueError) as ej:
        JaxState(CFG_J, pj, name="t_obs_state_rj", max_slots=4096,
                 hbm_budget_bytes=2 << 20)
    with pytest.raises(ValueError) as et:
        StateDecodeEngine(CFG_T, pt, device="cpu", max_slots=4096,
                          hbm_budget_bytes=2 << 20)
    assert str(et.value) == str(ej.value)
    clamped = StateDecodeEngine(CFG_T, pt, device="cpu", max_slots=4096,
                                hbm_budget_bytes=2 << 20, hbm_fit="clamp")
    jc = JaxState(CFG_J, pj, name="t_obs_state_cj", max_slots=4096,
                  hbm_budget_bytes=2 << 20, hbm_fit="clamp")
    assert clamped.pool.max_slots == jc.pool.max_slots < 4096
