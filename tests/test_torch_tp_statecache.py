"""pathway_tpu_torch's SSD state engine under tensor parallelism.

``StateDecodeEngine(tp=8)`` over ``["cpu"] * 8`` logical shards, at the
JAX tests' fixture (vocab 64, d 64, 2 layers, 8 heads, d_ff 128) on the
JAX-grafted SSD weights carried over by ``models/convert.py``: greedy
and fixed-seed sampled tokens equal the port's tp = 1 engine and the
JAX ``StateDecodeEngine(tp=8)``; the state is one [L, S, H/tp, hd, hd]
tensor a shard, and suspend/resume moves every shard's slot.
"""

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache import StateDecodeEngine as JaxState
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu_torch.kvcache import SessionStore
from pathway_tpu_torch.kvcache.statecache import StateDecodeEngine
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
SAMPLING = {"sampling": (0.8, 8, 0.95, 1234)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are tiny, and
    under xdist every worker's default of a thread a core oversubscribes
    the machine's cores many times over (tp = 8 runs took 100-200x
    longer with six workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_registry_as_found():
    reg = jprof.registry()
    keys = set(reg._records)
    yield
    with reg._lock:
        for k in set(reg._records) - keys:
            del reg._records[k]


@pytest.fixture(scope="module")
def weights():
    pj = jdec.ssd_augment_params(
        jdec.init_decoder_params(CFG_J, jax.random.PRNGKey(0)), CFG_J)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, decoder_params_from_numpy(tree, CFG_T, device="cpu")


def _prompts():
    rng = np.random.default_rng(31)
    return [[int(t) for t in rng.integers(0, WIDTHS["vocab_size"], size=n)]
            for n in (3, 5, 11, 17)]


_KW = dict(max_slots=24, max_batch_size=4, prefill_chunk=8, chain_steps=4)


def _port(pt, tp, name, **kw):
    return StateDecodeEngine(CFG_T, pt, tp=tp,
                             devices=["cpu"] * tp if tp > 1 else None,
                             device="cpu", name=name, **{**_KW, **kw})


@pytest.fixture(scope="module")
def jax_tp8(weights):
    pj, _pt = weights
    eng = JaxState(CFG_J, pj, tp=8, name="t_torch_ssd_jtp8", **_KW)
    prompts = _prompts()
    return (eng.generate_batch([(list(p), 8) for p in prompts]),
            eng.generate_batch([(list(prompts[0]), 6, dict(SAMPLING))]))


@pytest.mark.parametrize("tp", [2, 8])
def test_greedy_and_sampled_tokens_equal_tp1_and_the_jax_tp8_engine(
        weights, jax_tp8, tp):
    _pj, pt = weights
    prompts = _prompts()
    e1 = _port(pt, 1, f"t_torch_ssd_tp1_{tp}")
    et = _port(pt, tp, f"t_torch_ssd_tp{tp}")
    greedy = et.generate_batch([(list(p), 8) for p in prompts])
    assert greedy == e1.generate_batch([(list(p), 8) for p in prompts])
    assert greedy == jax_tp8[0]
    sampled = et.generate_batch([(list(prompts[0]), 6, dict(SAMPLING))])
    assert sampled == e1.generate_batch(
        [(list(prompts[0]), 6, dict(SAMPLING))])
    assert sampled == jax_tp8[1]
    assert et.rounds["chain"] > 0 and et.rounds["mixed"] > 0
    et.pool.check_invariants()


def test_the_state_is_sharded_on_the_head_axis(weights):
    _pj, pt = weights
    eng = _port(pt, 8, "t_torch_ssd_shards")
    hd = CFG_T.d_model // CFG_T.n_heads
    assert eng.tp == 8 and len(eng.params) == 8
    assert len(eng.pool.shards) == 8
    for st, dev in zip(eng.pool.shards, eng.mesh.devices):
        assert st.device == dev
        assert tuple(st.shape) == (CFG_T.n_layers, _KW["max_slots"], 1, hd,
                                   hd)
    one = _port(pt, 1, "t_torch_ssd_shards1")
    assert eng.pool.per_shard_bytes * 8 == one.pool.per_shard_bytes
    assert eng.pool.state_bytes_per_seq() == one.pool.state_bytes_per_seq()
    assert eng.pool.kv_stats.snapshot()["shards"] == 8
    # the SSD decay gate shards with the heads
    assert tuple(eng.params[0]["layers"][0]["w_a"].shape) == (CFG_T.d_model,
                                                              1)


def test_a_session_suspends_and_resumes_every_shard(weights):
    _pj, pt = weights
    prompts = _prompts()
    outs = {}
    for tp in (1, 4):
        store = SessionStore()
        eng = _port(pt, tp, f"t_torch_ssd_sess{tp}", session_store=store)
        first = eng.generate_batch(
            [(list(prompts[1]), 4, {"session": "s1"})])[0]
        turn2 = list(prompts[1]) + first + [2, 3]
        second = eng.generate_batch([(turn2, 5, {"session": "s1"})])[0]
        assert store.stats()["resumes"] == 1
        outs[tp] = (first, second)
        fresh = _port(pt, tp, f"t_torch_ssd_fresh{tp}")
        assert second == fresh.generate_batch([(turn2, 5)])[0]
    assert outs[4] == outs[1]
