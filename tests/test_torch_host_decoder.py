"""pathway_tpu_torch ``Int8DecoderHost`` (the int8 host tier, on the CPU
by design) against the JAX package's.

Both host tiers are torch code (fbgemm dynamic int8 Linears); given the
same weights, made from a seed with numpy at the JAX int8 tests' widths,
their prefill and decode logits must agree within 1e-6 and their greedy
ids exactly.  Beside that: the cache reset and the capacity guard; the
serving executor through the paged engine (f32 and int8 plans), through
the state engine, and through the serialized host tier; the engines'
degrade target (the serial tier, by default only for engines on the
CPU, each degrade logged) and their raising construction (no quiet
None); ``TorchDecoderLM.generate(fused="int8")`` against the JAX LM's
int8 tier, and its refusal on the card.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache import PagedDecodeEngine as JaxEngine
from pathway_tpu.kvcache import StateDecodeEngine as JaxState
from pathway_tpu.models import decoder as jdec
from pathway_tpu.models.host_decoder import Int8DecoderHost as JaxHost
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache import PagedDecodeEngine, StateDecodeEngine
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.models.host_decoder import Int8DecoderHost

WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
EKW = dict(num_blocks=96, block_size=4, max_batch_size=4,
           seq_buckets=(16, 32, 64), prefill_chunk=8, chain_steps=4)
SKW = dict(max_slots=24, max_batch_size=4, prefill_chunk=8, chain_steps=4)
LOGITS_TOL = dict(atol=1e-6, rtol=1e-6)


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f = WIDTHS["d_model"], WIDTHS["d_ff"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def vec(center):
        return (center + 0.1 * rng.standard_normal(d)).astype(np.float32)

    p = {"embed": dense((WIDTHS["vocab_size"], d), 0.5),
         "pos_embed": dense((WIDTHS["max_len"], d), 0.1),
         "ln_f_scale": vec(1.0), "ln_f_bias": vec(0.0), "layers": []}
    for _ in range(WIDTHS["n_layers"]):
        layer = {w: dense(s) for w, s in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w_up", (d, f)), ("w_down", (f, d)))}
        layer.update(ln1_scale=vec(1.0), ln1_bias=vec(0.0),
                     ln2_scale=vec(1.0), ln2_bias=vec(0.0))
        p["layers"].append(layer)
    return p


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


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, WIDTHS["vocab_size"], size=n)]


# -- the serial tier against the JAX host ------------------------------------


@pytest.mark.parametrize("n", [1, 9, 24])
def test_prefill_and_decode_logits_match_jax_host(weights, n):
    hj = JaxHost(CFG_J, weights[0])
    ht = Int8DecoderHost(CFG_T, weights[1])
    ids = _ids(n, n)
    lj, lt = hj.prefill(ids), ht.prefill(ids)
    np.testing.assert_allclose(lt, lj, **LOGITS_TOL)
    tok = int(np.argmax(lt))
    for _ in range(4):
        lj, lt = hj.decode_step(tok), ht.decode_step(tok)
        np.testing.assert_allclose(lt, lj, **LOGITS_TOL)
        assert int(np.argmax(lt)) == int(np.argmax(lj))
        tok = int(np.argmax(lt))
    assert ht.n_past == hj.n_past == n + 4


def test_generate_matches_jax_host(weights):
    hj = JaxHost(CFG_J, weights[0])
    ht = Int8DecoderHost(CFG_T, weights[1])
    for seed in range(3):
        ids = _ids(5 + 4 * seed, 40 + seed)
        assert ht.generate(ids, 7) == hj.generate(ids, 7)


def test_cache_reset_between_generations(weights):
    host = Int8DecoderHost(CFG_T, weights[1])
    ids = _ids(10, 1)
    a = host.generate(ids, 5)
    host.generate(_ids(30, 2), 5)  # a longer run leaves deeper rows
    assert host.generate(ids, 5) == a  # no stale cache rows are read


def test_capacity_guard(weights):
    host = Int8DecoderHost(CFG_T, weights[1], cache_capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        host.prefill(np.arange(4, 20))
    host.prefill(np.arange(4, 12))
    with pytest.raises(ValueError, match="KV cache full"):
        host.decode_step(3)
    assert Int8DecoderHost(CFG_T, weights[1], cache_capacity=4096).cap == \
        WIDTHS["max_len"]


def test_host_tier_runs_on_the_cpu_from_any_device_params(weights):
    """The serial tier copies its weights to the host as f32, whatever
    device and dtype the parameters came in."""
    bf16 = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
            for k, v in weights[1].items()}
    host = Int8DecoderHost(CFG_T, bf16)
    assert host._emb.dtype == torch.float32 and host._emb.device.type == "cpu"
    assert len(host.generate(_ids(6, 3), 4)) == 4


# -- engines and the serving executor ----------------------------------------


def test_serving_executor_paged_tokens(weights):
    reqs = [(_ids(n, n), 6) for n in (3, 9, 14)]
    want = JaxEngine(CFG_J, weights[0], name="t_host_paged_ref",
                     **EKW).generate_batch(reqs)
    host = Int8DecoderHost(CFG_T, weights[1])
    sched = host.serving_executor(device="cpu", max_batch_size=4)
    try:
        assert isinstance(host.paged_engine(), PagedDecodeEngine)
        got = [host.generate_scheduled(p, n, priority="high")
               for p, n in reqs]
        assert got == want
        assert host.serving_executor() is sched  # shared
    finally:
        sched.shutdown()


def test_serving_executor_int8_paged_tokens(weights):
    reqs = [(_ids(n, n + 1), 6) for n in (4, 11)]
    want = JaxEngine(CFG_J, weights[0], name="t_host_i8_ref",
                     quantize="int8", **EKW).generate_batch(reqs)
    host = Int8DecoderHost(CFG_T, weights[1])
    sched = host.serving_executor(device="cpu", quantize="int8",
                                  chain_steps=4)
    try:
        assert host.paged_engine().quantize == "int8"
        assert [sched.submit(r) for r in reqs] == want
    finally:
        sched.shutdown()


def test_serving_executor_state_tokens(weights):
    pj = jdec.ssd_augment_params(weights[0], CFG_J)
    reqs = [(_ids(n, n + 2), 6) for n in (5, 12)]
    want = JaxState(CFG_J, pj, name="t_host_state_ref",
                    **SKW).generate_batch(reqs)
    host = Int8DecoderHost(CFG_T, weights[1])
    sched = host.serving_executor(cache="state", device="cpu",
                                  max_batch_size=4)
    try:
        eng = host.state_engine()
        assert isinstance(eng, StateDecodeEngine)
        got = [sched.submit(r) for r in reqs]
        assert got == want
        clean = StateDecodeEngine(CFG_T, weights[1], device="cpu",
                                  max_batch_size=4)
        assert got == clean.generate_batch(reqs)
    finally:
        sched.shutdown()


def test_serving_executor_serial_tier(weights):
    host = Int8DecoderHost(CFG_T, weights[1])
    sched = host.serving_executor(paged=False)
    try:
        ids = _ids(8, 5)
        assert sched.submit((ids, 5)) == host.generate(ids, 5)
        assert sched.max_batch_size == 1
        assert host._params is None  # the f32 weights were released
        with pytest.raises(RuntimeError, match="released"):
            host.paged_engine(device="cpu")
    finally:
        sched.shutdown()
    with pytest.raises(ValueError, match="cache="):
        host.serving_executor(cache="disk")


def test_engines_degrade_to_the_serial_tier(weights, caplog):
    """Restarts spent, a stranded request of an engine on the CPU
    continues on the host's serial int8 tier over prompt + the tokens
    the engine already emitted, and each such request is logged."""
    caplog.set_level(logging.WARNING, logger="pathway_tpu_torch.kvcache")
    host = Int8DecoderHost(CFG_T, weights[1])
    calls = []
    serial = host.generate

    def recorded(ids, n):
        calls.append((list(ids), n))
        return serial(ids, n)

    host.generate = recorded
    eng = host.paged_engine(device="cpu", max_restarts=0, **EKW)
    reqs = [(_ids(6, 8), 9), (_ids(10, 9), 9)]
    assert eng.degrade_fn == host.degrade
    faults.install("engine.dispatch.chain", "raise", nth=2)
    got = eng.generate_batch(reqs)
    faults.clear()
    assert len(calls) == 2 and eng.n_degraded == 2
    logged = [r for r in caplog.records if "degrade_fn" in r.getMessage()]
    assert len(logged) == 2
    for (prompt, n), toks, (ids, rest) in zip(reqs, got, calls):
        emitted = ids[len(prompt):]
        assert ids[:len(prompt)] == prompt and 0 < len(emitted) < n
        assert rest == n - len(emitted)
        assert toks == emitted + serial(ids, rest)
    calls.clear()
    state = host.state_engine(device="cpu", max_restarts=0, **SKW)
    faults.install("engine.dispatch.mixed", "raise", nth=1)
    got = state.generate_batch([(list(reqs[0][0]), 5)])
    faults.clear()
    assert calls == [(reqs[0][0], 5)]
    assert got == [serial(reqs[0][0], 5)]
    assert state.n_degraded == 1


def test_card_engines_take_no_host_degrade_target(weights):
    """The serial tier runs on the CPU, so only an engine on the CPU
    gets it by default; an engine on the card gets a degrade target
    only when the caller names one (its restarts spent, it raises)."""
    host = Int8DecoderHost(CFG_T, weights[1])
    built = []

    class Recorder:
        def __init__(self, cfg, params, **kwargs):
            built.append(kwargs)

    for i, (kw, want) in enumerate((
            ({"device": "cuda"}, None),
            ({}, None),  # the engines' default device is the card
            ({"device": torch.device("cuda", 0)}, None),
            ({"device": "cpu"}, host.degrade),
            ({"device": "cuda", "degrade_fn": host.degrade}, host.degrade))):
        setattr(host, f"_recorded_{i}", None)  # no engine cached yet
        host._engine(f"_recorded_{i}", Recorder, "rec", dict(kw))
        assert built[-1].get("degrade_fn") == want, kw
        assert built[-1]["name"] == "rec"


def test_engine_construction_raises_instead_of_none(weights):
    host = Int8DecoderHost(CFG_T, weights[1])
    with pytest.raises(ValueError, match="reserved"):
        host.paged_engine(device="cpu", num_blocks=1)
    with pytest.raises(ValueError, match="quantize"):
        host.paged_engine(device="cpu", quantize="int4")
    if not torch.cuda.is_available():  # engines default to the card
        with pytest.raises(RuntimeError, match="cuda"):
            host.state_engine()
        with pytest.raises(RuntimeError, match="cuda"):
            host.serving_executor()


# -- TorchDecoderLM's int8 tier -------------------------------------------------


def test_decoder_lm_int8_tier_matches_jax(weights):
    jlm = jdec.JaxDecoderLM(CFG_J, params=weights[0])
    lm = tdec.TorchDecoderLM(CFG_T, params=weights[1], device="cpu")
    for prompt in ("hello w1 w2 w3", "a b c d e f g h " * 4):
        want = jlm.generate(prompt, max_new_tokens=6, fused="int8")
        assert lm.generate(prompt, max_new_tokens=6, fused="int8") == want
    host = lm._int8_host()
    assert lm._int8_host() is host  # built once
    lm.params = dict(weights[1])
    assert lm._int8_host() is not host  # rebuilt for new params


def test_decoder_lm_int8_tier_refuses_the_card(weights):
    """``fused="int8"`` is the host tier: an LM on the card raises
    rather than move the generation to the CPU, and builds no host
    tier."""
    lm = tdec.TorchDecoderLM(CFG_T, params=weights[1], device="cpu")
    lm.device = torch.device("cuda")  # as an LM built on the card
    with pytest.raises(ValueError, match="host tier"):
        lm.generate("hello w1 w2", max_new_tokens=4, fused="int8")
    assert lm._int8 is None
