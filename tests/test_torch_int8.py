"""pathway_tpu_torch int8-resident decode plan against the JAX package.

The same numpy weights (made from a seed) run through both packages at
the JAX int8 tests' widths (``tests/test_fused_int8_decode.py``):

- ``quantize_weight_int8``: ``q`` and ``s`` bit-identical to JAX's,
  all-zero columns and quotients at exactly .5 (half to even) included;
- ``plan_decode_params(quantize="int8", native=...)``: leaf by leaf equal
  to JAX's (int8 ``{w}_q`` / f32 ``{w}_s`` when native, the dequantized
  f32 weights when not), and ``params_to`` keeps the int8 leaves int8;
- ``paged_decode_step`` / ``paged_mixed_step`` logits over either plan
  within 1e-5 (f32) of JAX's;
- ``PagedDecodeEngine(quantize="int8")``: greedy and fixed-seed sampled
  tokens equal the JAX engine's (mixed lengths, a shared prefix,
  preemption), and int8 tokens are deterministic across engine rebuilds
  and a fault-injected restart;
- the int8 draft model, ``TorchDecoderLM.paged_engine(quantize=)`` and
  the ``ValueError`` on an unknown ``quantize``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu import faults as jfaults
from pathway_tpu.kvcache import PagedDecodeEngine as JaxEngine
from pathway_tpu.models import decoder as jdec
from pathway_tpu_torch import faults
from pathway_tpu_torch.kvcache import (DraftModelDrafter, PagedDecodeEngine,
                                       SpecController)
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.models.encoder import params_to

TOL = dict(atol=1e-5, rtol=1e-5)  # f32 logits: summation order only
WIDTHS = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
EKW = dict(num_blocks=96, block_size=4, max_batch_size=8,
           seq_buckets=(16, 32, 64), prefill_chunk=8, chain_steps=8)
H, HD, BS, NBLK, NBT = 8, 8, 4, 40, 8


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
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _prompts(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, WIDTHS["vocab_size"], size=n)]
            for n in lengths]


def _engines(weights, name, **kw):
    """(JAX engine, port engine) over the same weights and sizes."""
    pj, pt = weights
    kw = dict(EKW, **kw)
    return (JaxEngine(CFG_J, pj, name=name, **kw),
            PagedDecodeEngine(CFG_T, pt, device="cpu", **kw))


# -- quantize_weight_int8 -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_int8_bit_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((48, 24)) * (seed + 0.5)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: s = 1, q = 0
    w[:, 5] = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5] * 8,
                       np.float32)  # s = 1: quotients at exactly .5
    qj, sj = jdec.quantize_weight_int8(jnp.asarray(w))
    qt, st = tdec.quantize_weight_int8(torch.from_numpy(w))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[3] == 1.0 and not qt[:, 3].any()
    # half to even, as jnp.round: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 1.5 -> 2
    assert qt[:6, 5].tolist() == [127, 2, -4, 0, 0, 2]


def test_quantize_weight_int8_contract():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    q, s = tdec.quantize_weight_int8(w)
    assert int(q.to(torch.int32).abs().max()) <= 127
    err = (q.float() * s - w).abs()
    assert bool((err <= s[None, :] * 0.5 + 1e-8).all())


# -- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_int8_plan_matches_jax_leaf_by_leaf(weights, native):
    pj, pt = weights
    plan_j = jdec.plan_decode_params(CFG_J, pj, quantize="int8",
                                     native=native)
    plan_t = tdec.plan_decode_params(CFG_T, pt, quantize="int8",
                                     native=native)

    def same(lt, lj):
        assert set(lt) == set(lj)
        for k, v in lj.items():
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(v),
                                          err_msg=k)
            assert str(lt[k].dtype).split(".")[1] == str(v.dtype), k

    same({k: v for k, v in plan_t.items() if k != "layers"},
         {k: v for k, v in plan_j.items() if k != "layers"})
    for lt, lj in zip(plan_t["layers"], plan_j["layers"]):
        same(lt, lj)
    if native:
        lyr = plan_t["layers"][0]
        assert lyr["wqkv_q"].dtype == torch.int8
        assert tuple(lyr["wqkv_s"].shape) == (lyr["wqkv_q"].shape[-1],)
        # the lookup table stays f32; only the products' weights are int8
        assert plan_t["embed"].dtype == torch.float32
        assert plan_t["embed_t_q"].dtype == torch.int8


def test_params_to_keeps_int8_leaves_resident(weights):
    plan = tdec.plan_decode_params(CFG_T, weights[1], quantize="int8",
                                   native=True)
    moved = params_to(plan, "cpu", torch.bfloat16)
    lyr = moved["layers"][0]
    for w in ("wqkv", "wo", "w_up", "w_down"):
        assert lyr[f"{w}_q"].dtype == torch.int8
        assert torch.equal(lyr[f"{w}_q"], plan["layers"][0][f"{w}_q"])
        assert lyr[f"{w}_s"].dtype == torch.float32
    assert moved["embed_t_q"].dtype == torch.int8
    assert moved["embed"].dtype == torch.bfloat16
    assert lyr["ln1_scale"].dtype == torch.float32


def test_plan_rejects_unknown_quantize(weights):
    with pytest.raises(ValueError, match="quantize"):
        tdec.plan_decode_params(CFG_T, weights[1], quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        PagedDecodeEngine(CFG_T, weights[1], device="cpu", quantize="fp8",
                          **EKW)
    with pytest.raises(ValueError, match="quantize"):
        DraftModelDrafter(CFG_T, weights[1], quantize="int4")


def test_int8_device_native_follows_the_device():
    assert tdec.int8_device_native(None, "cuda") is True
    assert tdec.int8_device_native(None, "cpu") is False
    assert tdec.int8_device_native(True, "cpu") is True


# -- the step programs over the int8 plan -----------------------------------


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _pools(seed):
    rng = np.random.default_rng(seed)
    shape = (WIDTHS["n_layers"], NBLK, BS, H, HD)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), rng)


def _plans(weights, native):
    pj, pt = weights
    return (jdec.plan_decode_params(CFG_J, pj, quantize="int8",
                                    native=native),
            tdec.plan_decode_params(CFG_T, pt, quantize="int8",
                                    native=native))


@pytest.mark.parametrize("native", [True, False])
def test_int8_paged_decode_step_matches_jax(weights, native):
    pj, pt = _plans(weights, native)
    kp, vp, rng = _pools(2)
    B = 3
    bt = (rng.permutation(NBLK - 1)[: B * NBT] + 1).reshape(B, NBT)
    positions = np.array([13, 27, 0])
    sb = bt[np.arange(B), positions // BS]
    so = positions % BS
    token = rng.integers(1, WIDTHS["vocab_size"], size=B)
    args = [x.astype(np.int32) for x in (token, positions, bt, sb, so)]
    lj, kj, _ = jdec.paged_decode_step(pj, CFG_J, *_j(kp, vp, *args),
                                       attn="reference")
    kt, vt = _t(kp, vp)
    lt, _, _ = tdec.paged_decode_step(pt, CFG_T, kt, vt, *_t(*args))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)


@pytest.mark.parametrize("native", [True, False])
def test_int8_paged_mixed_step_matches_jax(weights, native):
    pj, pt = _plans(weights, native)
    kp, vp, rng = _pools(3)
    B, C = 4, 8
    T = B + C
    blocks = (rng.permutation(NBLK - 1)[: 3 * NBT] + 1).reshape(3, NBT)
    row_tables = np.zeros((B, NBT), np.int32)
    tokens, positions, sb, so, tok_row, tok_col = (
        np.zeros(T, np.int32) for _ in range(6))
    row_start = np.zeros(B, np.int32)
    row_nvalid = np.ones(B, np.int32)
    row_token_idx = np.zeros((B, C), np.int32)
    logit_idx = np.zeros(B, np.int32)
    t = 0
    # two decode rows, a 6-token chunk row, an idle row (null block)
    for row, (start, nv) in enumerate(((20, 1), (3, 1), (11, 6))):
        row_tables[row] = blocks[row]
        pos = np.arange(start, start + nv)
        tokens[t:t + nv] = rng.integers(1, WIDTHS["vocab_size"], size=nv)
        positions[t:t + nv] = pos
        sb[t:t + nv] = blocks[row][pos // BS]
        so[t:t + nv] = pos % BS
        row_start[row], row_nvalid[row] = start, nv
        row_token_idx[row, :nv] = np.arange(t, t + nv)
        row_token_idx[row, nv:] = t + nv - 1
        tok_row[t:t + nv] = row
        tok_col[t:t + nv] = np.arange(nv)
        logit_idx[row] = t + nv - 1
        t += nv
    args = (tokens, positions, row_tables, row_start, row_nvalid,
            row_token_idx, tok_row, tok_col, sb, so, logit_idx)
    lj, _, _ = jdec.paged_mixed_step(pj, CFG_J, *_j(kp, vp, *args),
                                     attn="reference")
    kt, vt = _t(kp, vp)
    lt, _, _ = tdec.paged_mixed_step(
        pt, CFG_T, kt, vt, *_t(*[a.astype(np.int64) for a in args]))
    np.testing.assert_allclose(lt.numpy()[:3], np.asarray(lj)[:3], **TOL)


def test_int8_native_dense_path_equals_paged_steps(weights):
    """Within the port, over ONE native int8 plan: the dense plain path
    (einsum prefill + decode_step) and the paged decode step give the
    same logits for the same context."""
    plan = tdec.plan_decode_params(CFG_T, weights[1], quantize="int8",
                                   native=True)
    prompt = _prompts((11,), seed=5)[0]
    n = len(prompt)
    buf = torch.zeros((1, 16), dtype=torch.long)
    buf[0, :n] = torch.tensor(prompt)
    logits, cache = tdec.prefill(plan, CFG_T, buf, torch.tensor([n]),
                                 flash=False)
    nxt = int(tdec.greedy(logits)[0])
    want, _ = tdec.decode_step(plan, CFG_T, cache, torch.tensor([nxt]), n)
    # the same context through the pool: prefill's K/V scattered, then one
    # paged decode step at position n
    kp = torch.zeros((WIDTHS["n_layers"], 8, BS, H, HD))
    vp = torch.zeros_like(kp)
    bt = torch.arange(1, 5, dtype=torch.int32)[None]
    tdec.paged_prefill(plan, CFG_T, buf, torch.tensor([n]), kp, vp, bt,
                       flash=False)
    got, _, _ = tdec.paged_decode_step(
        plan, CFG_T, kp, vp, torch.tensor([nxt]), torch.tensor([n]), bt,
        bt[:, n // BS], torch.tensor([n % BS]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# -- the engine -------------------------------------------------------------


@pytest.mark.parametrize("chain_steps", [1, 8])
def test_int8_engine_greedy_matches_jax(weights, chain_steps):
    prompts = _prompts((3, 5, 9, 16, 27))
    prompts.append(list(prompts[3][:5]) + [7, 9, 2])  # a shared prefix
    reqs = [(list(p), 9) for p in prompts]
    je, te = _engines(weights, f"t_i8_greedy_{chain_steps}",
                      quantize="int8", chain_steps=chain_steps)
    want = je.generate_batch(reqs)
    assert te.generate_batch(reqs) == want
    assert te.quantize == "int8" and te._prog_suffix == "_i8"
    assert te.base_params is weights[1]
    te.pool.check_invariants(te.prefix.external_refs())


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_sampled_fixed_seed_identity(weights, quant):
    prompts = _prompts((4, 7, 12), seed=13)
    opts = {"sampling": (0.8, 8, 0.95, 42)}
    reqs = [(list(p), 8, dict(opts)) for p in prompts]
    je, te = _engines(weights, f"t_i8_samp_{quant}", quantize=quant)
    runs = [te.generate_batch(reqs)]
    runs.append(PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                                  quantize=quant, **EKW).generate_batch(reqs))
    assert runs[0] == runs[1], f"sampled quantize={quant} nondeterministic"
    assert all(len(toks) == 8 for toks in runs[0])
    assert runs[0] == je.generate_batch(reqs)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_preemption_recompute_identity(weights, quant):
    prompts = _prompts((3, 5, 8, 11), seed=5)
    reqs = [(list(p), 12) for p in prompts]
    calm = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                             quantize=quant, **EKW)
    want = calm.generate_batch(reqs)
    tight = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                              quantize=quant, **dict(EKW, num_blocks=14))
    assert tight.generate_batch(reqs) == want
    assert tight.pool.n_preemptions > 0, "no preemption was forced"
    je = JaxEngine(CFG_J, weights[0], name=f"t_i8_pre_{quant}",
                   quantize=quant, **EKW)
    assert je.generate_batch(reqs) == want


def test_int8_deterministic_across_restart(weights):
    """Two engine builds from the same checkpoint re-quantize to the
    same plan: equal tokens."""
    reqs = [(list(p), 10) for p in _prompts((3, 7, 13, 20), seed=19)]
    a = PagedDecodeEngine(CFG_T, weights[1], device="cpu", quantize="int8",
                          **EKW)
    b = PagedDecodeEngine(CFG_T, weights[1], device="cpu", quantize="int8",
                          **EKW)
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)
    assert a.generate_batch(reqs) == b.generate_batch(reqs)


@pytest.mark.parametrize("sampled", [False, True])
def test_int8_deterministic_across_failover(weights, sampled):
    """A fault-injected engine restart mid-batch (the dispatch raises,
    the supervisor rebuilds the pool and recomputes) emits the clean
    run's int8 tokens."""
    opts = {"sampling": (0.7, 6, 0.9, 3)} if sampled else {}
    reqs = [(list(p), 6 + (i % 5), dict(opts))
            for i, p in enumerate(_prompts((3, 5, 9, 14, 21), seed=23))]
    kw = dict(EKW, chain_steps=4)
    clean = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                              quantize="int8", **kw).generate_batch(reqs)
    eng = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                            quantize="int8", max_restarts=1, **kw)
    old_pool = eng.pool
    faults.install("engine.dispatch.chain", "raise", nth=2)
    got = eng.generate_batch(reqs)
    assert got == clean, "failover changed int8 tokens"
    assert eng.n_restarts == 1 and eng.pool is not old_pool
    eng.pool.check_invariants(eng.prefix.external_refs())


def test_int8_draft_model_keeps_greedy_tokens(weights):
    """An int8 draft model proposes; the verify round keeps the
    non-speculative tokens of the (f32) target."""
    reqs = [(list(p), 10) for p in _prompts((6, 9, 14), seed=29)]
    want = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                             **EKW).generate_batch(reqs)
    drafter = DraftModelDrafter(CFG_T, weights[1], k=3, quantize="int8")
    eng = PagedDecodeEngine(CFG_T, weights[1], device="cpu",
                            speculative=SpecController(drafter), **EKW)
    assert drafter.params["layers"][0]["wqkv"].dtype == torch.float32
    assert "wqkv_q" not in drafter.params["layers"][0]  # dequant on CPU
    assert eng.generate_batch(reqs) == want
    assert eng.rounds["verify"] > 0


def test_decoder_lm_paged_engine_quantize_matches_jax(weights):
    pj, pt = weights
    prompts = ["the quick brown fox", "over the lazy dog " * 3, "a"]
    want = jdec.JaxDecoderLM(CFG_J, params=pj).paged_engine(
        quantize="int8", num_blocks=64, block_size=4, max_batch_size=4,
        seq_buckets=(16, 32, 64))
    lm = tdec.TorchDecoderLM(CFG_T, params=pt, device="cpu")
    eng = lm.paged_engine(quantize="int8", num_blocks=64, block_size=4,
                          max_batch_size=4, seq_buckets=(16, 32, 64))
    assert eng.quantize == "int8"
    reqs = [(ids, 6) for ids in lm.encode_prompts(prompts, 6)]
    assert eng.generate_batch(reqs) == want.generate_batch(reqs)
