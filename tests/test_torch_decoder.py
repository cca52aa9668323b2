"""pathway_tpu_torch decoder steps against the JAX package.

``prefill``, ``decode_step``, ``paged_decode_step``, ``paged_mixed_step``
and ``paged_chained_decode`` run on the same numpy weights and inputs in
both packages (the JAX side with ``attn="reference"``), f32: logits and
pools at ``atol=rtol=1e-4`` (different summation order), greedy ids
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as jdec
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
WIDTHS = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)
CFG_J = jdec.DecoderConfig(**WIDTHS)
CFG_T = tdec.DecoderConfig(**WIDTHS)
L, H, HD, BS, NBLK, NBT = 2, 4, 16, 8, 24, 6


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f = WIDTHS["d_model"], WIDTHS["d_ff"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def vec(center):
        return (center + 0.1 * rng.standard_normal(d)).astype(np.float32)

    p = {"embed": dense((WIDTHS["vocab_size"], d), 0.1),
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
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = decoder_params_from_numpy(tree, CFG_T, device="cpu")
    return pj, pt


def _pools(seed):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((L, NBLK, BS, H, HD)).astype(np.float32)
    vp = rng.standard_normal((L, NBLK, BS, H, HD)).astype(np.float32)
    return kp, vp, rng


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_plan_is_the_jax_plan(weights):
    pj, pt = weights
    plan_j = jdec.plan_decode_params(CFG_J, pj)
    plan_t = tdec.plan_decode_params(CFG_T, pt)
    np.testing.assert_array_equal(plan_t["embed_t"].numpy(),
                                  np.asarray(plan_j["embed_t"]))
    for lj, lt in zip(plan_j["layers"], plan_t["layers"]):
        assert set(lj) == set(lt)
        np.testing.assert_array_equal(lt["wqkv"].numpy(),
                                      np.asarray(lj["wqkv"]))


@pytest.mark.parametrize("plan", [False, True])
def test_prefill_and_decode_step_match_jax(weights, plan):
    pj_raw, pt = weights
    pj = jdec.plan_decode_params(CFG_J, pj_raw) if plan else pj_raw
    if plan:
        pt = tdec.plan_decode_params(CFG_T, pt)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, WIDTHS["vocab_size"], size=(2, 16)).astype(np.int32)
    n_valid = np.array([16, 9], np.int32)
    lj, cj = jdec.prefill(pj, CFG_J, *_j(ids, n_valid), flash=False)
    lt, ct = tdec.prefill(pt, CFG_T, *_t(ids.astype(np.int64), n_valid))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b["k"].numpy(), np.asarray(a["k"]), **TOL)
        np.testing.assert_allclose(b["v"].numpy(), np.asarray(a["v"]), **TOL)
    tok = np.array([7, 300], np.int32)
    # the JAX decode_step takes the raw parameters only; the plan is exact
    lj, cj = jdec.decode_step(pj_raw, CFG_J, cj, jnp.asarray(tok), 12)
    lt, ct = tdec.decode_step(pt, CFG_T, ct, torch.from_numpy(tok).long(), 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b["k"].numpy(), np.asarray(a["k"]), **TOL)


def _decode_inputs(rng, B):
    bt = (rng.permutation(NBLK - 1)[: B * NBT] + 1).reshape(B, NBT)
    positions = rng.integers(0, NBT * BS, size=B)
    positions[-1] = 0  # a first token
    sb = bt[np.arange(B), positions // BS]
    so = positions % BS
    token = rng.integers(4, WIDTHS["vocab_size"], size=B)
    return [x.astype(np.int32) for x in (token, positions, bt, sb, so)]


@pytest.mark.parametrize("plan", [False, True])
def test_paged_decode_step_matches_jax(weights, plan):
    pj, pt = weights
    if plan:
        pj = jdec.plan_decode_params(CFG_J, pj)
        pt = tdec.plan_decode_params(CFG_T, pt)
    kp, vp, rng = _pools(2)
    args = _decode_inputs(rng, 3)
    lj, kj, vj = jdec.paged_decode_step(pj, CFG_J, *_j(kp, vp, *args),
                                        attn="reference")
    kt, vt = _t(kp, vp)
    lt, kt2, vt2 = tdec.paged_decode_step(pt, CFG_T, kt, vt, *_t(*args))
    assert kt2 is kt and vt2 is vt  # in place
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)


def test_paged_mixed_step_matches_jax(weights):
    pj, pt = weights
    pj = jdec.plan_decode_params(CFG_J, pj)
    pt = tdec.plan_decode_params(CFG_T, pt)
    kp, vp, rng = _pools(3)
    B, C = 4, 8
    T = B + C
    row_tables = np.zeros((B, NBT), np.int32)
    blocks = (rng.permutation(NBLK - 1)[: 3 * NBT] + 1).reshape(3, NBT)
    tokens = np.zeros(T, np.int32)
    positions = np.zeros(T, np.int32)
    sb = np.zeros(T, np.int32)
    so = np.zeros(T, np.int32)
    row_start = np.zeros(B, np.int32)
    row_nvalid = np.ones(B, np.int32)
    row_token_idx = np.zeros((B, C), np.int32)
    tok_row = np.zeros(T, np.int32)
    tok_col = np.zeros(T, np.int32)
    logit_idx = np.zeros(B, np.int32)
    t = 0
    # rows 0-1 decode one token at positions 20 and 3; row 2 streams a
    # 6-token chunk from position 11; row 3 is idle (null block)
    for row, (start, nv) in enumerate(((20, 1), (3, 1), (11, 6))):
        row_tables[row] = blocks[row]
        pos = np.arange(start, start + nv)
        tokens[t:t + nv] = rng.integers(4, WIDTHS["vocab_size"], size=nv)
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
    lj, kj, vj = jdec.paged_mixed_step(pj, CFG_J, *_j(kp, vp, *args),
                                       attn="reference")
    kt, vt = _t(kp, vp)
    lt, _, _ = tdec.paged_mixed_step(
        pt, CFG_T, kt, vt, *_t(*[a.astype(np.int64) for a in args]))
    np.testing.assert_allclose(lt.numpy()[:3], np.asarray(lj)[:3], **TOL)
    # block 0 is the padding sink (duplicate writes land there)
    np.testing.assert_allclose(kt.numpy()[:, 1:], np.asarray(kj)[:, 1:], **TOL)
    np.testing.assert_allclose(vt.numpy()[:, 1:], np.asarray(vj)[:, 1:], **TOL)


def test_paged_chained_decode_matches_jax(weights):
    pj, pt = weights
    pj = jdec.plan_decode_params(CFG_J, pj)
    pt = tdec.plan_decode_params(CFG_T, pt)
    kp, vp, rng = _pools(4)
    B, K = 3, 4
    token, positions, bt, _sb, _so = _decode_inputs(rng, B)
    positions = np.array([5, 30, 14], np.int32)
    steps = positions[:, None] + np.arange(K)[None, :]
    sb = bt[np.arange(B)[:, None], steps // BS].astype(np.int32)
    so = (steps % BS).astype(np.int32)
    sb[2, 2:] = 0  # a row whose budget ends mid-chain: surplus -> null
    so[2, 2:] = 0
    ids_j, kj, _ = jdec.paged_chained_decode(
        pj, CFG_J, *_j(kp, vp, token, positions, bt, sb, so),
        attn="reference")
    kt, vt = _t(kp, vp)
    ids_t, _, _ = tdec.paged_chained_decode(
        pt, CFG_T, kt, vt, *_t(token, positions, bt, sb, so))
    assert ids_t.dtype == torch.int32 and tuple(ids_t.shape) == (B, K)
    real = np.ones((B, K), bool)
    real[2, 2:] = False  # surplus ids are garbage the engine truncates
    np.testing.assert_array_equal(ids_t.numpy()[real], np.asarray(ids_j)[real])
    np.testing.assert_allclose(kt.numpy()[:, 1:], np.asarray(kj)[:, 1:], **TOL)


def test_greedy_ties_go_to_the_smallest_id():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert tdec.greedy(logits).tolist() == [1, 0]


@pytest.mark.parametrize("plan", [False, True])
def test_prefill_flash_and_einsum_match_jax(weights, plan):
    # flash=True takes the plain flash version on the CPU in both
    # packages (the JAX package's XLA fallback); the plan hands the
    # flash path strided q/k/v views of the fused QKV product
    pj, pt = weights
    if plan:
        pj = jdec.plan_decode_params(CFG_J, pj)
        pt = tdec.plan_decode_params(CFG_T, pt)
    rng = np.random.default_rng(5)
    ids = rng.integers(4, WIDTHS["vocab_size"], size=(2, 40)).astype(np.int32)
    n_valid = np.array([40, 23], np.int32)
    ref = None
    for flash in (True, False):
        lj, cj = jdec.prefill(pj, CFG_J, *_j(ids, n_valid), flash=flash)
        lt, ct = tdec.prefill(pt, CFG_T, *_t(ids.astype(np.int64), n_valid),
                              flash=flash)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for a, b in zip(cj, ct):
            np.testing.assert_allclose(b["k"].numpy(), np.asarray(a["k"]),
                                       **TOL)
            np.testing.assert_allclose(b["v"].numpy(), np.asarray(a["v"]),
                                       **TOL)
        np.testing.assert_array_equal(tdec.greedy(lt).numpy(),
                                      np.asarray(jnp.argmax(lj, axis=-1)))
        if ref is None:
            ref = lt
        else:  # flash and einsum agree inside the port too
            np.testing.assert_allclose(lt.numpy(), ref.numpy(), **TOL)


def test_prefill_flash_default_is_the_card_only(weights, monkeypatch):
    # on CPU tensors the default is the einsum path whatever T is
    calls = []
    orig = tdec.flash_attention
    monkeypatch.setattr(tdec, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ids = torch.zeros((1, 128), dtype=torch.long)
    tdec.prefill(weights[1], CFG_T, ids, torch.tensor([5]))
    assert not calls
    tdec.prefill(weights[1], CFG_T, ids, torch.tensor([5]), flash=True)
    assert len(calls) == WIDTHS["n_layers"]


def test_paged_prefill_matches_jax(weights):
    pj, pt = weights
    pj = jdec.plan_decode_params(CFG_J, pj)
    pt = tdec.plan_decode_params(CFG_T, pt)
    kp, vp, rng = _pools(6)
    B, T = 2, 4 * BS
    ids = rng.integers(4, WIDTHS["vocab_size"], size=(B, T)).astype(np.int32)
    n_valid = np.array([T, 11], np.int32)
    blocks = rng.permutation(NBLK - 1)[:6] + 1
    bt = np.array([blocks[:4], [blocks[4], blocks[5], 0, 0]], np.int32)
    for flash in (False, True):
        lj, kj, vj = jdec.paged_prefill(pj, CFG_J, *_j(ids, n_valid, kp, vp,
                                                       bt), flash=flash)
        kt, vt = _t(kp, vp)
        lt, kt2, vt2 = tdec.paged_prefill(
            pt, CFG_T, *_t(ids.astype(np.int64), n_valid), kt, vt,
            torch.from_numpy(bt), flash=flash)
        assert kt2 is kt and vt2 is vt  # in place
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        # block 0 takes the padding rows' writes and is never read
        np.testing.assert_allclose(kt.numpy()[:, 1:], np.asarray(kj)[:, 1:],
                                   **TOL)
        np.testing.assert_allclose(vt.numpy()[:, 1:], np.asarray(vj)[:, 1:],
                                   **TOL)
        # the blocks the tables name were written; the others kept
        untouched = np.setdiff1d(np.arange(1, NBLK), blocks)
        np.testing.assert_array_equal(kt.numpy()[:, untouched],
                                      kp[:, untouched])


# (B, max_new, stop): no stop; a stop token one row emits mid-run; every
# row stopping (the loop exits early); max_new past the cache (exit at
# pos == L)
@pytest.mark.parametrize("case", [(2, 8, None), (2, 8, "row0"),
                                  (1, 8, "row0"), (1, 12, None)])
def test_generate_tokens_fused_matches_jax(weights, case):
    pj, pt = weights
    B, max_new, stop = case
    rng = np.random.default_rng(8)
    L = 32
    n = 26 if max_new == 12 else 20
    ids = np.zeros((B, L), np.int32)
    ids[:, :n] = rng.integers(4, WIDTHS["vocab_size"], size=(B, n))
    n_valid = np.full(B, n, np.int32)
    if stop == "row0":
        free_j, _ = jdec.generate_tokens_fused(pj, CFG_J, *_j(ids, n_valid),
                                               max_new, None)
        stop = int(np.asarray(free_j)[0, 3])
    out_j, steps_j = jdec.generate_tokens_fused(pj, CFG_J, *_j(ids, n_valid),
                                                max_new, stop)
    out_t, steps_t = tdec.generate_tokens_fused(
        pt, CFG_T, *_t(ids.astype(np.int64), n_valid), max_new, stop)
    steps = int(steps_j)
    assert int(steps_t) == steps
    np.testing.assert_array_equal(out_t.numpy()[:, :steps],
                                  np.asarray(out_j)[:, :steps])
    if case == (1, 8, "row0"):
        assert steps <= 4  # stopped early
    if max_new == 12:
        assert steps == L - n + 1  # the cache filled up


LONG = dict(WIDTHS, max_len=320)  # buckets 64 and 256 (1024 is capped off)


@pytest.fixture(scope="module")
def long_lms():
    rng = np.random.default_rng(9)
    tree = _np_params(0)
    tree["pos_embed"] = (0.1 * rng.standard_normal(
        (LONG["max_len"], WIDTHS["d_model"]))).astype(np.float32)
    cfg_j, cfg_t = jdec.DecoderConfig(**LONG), tdec.DecoderConfig(**LONG)
    jax_lm = jdec.JaxDecoderLM(cfg_j, params=jax.tree_util.tree_map(
        jnp.asarray, tree))
    lm = tdec.TorchDecoderLM(
        cfg_t, params=decoder_params_from_numpy(tree, cfg_t, device="cpu"),
        device="cpu")
    return jax_lm, lm


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return " ".join(f"w{i}" for i in rng.integers(0, 5000, n))


# (prompt words, max_new): bucket 64; bucket 256; a prompt trimmed to
# fit the largest bucket; a max_new past the largest new bucket
@pytest.mark.parametrize("n_words,max_new", [(20, 8), (120, 6), (300, 8),
                                             (40, 20)])
def test_generate_fused_and_stepwise_match_jax(long_lms, n_words, max_new):
    jax_lm, lm = long_lms
    prompt = _words(n_words, n_words)
    n_ids = len(lm.encode_prompts([prompt], max_new)[0])
    assert lm._bucket(n_ids + max_new) == (64 if n_words <= 40 else 256)
    want = jax_lm.generate(prompt, max_new, fused=False)
    assert jax_lm.generate(prompt, max_new, fused=True) == want
    assert lm.generate(prompt, max_new, fused=True) == want
    assert lm.generate(prompt, max_new, fused=False) == want
    assert lm.generate(prompt, max_new) == want  # "auto" is the fused tier
    assert len(want.split()) == max_new


def test_generate_stop_token_and_unported_tier(long_lms):
    jax_lm, lm = long_lms
    prompt = _words(30, 1)
    full = lm.generate(prompt, 8)
    stop = int(full.split()[2].strip("<>"))
    want = jax_lm.generate(prompt, 8, stop_token=stop, fused=True)
    assert lm.generate(prompt, 8, stop_token=stop, fused=True) == want
    assert lm.generate(prompt, 8, stop_token=stop, fused=False) == want
    assert want.split() == full.split()[: want.split().index(f"<{stop}>") + 1]
    # the int8 host tier (ported since): the JAX LM's int8 tier's ids,
    # the same stop-token truncation
    want8 = jax_lm.generate(prompt, 8, fused="int8")
    assert lm.generate(prompt, 8, fused="int8") == want8
    assert len(want8.split()) == 8
    stop8 = int(want8.split()[2].strip("<>"))
    assert (lm.generate(prompt, 8, stop_token=stop8, fused="int8")
            == jax_lm.generate(prompt, 8, stop_token=stop8, fused="int8"))
