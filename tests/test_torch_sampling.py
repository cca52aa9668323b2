"""pathway_tpu_torch seeded sampling against the JAX package.

- ``models/prng.py``: keys, bits and uniforms bit-identical to
  ``jax.random`` (threefry, partitionable bits); Gumbel draws within the
  two backends' ``log`` rounding (absolute 1e-6: both take
  ``-log(-log(u))`` of bit-identical ``u``, and an ulp of either ``log``
  moves the result by a few 1e-7 at most).
- ``_sample_rows``: the stable sort, the top-k/top-p keep masks and the
  drawn ids identical to JAX's on f32 logits with ties, at temperature 0
  and with each mask on and off.
- each sampled program against its JAX twin (``attn="reference"``) on
  the same pools and tables: ids identical, pools within f32 rounding.
- the port's engine against the JAX ``PagedDecodeEngine`` on batches
  mixing greedy, temperature-0 and sampled rows: chunked per-step,
  chained, whole-bucket and preempting runs give identical tokens.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.kvcache.engine import PagedDecodeEngine as JaxEngine
from pathway_tpu.models import decoder as jdec
from pathway_tpu.obs import profiler as jprof
from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models import prng
from pathway_tpu_torch.models.convert import decoder_params_from_numpy

from .test_torch_engine import CFG_J, CFG_T, WIDTHS, _np_params, _prompts

SEEDS = (0, 1, 7, -1, 2**31 - 1)
EMITS = (0, 1, 31, 1000)
GUMBEL_ATOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _jax_key(seed, emit):
    k = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(seed))
    return jax.random.fold_in(k, jnp.int32(emit))


def _port_key(seed, emit):
    return prng.fold_in(prng.fold_in(prng.prng_key(0), seed), emit)


# -- prng ---------------------------------------------------------------------


def test_jax_threefry_is_partitionable():
    # random_bits_32 mirrors the partitionable bit layout; a jax that
    # flips this default must fail here, not drift silently
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_keys_bits_and_gumbel_match_jax(seed):
    tiny = np.finfo(np.float32).tiny
    for emit in EMITS:
        kj, kt = _jax_key(seed, emit), _port_key(seed, emit)
        assert np.asarray(kj).astype(np.int64).tolist() == kt.tolist()
        bits_j = np.asarray(jax.random.bits(kj, (777,), jnp.uint32))
        np.testing.assert_array_equal(bits_j.astype(np.int64),
                                      prng.random_bits_32(kt, 777).numpy())
        u_j = np.asarray(jax.random.uniform(kj, (777,), jnp.float32,
                                            minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u_j, prng.uniform_tiny(kt, 777).numpy())
        g_j = np.asarray(jax.random.gumbel(kj, (777,), jnp.float32))
        np.testing.assert_allclose(prng.gumbel(kt, 777).numpy(), g_j,
                                   rtol=0, atol=GUMBEL_ATOL)


def test_prng_rows_batch_like_jax_vmap():
    seeds = torch.tensor(SEEDS, dtype=torch.int64)
    emits = torch.tensor([3, 0, 1000, 31, 7], dtype=torch.int64)
    want = jdec._row_sample_keys(jnp.asarray(SEEDS, jnp.int32),
                                 jnp.asarray(emits.numpy(), jnp.int32))
    got = tdec._row_sample_keys(seeds, emits)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())
    # one row's bits do not depend on the other rows
    np.testing.assert_array_equal(
        prng.random_bits_32(got, 64)[2].numpy(),
        prng.random_bits_32(got[2], 64).numpy())


def test_chip_smoke_prng_constants_match_jax():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.PRNG_KS_PARITY, smoke.PRNG_ROTATIONS) == (
        prng.KS_PARITY, prng.ROTATIONS)
    for (seed, emit), (key, bits) in smoke.PRNG_KNOWN.items():
        kj = _jax_key(seed, emit)
        assert np.asarray(kj).astype(np.int64).tolist() == list(key)
        got = np.asarray(jax.random.bits(kj, (len(bits),), jnp.uint32))
        assert got.astype(np.int64).tolist() == list(bits)


# -- the sampling head --------------------------------------------------------

# (temperature, top_k, top_p): greedy, plain, each mask alone, both, top-1
ROWS = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 40, 1.0), (1.2, 0, 0.9),
        (0.8, 40, 0.95), (0.5, 1, 1.0), (1.5, 0, 0.5), (0.9, 8, 0.9)]


def _row_logits(V=WIDTHS["vocab_size"], seed=5):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(ROWS), V)) * 2.0).astype(np.float32)
    # exact ties, at the top and inside the nucleus: the stable sort
    # must keep the smaller id first in both packages
    for r in range(len(ROWS)):
        top = int(np.argmax(logits[r]))
        logits[r, (top + 17) % V] = logits[r, top]
        logits[r, 3::97] = logits[r, 3]
    return logits


def _jax_keep(logits, temperature, top_k, top_p):
    """The JAX package's mask, decoder.py:362-371, on the same inputs."""
    V = logits.shape[-1]
    order = jnp.argsort(-logits, axis=-1)
    scaled = jnp.take_along_axis(logits, order, axis=-1) / jnp.maximum(
        temperature, 1e-6)[:, None]
    probs = jax.nn.softmax(scaled, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    k = jnp.where(top_k > 0, top_k, V)[:, None]
    keep = (jnp.arange(V)[None, :] < k) & ((cum - probs) < top_p[:, None])
    return np.asarray(order), np.asarray(keep.at[:, 0].set(True))


@pytest.mark.parametrize("emit", (0, 9))
def test_sample_rows_matches_jax(emit):
    logits = _row_logits()
    t, k, p = (np.array(c) for c in zip(*ROWS))
    t, p = t.astype(np.float32), p.astype(np.float32)
    k = k.astype(np.int32)
    seeds = np.arange(len(ROWS), dtype=np.int32) * 13 - 5
    emits = np.full(len(ROWS), emit, np.int32)
    jl = jnp.asarray(logits)
    want = np.asarray(jdec._sample_rows(
        jl, jnp.argmax(jl, axis=-1).astype(jnp.int32), jnp.asarray(t),
        jnp.asarray(k), jnp.asarray(p),
        jdec._row_sample_keys(jnp.asarray(seeds), jnp.asarray(emits))))
    tl = torch.from_numpy(logits)
    tt, tk, tp = (torch.from_numpy(a) for a in (t, k, p))
    keys = tdec._row_sample_keys(torch.from_numpy(seeds).long(),
                                 torch.from_numpy(emits).long())
    got = tdec._sample_rows(tl, tdec.greedy(tl), tt, tk, tp, keys).numpy()
    order_j, keep_j = _jax_keep(jl, jnp.asarray(t), jnp.asarray(k),
                                jnp.asarray(p))
    order_t, _scaled, keep_t = tdec._nucleus(tl, tt, tk, tp)
    np.testing.assert_array_equal(order_t.numpy(), order_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(got, want)
    assert got[0] == int(np.argmax(logits[0]))  # temperature 0 is greedy
    assert got[5] == int(np.argmax(logits[5]))  # top-1 keeps rank 0 only
    # every drawn id lies in its row's kept set
    for r in range(len(ROWS)):
        assert got[r] in order_j[r][keep_j[r]]


def test_sample_rows_draws_depend_on_seed_and_emit_only():
    logits = torch.from_numpy(_row_logits())
    t = torch.full((len(ROWS),), 1.0)
    k = torch.zeros(len(ROWS), dtype=torch.int64)
    p = torch.ones(len(ROWS))
    seeds = torch.full((len(ROWS),), 42, dtype=torch.int64)
    draws = [tdec._sample_rows(logits, tdec.greedy(logits), t, k, p,
                               tdec._row_sample_keys(seeds, torch.full_like(
                                   seeds, e))) for e in range(8)]
    # the same (seed, emit) gives the same draw; new emit indices differ
    assert torch.equal(draws[0], tdec._sample_rows(
        logits, tdec.greedy(logits), t, k, p,
        tdec._row_sample_keys(seeds, torch.zeros_like(seeds))))
    assert len({tuple(d.tolist()) for d in draws}) > 1


# -- the sampled programs against their JAX twins -----------------------------

L, NBLK, BS, H = WIDTHS["n_layers"], 24, 8, WIDTHS["n_heads"]
HD = WIDTHS["d_model"] // H
SAMPLING = dict(temperature=np.array([0.0, 0.8, 1.2, 0.7], np.float32),
                top_k=np.array([0, 40, 0, 5], np.int32),
                top_p=np.array([1.0, 0.95, 0.9, 1.0], np.float32),
                seed=np.array([3, -1, 2**31 - 1, 7], np.int32),
                emit=np.array([0, 5, 31, 1000], np.int32))


def _pools(seed=2):
    rng = np.random.default_rng(seed)
    shape = (L, NBLK, BS, H, HD)
    return (rng.standard_normal(shape).astype(np.float32) * 0.5,
            rng.standard_normal(shape).astype(np.float32) * 0.5)


def _decode_inputs(K=1):
    """Four rows with 4-block tables and contexts 5, 17, 24, 1 before the
    step; K write slots each at the tail."""
    rng = np.random.default_rng(3)
    B = 4
    bt = (np.arange(B * 4, dtype=np.int32).reshape(B, 4) + 1)
    ctx = np.array([4, 16, 23, 0])
    token = rng.integers(0, WIDTHS["vocab_size"], B).astype(np.int32)
    pos = (ctx[:, None] + np.arange(K)[None, :])
    sb = bt[np.arange(B)[:, None], pos // BS].astype(np.int32)
    so = (pos % BS).astype(np.int32)
    return token, ctx.astype(np.int32), bt, sb, so


@pytest.mark.parametrize("program", ["decode", "chained", "mixed",
                                     "prefill"])
def test_sampled_program_matches_jax_twin(weights, program):
    pj, pt = weights
    kp, vp = _pools()
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    samp = SAMPLING
    sj = [jnp.asarray(samp[n]) for n in ("temperature", "top_k", "top_p",
                                         "seed", "emit")]
    st = [torch.from_numpy(samp["temperature"]),
          torch.from_numpy(samp["top_k"]).long(),
          torch.from_numpy(samp["top_p"]),
          torch.from_numpy(samp["seed"]).long(),
          torch.from_numpy(samp["emit"]).long()]

    def both(*ints):
        return ([jnp.asarray(a) for a in ints],
                [torch.from_numpy(np.asarray(a)).long() for a in ints])

    if program in ("decode", "chained"):
        K = 1 if program == "decode" else 3
        token, ctx, bt, sb, so = _decode_inputs(K)
        if program == "decode":
            (aj, at) = both(token, ctx, bt, sb[:, 0], so[:, 0])
            want = jdec.paged_decode_step_sampled(
                pj, CFG_J, jk, jv, *aj, *sj, attn="reference")
            got = tdec.paged_decode_step_sampled(pt, CFG_T, tk, tv, *at, *st)
        else:
            (aj, at) = both(token, ctx, bt, sb, so)
            want = jdec.paged_chained_decode_sampled(
                pj, CFG_J, jk, jv, *aj, *sj, attn="reference")
            got = tdec.paged_chained_decode_sampled(pt, CFG_T, tk, tv, *at,
                                                    *st)
    elif program == "mixed":
        ints = _mixed_inputs()
        (aj, at) = both(*ints)
        want = jdec.paged_mixed_step_sampled(pj, CFG_J, jk, jv, *aj, *sj,
                                             attn="reference")
        got = tdec.paged_mixed_step_sampled(pt, CFG_T, tk, tv, *at, *st)
    else:
        rng = np.random.default_rng(4)
        B, T = 4, 32
        n = np.array([11, 32, 1, 20])
        buf = np.zeros((B, T), np.int32)
        for b in range(B):
            buf[b, :n[b]] = rng.integers(0, WIDTHS["vocab_size"], n[b])
        bt = np.arange(1, 1 + B * (T // BS), dtype=np.int32).reshape(B, -1)
        (aj, at) = both(buf, n, bt)
        want = jdec.paged_prefill_sampled(
            pj, CFG_J, aj[0], aj[1], jk, jv, aj[2], *sj)
        got = tdec.paged_prefill_sampled(pt, CFG_T, at[0], at[1], tk, tv,
                                         at[2], *st)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _mixed_inputs():
    """A packed mixed step: row 0 a decode token at position 9, row 1 a
    fresh 8-token chunk, row 2 a 3-token chunk at positions 16-18 of a
    sequence whose first 16 tokens are resident, row 3 idle."""
    rng = np.random.default_rng(6)
    B, C = 4, 8
    T = B + C
    tables = np.zeros((B, 4), np.int32)
    tables[0] = [1, 2, 0, 0]
    tables[1] = [3, 0, 0, 0]
    tables[2] = [4, 5, 6, 0]
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
    for row, (start, nv) in enumerate(((9, 1), (0, 8), (16, 3))):
        pos = np.arange(start, start + nv)
        tokens[t:t + nv] = rng.integers(0, WIDTHS["vocab_size"], nv)
        positions[t:t + nv] = pos
        sb[t:t + nv] = tables[row, pos // BS]
        so[t:t + nv] = pos % BS
        row_start[row] = start
        row_nvalid[row] = nv
        row_token_idx[row, :nv] = np.arange(t, t + nv)
        row_token_idx[row, nv:] = t + nv - 1
        tok_row[t:t + nv] = row
        tok_col[t:t + nv] = np.arange(nv)
        logit_idx[row] = t + nv - 1
        t += nv
    return (tokens, positions, tables, row_start, row_nvalid, row_token_idx,
            tok_row, tok_col, sb, so, logit_idx)


# -- the engine against the JAX engine ----------------------------------------


def _mixed_requests(prompts, lens=(12, 5, 9, 16, 1, 7)):
    """Greedy, temperature-0 and sampled rows in one batch."""
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, lens)):
        if i % 3 == 0:
            reqs.append((p, n))
        elif i % 3 == 1:
            reqs.append((p, n, {"sampling": (0.0, 0, 1.0, i)}))
        else:
            reqs.append((p, n, {"sampling": (0.8, 40, 0.95, 100 + i)}))
    return reqs


# mode -> (num_blocks, max_batch_size, prefill_chunk, chain_steps, chunked)
ENGINE_MODES = {
    "chunked_per_step": (64, 3, 8, 1, True),
    "chained": (64, 4, 16, 4, True),
    "whole_bucket": (64, 4, 16, 4, False),
    "preempting": (12, 4, 16, 4, True),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_sampled_tokens_match_jax_engine(weights, mode):
    pj, pt = weights
    nb, mb, chunk, chain, chunked = ENGINE_MODES[mode]
    kw = dict(num_blocks=nb, block_size=8, max_batch_size=mb,
              prefill_chunk=chunk, chain_steps=chain,
              chunked_prefill=chunked)
    reqs = _mixed_requests(_prompts())
    want = JaxEngine(CFG_J, pj, attn="reference",
                     name=f"t_torch_sampled_{mode}", **kw).generate_batch(reqs)
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", **kw)
    assert eng.generate_batch(reqs) == want
    assert eng._sampled is not None
    if chain > 1:
        assert eng.rounds["chain"] > 0
    if not chunked:
        assert eng.rounds["prefill"] >= len(reqs)
    if nb == 12:
        assert eng.pool.n_preemptions > 0
    assert not eng.pool.sequences()
    eng.pool.check_invariants(eng.prefix.external_refs())


def test_temperature_zero_rows_equal_greedy_and_seed_replays(weights):
    _pj, pt = weights
    kw = dict(num_blocks=64, block_size=8, max_batch_size=4, chain_steps=4)
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", **kw)
    prompts = _prompts()[:4]
    greedy_out = eng.generate_batch([(p, 10) for p in prompts])
    assert eng._sampled is None  # a greedy-only engine touches none
    temp0 = [(p, 10, {"sampling": (0.0, 0, 1.0, 100 + i)}) if i % 2 == 0
             else (p, 10) for i, p in enumerate(prompts)]
    assert eng.generate_batch(temp0) == greedy_out
    spec = [(p, 10, {"sampling": {"temperature": 0.9, "top_k": 8,
                                  "top_p": 0.95, "seed": 1234 + i}})
            for i, p in enumerate(prompts)]
    first = eng.generate_batch(spec)
    assert eng.generate_batch(spec) == first
    assert first != greedy_out  # sampling really draws
    other = [(p, 10, {"sampling": (0.9, 8, 0.95, 4321 + i)})
             for i, p in enumerate(prompts)]
    assert eng.generate_batch(other) != first


def test_continued_request_and_streaming(weights):
    """A request carrying ``emitted`` continues at emit index
    len(emitted); options ride either tail slot; on_token streams."""
    _pj, pt = weights
    eng = PagedDecodeEngine(CFG_T, pt, device="cpu", num_blocks=64,
                            block_size=8, max_batch_size=4)
    prompt = _prompts()[2]
    spec = (0.8, 0, 1.0, 77)
    full = eng.generate_batch([(prompt, 12, {"sampling": spec})])[0]
    tail = eng.generate_batch(
        [(prompt, 12, {"sampling": spec, "emitted": full[:5]})])[0]
    assert tail == full
    streamed = []
    out = eng.serve_batch([
        (prompt, 12, 0, {"sampling": spec, "on_token": streamed.append}),
        (prompt, 12, {"sampling": spec}),
    ])
    assert out == [full, full] and streamed == full


def test_greedy_rounds_issue_no_sampling_ops(weights):
    """Greedy rounds dispatch the greedy programs: no sort, cumsum or
    threefry op runs, and the sampled programs are never looked up."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    _pj, pt = weights
    reqs = [(p, n) for p, n in zip(_prompts(), (12, 5, 9, 16, 1, 7))]
    for chunked in (True, False):
        eng = PagedDecodeEngine(CFG_T, pt, device="cpu", num_blocks=64,
                                block_size=8, max_batch_size=4,
                                chain_steps=4, chunked_prefill=chunked)
        with _Ops() as ops:
            eng.generate_batch(reqs)
        assert not ops.names & {"sort", "cumsum", "bitwise_xor", "log"}
        assert eng._sampled is None
        with _Ops() as ops:
            eng.generate_batch([reqs[0] + ({"sampling": (0.5, 0, 1.0, 1)},)])
        assert {"sort", "cumsum", "bitwise_xor"} <= ops.names
