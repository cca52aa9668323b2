"""pathway_tpu_torch paged attention against the JAX package.

The port's plain paged attention (consecutive and ragged forms) and the
CPU path of its fused append+attend are held against
``pathway_tpu.kvcache.paged_attention`` on the same numpy inputs, in f32
at ``atol=rtol=1e-4`` (the two frameworks sum in different orders).  The
CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.kvcache import paged_attention as tpa
from pathway_tpu_torch.ops import _cuda

# the package re-exports a function under the submodule's name
jpa = importlib.import_module("pathway_tpu.kvcache.paged_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, HD, BS, NBLK, NBT = 3, 4, 16, 8, 24, 5


def _inputs(seed: int, C: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, HD)).astype(np.float32)
    kp = rng.standard_normal((NBLK, BS, H, HD)).astype(np.float32)
    vp = rng.standard_normal((NBLK, BS, H, HD)).astype(np.float32)
    bt = (rng.permutation(NBLK - 1)[: B * NBT] + 1).reshape(B, NBT)
    return q, kp, vp, bt.astype(np.int32), rng


def _both(q, kp, vp, bt, **kw):
    out_j = jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    out_t = tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("C", [1, 4])
def test_consecutive_form_matches_jax(C):
    q, kp, vp, bt, rng = _inputs(0, C)
    cl = rng.integers(C, NBT * BS + 1, size=B).astype(np.int32)
    cl[-1] = C  # the shortest legal context
    out_j, out_t = _both(q, kp, vp, bt, context_lens=cl)
    np.testing.assert_allclose(out_t, out_j, **TOL)


@pytest.mark.parametrize("C", [1, 6])
def test_ragged_form_matches_jax(C):
    q, kp, vp, bt, rng = _inputs(1, C)
    start = rng.integers(0, NBT * BS - C + 1, size=B).astype(np.int32)
    n_valid = rng.integers(1, C + 1, size=B).astype(np.int32)
    start[-1], n_valid[-1] = 0, 1  # context 1 against the null block
    bt[-1] = 0
    out_j, out_t = _both(q, kp, vp, bt, start_pos=start, n_valid=n_valid)
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_append_attend_matches_jax_reference_branch():
    q, kp, vp, bt, rng = _inputs(2, 1)
    cl = rng.integers(1, NBT * BS + 1, size=B).astype(np.int32)
    sb = bt[np.arange(B), (cl - 1) // BS].astype(np.int32)
    so = ((cl - 1) % BS).astype(np.int32)
    k_new = rng.standard_normal((B, H, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, H, HD)).astype(np.float32)
    a_j, k_j, v_j = jpa.paged_append_attend(
        *map(jnp.asarray, (q, k_new, v_new, kp, vp, bt, cl, sb, so)),
        use_pallas=False,
    )
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    a_t, k_t, v_t = tpa.paged_append_attend(
        *map(torch.from_numpy, (q, k_new, v_new)), kt, vt,
        *map(torch.from_numpy, (bt, cl, sb, so)),
    )
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    # the pools are updated in place, and exactly at the slots
    assert k_t is kt and v_t is vt
    np.testing.assert_array_equal(kt.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(v_j))
    changed = np.argwhere((kt.numpy() != kp).any(axis=(2, 3)))
    assert sorted(map(tuple, changed)) == sorted(zip(sb, so))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    _cuda.reset_launches()
    q, kp, vp, bt, rng = _inputs(3, 2)
    cl = np.full(B, 9, np.int32)
    _both(q, kp, vp, bt, context_lens=cl)
    assert sum(_cuda.LAUNCHES.values()) == 0
    # the kernel wrappers themselves take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_attention_cuda(
            *map(torch.from_numpy, (q, kp, vp, bt)),
            torch.from_numpy(cl - 1), torch.from_numpy(cl),
        )


@pytest.mark.parametrize("kw, match", [
    (dict(context_lens=np.array([3, 1, 5], np.int32)), "context_lens >="),
    (dict(start_pos=np.array([0, 2, 4], np.int32),
          n_valid=np.array([1, 0, 2], np.int32)), "n_valid >= 1"),
    (dict(start_pos=np.array([0, -1, 4], np.int32),
          n_valid=np.array([1, 1, 2], np.int32)), "start_pos >= 0"),
])
def test_context_contract_fails_loudly(kw, match):
    q, kp, vp, bt, _rng = _inputs(4, 2)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt)]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    for fn in (tpa.paged_attention, tpa.paged_attention_reference):
        with pytest.raises(ValueError, match=match):
            fn(*args, **tkw)
    # the JAX package rejects the same inputs the same way
    with pytest.raises(ValueError, match=match):
        jpa.paged_attention_reference(
            *map(jnp.asarray, (q, kp, vp, bt)),
            **{k: np.asarray(v) for k, v in kw.items()},
        )


def test_append_attend_rejects_zero_context():
    q, kp, vp, bt, _rng = _inputs(5, 1)
    zero = np.array([1, 0, 2], np.int32)
    with pytest.raises(ValueError, match="context_lens >="):
        tpa.paged_append_attend(
            torch.from_numpy(q), torch.zeros(B, H, HD), torch.zeros(B, H, HD),
            torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt),
            torch.from_numpy(zero), torch.from_numpy(zero),
            torch.from_numpy(zero),
        )


# The split structure of the CUDA kernels (csrc/paged_attention.cu): keys
# in tiles of 64 tokens, a block's tiles dealt to 2 key groups of warps.
KEY_TILE, KEY_GROUPS = 64, 2
_EMPTY = (torch.tensor(-1e30), torch.tensor(0.0))


def _part(q, k, v, scale):
    """(m, l, acc) of one part of a column's keys, in log2 units as the
    kernels keep them; an empty part is (-1e30, 0, 0)."""
    if k.shape[0] == 0:
        return (*_EMPTY, torch.zeros(q.shape[-1]))
    s = (k @ q) * (scale * math.log2(math.e))
    m = s.max()
    p = torch.exp2(s - m)
    return m, p.sum(), p @ v


def _merge(parts):
    """The online softmax's merge: m the largest m_i, each part's l and
    acc scaled by 2^(m_i - m)."""
    m = torch.stack([p[0] for p in parts]).max()
    c = [torch.exp2(p[0] - m) for p in parts]
    return (m, sum(ci * p[1] for ci, p in zip(c, parts)),
            sum(ci * p[2] for ci, p in zip(c, parts)))


@pytest.mark.parametrize("split", [tpa.RAGGED_SPLIT, tpa.APPEND_SPLIT])
def test_key_splits_merge_to_the_plain_version(split):
    """A row's keys cut at the kernels' split points (one thread block a
    split), each split's tiles dealt to the key groups, every part's
    (m, l, acc) merged by the rule the kernels use (groups in shared
    memory, splits by the row's last block to finish): the plain
    version's output, f32, within 1e-5."""
    rng = np.random.default_rng(7)
    C, Hs, hd, bs, nbt = 4, 2, 16, 16, 40  # tables span 640 tokens
    cl = np.array([640, 257, 130, 4], np.int32)  # the last column's context
    Bs = cl.shape[0]
    q = torch.from_numpy(rng.standard_normal((Bs, C, Hs, hd), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (Bs * nbt + 1, bs, Hs, hd), np.float32)) for _ in range(2))
    bt = torch.from_numpy((rng.permutation(Bs * nbt) + 1).reshape(Bs, nbt)
                          .astype(np.int32))
    ref = tpa.paged_attention_reference(q, kp, vp, bt, torch.from_numpy(cl))
    k = kp[bt.long()].reshape(Bs, nbt * bs, Hs, hd)
    v = vp[bt.long()].reshape(Bs, nbt * bs, Hs, hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(ref)
    n_splits = set()
    for b in range(Bs):
        for c in range(C):
            ctx = min(int(cl[b]) - (C - 1) + c, int(cl[b]))
            for h in range(Hs):
                splits = []
                for s0 in range(0, ctx, split):
                    s1 = min(s0 + split, ctx)
                    tiles = [(t, min(t + KEY_TILE, s1))
                             for t in range(s0, s1, KEY_TILE)]
                    groups = [
                        _merge([_part(q[b, c, h], k[b, t0:t1, h],
                                      v[b, t0:t1, h], scale)
                                for t0, t1 in tiles[g::KEY_GROUPS]]
                               or [(*_EMPTY, torch.zeros(hd))])
                        for g in range(KEY_GROUPS)]
                    splits.append(_merge(groups))
                n_splits.add(len(splits))
                _m, l, acc = _merge(splits)
                out[b, c, h] = acc / torch.clamp(l, min=1e-20)
    assert max(n_splits) == -(-640 // split) and min(n_splits) == 1
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
