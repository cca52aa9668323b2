"""pathway_tpu_torch flash attention against the JAX package.

The port's ``flash_attention`` on CPU tensors runs its plain version
(``flash_attention_reference``); it is held against the JAX
``flash_attention(..., use_pallas=True)``, which on the CPU runs the
Pallas kernel body in interpret mode, and against the JAX
``reference_attention``, on the JAX test's own shapes (one tile, several
key blocks, T and D off the tile grid), f32, at that test's tolerance
2e-4 (summation order).  The port's ``reference_attention`` is held
against JAX's at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.attention import reference_attention as jax_ref
from pathway_tpu.ops.attention_pallas import flash_attention as jax_flash
from pathway_tpu_torch.models.attention import reference_attention
from pathway_tpu_torch.ops import _cuda
from pathway_tpu_torch.ops.attention_cuda import (flash_attention,
                                                  flash_attention_cuda,
                                                  flash_attention_reference)

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(1, 128, 2, 16), (2, 256, 2, 32), (1, 200, 3, 24),
          (1, 65, 2, 32)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_matches_jax_pallas_and_reference(shape, causal):
    q, k, v = _qkv(shape, SHAPES.index(shape) * 2 + causal)
    _cuda.reset_launches()
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert not _cuda.LAUNCHES  # CPU tensors take the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jax_flash(jq, jk, jv, causal=causal, use_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    ref = jax_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_attention_matches_jax(shape, causal):
    q, k, v = _qkv(shape, 100 + SHAPES.index(shape) * 2 + causal)
    out = reference_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    ref = jax_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_version_reads_strided_views_and_keeps_bf16():
    # the prefill hands over chunk(3) views of the fused QKV product
    rng = np.random.default_rng(7)
    B, T, H, hd = 2, 40, 3, 32
    qkv = torch.from_numpy(
        rng.normal(size=(B, T, 3 * H * hd)).astype(np.float32))
    q, k, v = (t.reshape(B, T, H, hd) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True)
    want = reference_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    # bf16 in, bf16 out; within bf16 rounding of the f32 result
    # (probabilities rounded to bf16 before the PV product, output
    # rounded once: a few 2^-8 relative steps)
    b16 = flash_attention_reference(q.bfloat16(), k.bfloat16(),
                                    v.bfloat16(), causal=True)
    assert b16.dtype == torch.bfloat16
    ref16 = reference_attention(q.bfloat16().float(), k.bfloat16().float(),
                                v.bfloat16().float(), causal=True)
    np.testing.assert_allclose(b16.float().numpy(), ref16.numpy(),
                               atol=3e-2, rtol=0)


def test_masked_rows_and_keys_contribute_nothing():
    # causal row 0 sees key 0 only: its output is v[0] exactly
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 9, 2, 32), 11))
    out = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=0, atol=1e-6)
    # non-causal with a huge key: weight ~1 on it, finite everywhere
    k2 = k.clone()
    k2[:, 4] = q.mean(dim=1) * 1e3
    assert bool(torch.isfinite(flash_attention(q, k2, v)).all())


def test_kernel_wrapper_takes_cuda_tensors_only():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q, causal=True)
