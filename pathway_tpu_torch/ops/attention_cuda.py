"""Flash attention for the dense prefill: the CUDA kernel and its plain
version.

Counterpart of ``pathway_tpu/ops/attention_pallas.py``: the Pallas
``_flash_kernel`` becomes ``csrc/flash_attention.cu``.  Same contract as
``models/attention.reference_attention``: (B, T, H, hd) in, (B, T, H, hd)
out in ``q``'s dtype, f32 softmax, scale ``1/sqrt(hd)``.  CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.

The kernel reads q/k/v IN PLACE through their batch, token and head
strides (the last dim must be contiguous), so the prefill's ``chunk(3)``
views of the fused QKV product go in without a copy; the JAX wrapper's
transpose to (B*H, T, D) and its padding of T and D to 128 have no
counterpart here.
"""

from __future__ import annotations

import math

import torch

from ..obs.profiler import add_kernel_cost
from . import _cuda

_SOURCE = "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_NEG = -1e30


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> torch.Tensor:
    """Plain version of what the kernel computes: f32 scores, masked
    positions at ``-1e30`` AND zero probability, the probabilities cast
    to ``v``'s dtype before the PV product (accumulated in f32), the
    denominator (the sum of the uncast probabilities) clamped at 1e-20,
    the output in ``q``'s dtype."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    valid = torch.ones((T, T), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid)
    s = s.masked_fill(~valid[None, None], _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p.masked_fill(~valid[None, None], 0.0)
    denom = p.sum(dim=-1).clamp_min(1e-20)  # (B, H, T)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def _check_operand(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} must be {like.dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                         f"{tuple(like.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    es = t.element_size()
    # the kernel moves rows with 16-byte vector loads
    if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name} must start and step (batch, token, head) "
                         "on 16-byte boundaries")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Launch the flash kernel on (B, T, H, hd) CUDA tensors, f32 or bf16,
    hd in {32, 64, 128}, any T >= 1, read through their strides."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes f32/bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(t, name, q)
    B, T, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes hd in {_HEAD_DIMS}, got {hd}")
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    _cuda.launch(
        _SOURCE, "pw_flash_attention", "flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, T, H, hd, *strides, int(causal), _DTYPE_CODE[q.dtype],
        1.0 / math.sqrt(hd),
    )
    # the roofline bound's count: 4 * hd operations per (query, key)
    # pair, q/k/v read and out written once
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    add_kernel_cost(4.0 * hd * pairs, 4.0 * q.numel() * q.element_size())
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    return flash_attention_reference(q, k, v, causal)


__all__ = ["flash_attention", "flash_attention_cuda",
           "flash_attention_reference"]
