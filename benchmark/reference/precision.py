"""The references' arithmetic: exact float32, and the lower precisions
that the controls put in the program's place."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """Float32 products with TF32 off, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def tf32():
    """Float32 products in TF32 (the tensor cores' 10-bit mantissa),
    restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude maps to e4m3's largest, 448), back in
    float32: the per-tensor-scaled fp8 that an fp8 product reads."""
    x = x.float()
    amax = x.abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale
