"""Device and compute-dtype resolution shared by every entry point."""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    asked for and none is present (there is no quiet CPU fallback: a
    caller that wants the CPU passes ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_dtype(dtype: Any, device: torch.device) -> torch.dtype:
    """``"auto"`` picks the compute dtype by device: bf16 on the card
    (as the JAX package picks bf16 on the TPU), f32 on the CPU."""
    if isinstance(dtype, str):
        if dtype != "auto":
            raise ValueError(f"dtype {dtype!r} is not 'auto' or a torch.dtype")
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return dtype
