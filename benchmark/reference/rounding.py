"""The roundings that the plain references emulate, each from float64 (or
float32) values back to float64: a cell's stated precision, or the one
below it that its control computes in."""

from __future__ import annotations

import torch

__all__ = ["round_bf16", "round_tf32", "int8_scaled"]


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float64)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32, the 10 mantissa bits the tensor cores keep of a
    float32 operand with TF32 on (nearest, ties away from zero)."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(torch.float64)


def int8_scaled(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale per tensor, ``max|t| / 127``."""
    s = float(t.abs().max()) / 127.0 or 1.0
    return torch.clamp(torch.round(t / s), -127, 127) * s
