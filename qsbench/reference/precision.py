"""Arithmetic of the plain references, in float64, float32 or TF32.

``float64`` is the reference. ``tf32`` is the control: float32 planes in
which every product takes its two factors rounded to TF32 (10 mantissa
bits, round to nearest even) and sums in float32, as a tensor-core TF32
product does. It stands for the step below the configurations' complex64
(float32 with TF32 off).
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 mantissa bits (ties to even),
    as a new float32 tensor. Infinities and NaNs are not expected."""
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    r = torch.bitwise_and(i + 0xFFF + lsb, ~0x1FFF)
    return r.view(torch.float32)


def round_scalar_tf32(c: float) -> float:
    return float(round_tf32(torch.tensor([c], dtype=torch.float32))[0])


class Arith:
    """In-place ``x <- a x + b y`` on planes in one precision."""

    def __init__(self, precision: str):
        self.precision = precision
        self.dtype = dtype_of(precision)
        self.tf32 = precision == "tf32"

    def scalar(self, c: float) -> float:
        return round_scalar_tf32(c) if self.tf32 else float(c)

    def lin_(self, x: torch.Tensor, a: float, y: torch.Tensor,
             b: float) -> torch.Tensor:
        """``x <- a x + b y`` in place (``y`` is read, not written)."""
        if self.tf32:
            x.copy_(round_tf32(x))
            y = round_tf32(y)
        return x.mul_(self.scalar(a)).add_(y, alpha=self.scalar(b))
