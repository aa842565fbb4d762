"""Rounding the plain reference's products: ``bf16``, the configuration's
own precision (the yardstick that ``benchmark/check.py`` divides by), and
``fp8``, the precision below it (the control that the comparison deciding
``correct`` has to reject).

``fp8`` rounds a tensor to float8 e4m3 (3 mantissa bits) with one scale
for the whole tensor (its largest magnitude maps to 448, the format's
largest finite value), as fp8 training scales it, and rounds the gradient
that flows back through it the same way. It is the step below the
configuration's bfloat16 products.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Both ways rounded to bfloat16, the configuration's own precision:
    the yardstick of how far rounding alone moves this seed's numbers."""
    return _Bf16.apply(x)
