"""Modulated deformable convolution (DCNv2) and the DCN block.

``deform_conv2d`` is the plain 4-corner gather of
``gssd_tpu/ops/deform_conv.py`` in the compute dtype (the f32 parity
reference, ``dcn_impl='xla'``). ``DCN`` predicts its own offsets and
mask with a zero-initialised 3x3 conv to 3*G*K channels laid out
(3, G, K): channel t*G*K + g*K + k with t in (dy, dx, mask-logit), then
runs ``deform_conv2d_hat`` (the CUDA kernel, ``dcn_impl='hat'``) or
``deform_conv2d``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.ops.kernels.deform_hat import deform_conv2d_hat


def _bilinear_gather(xg, py, px):
    """Sample xg [B, H, W, G, C] at real-valued (py, px) [B, Ho, Wo, G];
    a corner outside the map contributes 0. Returns [B, Ho, Wo, G, C]."""
    B, H, W, G, C = xg.shape
    Ho, Wo = py.shape[1], py.shape[2]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy1 = (py - y0)[..., None]
    wx1 = (px - x0)[..., None]
    xf = xg.reshape(B, H * W, G, C)

    def corner(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        idx = flat.reshape(B, Ho * Wo, G, 1).expand(B, Ho * Wo, G, C)
        vals = torch.gather(xf, 1, idx).reshape(B, Ho, Wo, G, C)
        return torch.where(inb[..., None], vals, 0)

    v00, v01 = corner(y0, x0), corner(y0, x0 + 1)
    v10, v11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    top = v00 * (1 - wx1) + v01 * wx1
    bot = v10 * (1 - wx1) + v11 * wx1
    return top * (1 - wy1) + bot * wy1


def deform_conv2d(x, offset_y, offset_x, mask, weight, bias,
                  stride=1, padding=1, dilation=1):
    """Modulated deformable conv in x's dtype.

    x [B, H, W, C]; offset_y/offset_x/mask [B, Ho, Wo, G, K] (offsets in
    pixels, mask in [0, 1]); weight [K, C, Cout] (taps row-major);
    bias [Cout] -> [B, Ho, Wo, Cout].
    """
    B, H, W, C = x.shape
    K = weight.shape[0]
    kw = math.isqrt(K)
    G = mask.shape[3]
    Ho, Wo = mask.shape[1], mask.shape[2]
    dt = x.dtype
    base_y = (torch.arange(Ho, device=x.device, dtype=dt) * stride - padding)[:, None, None]
    base_x = (torch.arange(Wo, device=x.device, dtype=dt) * stride - padding)[None, :, None]
    xg = x.reshape(B, H, W, G, C // G)
    oy, ox, mk = offset_y.to(dt), offset_x.to(dt), mask.to(dt)
    acc = None
    for k in range(K):
        u, v = divmod(k, kw)
        py = base_y + u * dilation + oy[..., k]  # [B, Ho, Wo, G]
        px = base_x + v * dilation + ox[..., k]
        sampled = _bilinear_gather(xg, py, px) * mk[..., k, None]
        tap = sampled.reshape(B, Ho * Wo, C) @ weight[k].to(dt)
        acc = tap if acc is None else acc + tap
    return acc.reshape(B, Ho, Wo, -1) + bias.to(dt)


class DCN(nn.Module):
    """Deformable conv block with its own offset/mask predictor.

    NCHW in and out. Returns (output, offsets) with offsets
    [B, Ho, Wo, G, K, 2] (dy, dx), the JAX block's aux output.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deformable_groups: int = 1, impl: str = "hat",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in ("hat", "xla"):
            raise NotImplementedError(
                f"dcn_impl={impl!r} is not ported (the port has 'hat' and 'xla')")
        self.kernel, self.stride = kernel, stride
        self.padding, self.dilation = padding, dilation
        self.groups = deformable_groups
        self.impl = impl
        K = kernel * kernel
        self.conv_offset_mask = nn.Conv2d(
            in_channels, 3 * deformable_groups * K, kernel, stride, padding)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        stdv = 1.0 / math.sqrt(in_channels * K)
        self.weight = nn.Parameter(torch.empty(K, in_channels, features))
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B = x.shape[0]
        G, K = self.groups, self.kernel * self.kernel
        om = F.conv2d(x, self.conv_offset_mask.weight.to(x.dtype),
                      self.conv_offset_mask.bias.to(x.dtype),
                      self.stride, self.padding)
        Ho, Wo = om.shape[2], om.shape[3]
        om = om.float().permute(0, 2, 3, 1).reshape(B, Ho, Wo, 3, G, K)
        dy, dx = om[..., 0, :, :], om[..., 1, :, :]
        m = torch.sigmoid(om[..., 2, :, :])
        fn = deform_conv2d_hat if self.impl == "hat" else deform_conv2d
        out = fn(x.permute(0, 2, 3, 1), dy, dx, m, self.weight, self.bias,
                 stride=self.stride, padding=self.padding,
                 dilation=self.dilation)
        return out.permute(0, 3, 1, 2), torch.stack([dy, dx], dim=-1)
