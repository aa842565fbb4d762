"""Modulated deformable convolution (DCNv2) and the DCN block.

``deform_conv2d`` is the plain 4-corner gather of
``gssd_tpu/ops/deform_conv.py`` in the compute dtype (the f32 parity
reference, ``dcn_impl='xla'``). ``DCN`` predicts its own offsets and
mask with a zero-initialised 3x3 conv to 3*G*K channels laid out
(3, G, K): channel t*G*K + g*K + k with t in (dy, dx, mask-logit), then
runs the deformable conv that ``resolve_deform_impl`` picks for its
``dcn_impl`` and map size:

- ``'hat'``: ``deform_conv2d_hat`` (CUDA kernels), or ``deform_conv2d``
  on maps of more than ``GSSD_HAT_MAX_HW`` positions where that variable
  is set; on the CPU it defaults to the JAX package's 6000 (a TPU VMEM
  budget, which the card's kernels do not have), so that the CPU tests
  compare the JAX package's route;
- ``'pallas'``: ``deform_conv2d_pallas`` (the separable sampler's CUDA
  kernels);
- ``'fused'``: ``deform_conv2d_fused`` (patch gather forward, analytic
  backward with the dx kernel of the separable sampler);
- ``'xla'``: ``deform_conv2d``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.ops.kernels.deform_hat import deform_conv2d_hat


def _bilinear_gather(xg, py, px):
    """Sample xg [B, H, W, G, C] at real-valued (py, px) [B, Ho, Wo, G];
    a corner outside the map contributes 0. Returns [B, Ho, Wo, G, C]."""
    B, Ho, Wo, G = py.shape
    corners = patch_corners(xg, py.reshape(B, Ho * Wo, G), px.reshape(B, Ho * Wo, G))
    return blend_corners(*corners)[2].reshape(B, Ho, Wo, G, -1)


def patch_corners(xg, py, px):
    """The four bilinear corners of the 2x2 patch at (py, px): xg [B, H,
    W, G, Cg], py/px [B, P, G] f32 -> (v00, v01, v10, v11) [B, P, G, Cg]
    in xg's dtype (0 for a corner outside the map) and the lerp weights
    wy, wx [B, P, G, 1] in py's dtype. The corners of the JAX package's
    ``_bilinear_gather_group``, ``_patch_gather_group`` and
    ``_corners_group``, for every group at once."""
    B, H, W, G, Cg = xg.shape
    P = py.shape[1]
    y0, x0 = torch.floor(py), torch.floor(px)
    xf = xg.reshape(B, H * W, G, Cg)

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
        vals = torch.gather(xf, 1, idx[..., None].expand(B, P, G, Cg))
        return torch.where(inb[..., None], vals, 0)

    return (corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1),
            (py - y0)[..., None], (px - x0)[..., None])


def blend_corners(v00, v01, v10, v11, wy, wx):
    """Bilinear blend of ``patch_corners``' output -> (top row, bottom
    row, sample), in the JAX package's order of operations."""
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top, bot, top * (1 - wy) + bot * wy


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


IMPLS = ("xla", "pallas", "fused", "hat")


# the JAX package's GSSD_HAT_MAX_HW default: beyond it its hat backward
# spills the TPU's VMEM, so the 'hat' route falls back to deform_conv2d
HAT_MAX_HW = 6000


def resolve_deform_impl(impl: str, hw: int, device):
    """The deformable conv of ``impl`` for a map of ``hw`` positions on
    ``device``."""
    if impl == "pallas":
        from gssd_torch.ops.kernels.deform_sample import deform_conv2d_pallas

        return deform_conv2d_pallas
    if impl == "hat":
        limit = os.environ.get("GSSD_HAT_MAX_HW")
        if limit is None and torch.device(device).type != "cuda":
            limit = HAT_MAX_HW
        if limit is not None and hw > int(limit):
            return deform_conv2d
        return deform_conv2d_hat
    if impl == "fused":
        from gssd_torch.ops.deform_fused import deform_conv2d_fused

        return deform_conv2d_fused
    return deform_conv2d


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
        if impl not in IMPLS:
            raise ValueError(f"dcn_impl={impl!r}: expected one of {IMPLS}")
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
        fn = resolve_deform_impl(self.impl, x.shape[2] * x.shape[3], x.device)
        out = fn(x.permute(0, 2, 3, 1), dy, dx, m, self.weight, self.bias,
                 stride=self.stride, padding=self.padding,
                 dilation=self.dilation)
        return out.permute(0, 3, 1, 2), torch.stack([dy, dx], dim=-1)
