"""Modulated deformable conv with a fused analytic backward
(``dcn_impl='fused'``), the port of ``gssd_tpu/ops/deform_fused.py``.

Forward, per tap: the four-corner patch gather of ``patch_corners``
(plain PyTorch: in the JAX package it is an XLA gather, not a Pallas
kernel), the masked sample in f32 times the tap weight in f32, rounded
to x's dtype; the taps and the bias are summed in x's dtype.

Backward, one ``torch.autograd.Function`` per tap (``DeformTap``) with
only (py, px, m, x, w) saved: dsampled = g . w^T (w rounded to g's
dtype, f32 accumulation); d(mask), d(py), d(px) from the recomputed f32
corners with the floor convention (at an integer coordinate the
derivative takes the corners floor and floor + 1); dW = sampled^T . g in
f32; and dx through the CUDA kernel behind
``gssd_torch.ops.kernels.deform_sample.abx_dx`` (the port of the TPU
kernel ``_dx_kernel``, looked up at call time), fed the hat matrices of
the tap.
"""

from __future__ import annotations

import math

import torch

from gssd_torch.ops.deform_conv import blend_corners, patch_corners
from gssd_torch.ops.kernels import deform_sample

_BF16 = torch.bfloat16


class DeformTap(torch.autograd.Function):
    """One kernel tap: py, px, m [B, P, G] f32; xg [B, H, W, G, Cg]; w [C,
    Cout] -> [B, P, Cout] in xg's dtype."""

    @staticmethod
    def forward(ctx, py, px, m, xg, w):
        ctx.save_for_backward(py, px, m, xg, w)
        *_, sampled = blend_corners(*patch_corners(xg, py, px))
        sampled = sampled * m[..., None]
        B, P = py.shape[:2]
        out = torch.matmul(sampled.reshape(B, P, -1), w.to(sampled.dtype))
        return out.to(xg.dtype)

    @staticmethod
    def backward(ctx, g):
        py, px, m, xg, w = ctx.saved_tensors
        B, H, W, G, Cg = xg.shape
        P = py.shape[1]
        dsampled = torch.matmul(g.float(), w.to(g.dtype).float().t()).reshape(B, P, G, Cg)
        v00, v01, v10, v11, wy, wx = patch_corners(xg.float(), py, px)
        top, bot, unmasked = blend_corners(v00, v01, v10, v11, wy, wx)
        dm = (dsampled * unmasked).sum(-1)
        dpy = (dsampled * (bot - top)).sum(-1) * m
        ddx = (v01 - v00) * (1 - wy) + (v11 - v10) * wy
        dpx = (dsampled * ddx).sum(-1) * m
        sampled = (unmasked * m[..., None]).reshape(B, P, G * Cg)
        dw = torch.einsum("bpc,bpo->co", sampled, g.float()).to(w.dtype)
        # dx = S^T dsampled through the hat matrices of this tap
        mt = m.permute(0, 2, 1)
        a = (deform_sample.hat_weights(py.permute(0, 2, 1), H) * mt[..., None]).to(_BF16)
        bm = deform_sample.hat_weights(px.permute(0, 2, 1), W).to(_BF16)
        dsg = dsampled.permute(0, 2, 1, 3).to(_BF16)
        dxg = deform_sample.abx_dx(a.contiguous(), bm.contiguous(),
                                   dsg.contiguous())  # [B, G, H, W, Cg]
        dx = dxg.permute(0, 2, 3, 1, 4).to(xg.dtype)
        return dpy, dpx, dm, dx, dw


def deform_conv2d_fused(x, offset_y, offset_x, mask, weight, bias,
                        stride=1, padding=1, dilation=1):
    """``deform_conv2d``'s contract with the fused backward: x [B, H, W,
    C]; offsets and mask [B, Ho, Wo, G, K]; weight [K, C, Cout]; bias
    [Cout] -> [B, Ho, Wo, Cout] in x's dtype."""
    B, H, W, C = x.shape
    K = weight.shape[0]
    kw = math.isqrt(K)
    _, Ho, Wo, G, _ = mask.shape
    P = Ho * Wo
    dev = x.device
    base_y = (torch.arange(Ho, dtype=torch.float32, device=dev) * stride - padding)[:, None, None]
    base_x = (torch.arange(Wo, dtype=torch.float32, device=dev) * stride - padding)[None, :, None]
    xg = x.reshape(B, H, W, G, C // G).contiguous()
    out = None
    for k in range(K):
        u, v = divmod(k, kw)
        py = (base_y + u * dilation + offset_y[..., k].float()).reshape(B, P, G)
        px = (base_x + v * dilation + offset_x[..., k].float()).reshape(B, P, G)
        mk = mask[..., k].float().reshape(B, P, G)
        tap = DeformTap.apply(py, px, mk, xg, weight[k])
        out = tap if out is None else out + tap
    out = out + bias.to(out.dtype)
    return out.reshape(B, Ho, Wo, -1).to(x.dtype)
