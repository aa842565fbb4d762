"""Modulated deformable conv (DCNv2) forward through the hand-written
CUDA kernel ``csrc/deform_conv_fwd.cu``, the port of
``gssd_tpu/ops/pallas/deform_hat.py`` (``_fwd_kernel`` /
``_fwd_kernel_allwin`` behind ``deform_conv2d_hat``).

``deform_conv_fwd`` is the kernel boundary. On a CUDA tensor it
launches the kernel; on a CPU tensor it runs ``deform_conv_fwd_plain``,
the same arithmetic in plain PyTorch. ``deform_conv2d_hat`` keeps the JAX
entry point's contract and prepares the kernel's inputs as it does:
absolute f32 sample coordinates, bf16 input and bf16 weights regrouped
per deformable group.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gssd_torch.ops.kernels.build import CudaKernel

KERNEL = CudaKernel(
    "deform_conv_fwd.cu", "deform_conv_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8)


def deform_conv_fwd_plain(x, py, px, m, wg, bias):
    """Plain PyTorch version of the kernel: for each tap, blend the four
    corners of bf16 ``x`` with f32 weights (times the mask; a corner
    outside the map is 0), round the sample to bf16, contract it with
    the bf16 weights in f32, then add the bias."""
    B, H, W, C = x.shape
    _, P, G, K = py.shape
    Cg = C // G
    xf = x.float().reshape(B, H * W, G, Cg)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    out = torch.zeros(B, P, wg.shape[-1], dtype=torch.float32, device=x.device)
    for k in range(K):
        samp = torch.zeros(B, P, G, Cg, dtype=torch.float32, device=x.device)
        for dy, wy in ((0, 1 - ly[..., k]), (1, ly[..., k])):
            for dx, wx in ((0, 1 - lx[..., k]), (1, lx[..., k])):
                yy = y0[..., k] + dy
                xx = x0[..., k] + dx
                inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                w = torch.where(inb, wy * wx * m[..., k], 0.0)
                idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
                vals = torch.gather(xf, 1, idx[..., None].expand(B, P, G, Cg))
                samp = samp + w[..., None] * vals
        samp = samp.to(torch.bfloat16).float().reshape(B, P, C)
        out = out + samp @ wg[:, k].float().reshape(C, -1)
    return out + bias


def deform_conv_fwd(x, py, px, m, wg, bias):
    """x [B, H, W, C] bf16; py, px, m [B, P, G, K] f32 (absolute sample
    coordinates and modulation); wg [G, K, C/G, Cout] bf16; bias [Cout]
    f32 -> out [B, P, Cout] f32. All contiguous."""
    B, H, W, C = x.shape
    if py.dim() != 4:
        raise ValueError(f"deform_conv_fwd: py must be [B, P, G, K], got {tuple(py.shape)}")
    _, P, G, K = py.shape
    Cout = wg.shape[-1]
    for name, t, dt, shape in (
        ("x", x, torch.bfloat16, (B, H, W, C)),
        ("py", py, torch.float32, (B, P, G, K)),
        ("px", px, torch.float32, (B, P, G, K)),
        ("m", m, torch.float32, (B, P, G, K)),
        ("wg", wg, torch.bfloat16, (G, K, C // G, Cout)),
        ("bias", bias, torch.float32, (Cout,)),
    ):
        if t.dtype != dt:
            raise TypeError(f"deform_conv_fwd: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"deform_conv_fwd: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"deform_conv_fwd: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("deform_conv_fwd: inputs on different devices")
    if C % G:
        raise ValueError(f"deform_conv_fwd: C={C} is not a multiple of G={G}")
    if x.device.type == "cpu":
        return deform_conv_fwd_plain(x, py, px, m, wg, bias)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv_fwd: unsupported device {x.device}")
    if (C // G) % 2:
        raise ValueError(f"deform_conv_fwd: the kernel takes an even C/G, got {C // G}")
    tensors = (x, py, px, m, wg, bias)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("deform_conv_fwd: inputs must be 16-byte aligned")
    out = torch.empty(B, P, Cout, dtype=torch.float32, device=x.device)
    KERNEL.launch(torch.cuda.current_stream(x.device).cuda_stream,
                  *(t.data_ptr() for t in tensors), out.data_ptr(),
                  B, H, W, C, G, K, P, Cout)
    return out


def sample_coords(offset_y, offset_x, stride=1, padding=1, dilation=1):
    """Absolute f32 sample coordinates (py, px) [B, Ho, Wo, G, K] of
    every tap: base + tap * dilation + offset, summed in the JAX order."""
    _, Ho, Wo, _, K = offset_y.shape
    kw = math.isqrt(K)
    dev = offset_y.device
    f32 = torch.float32
    base_y = (torch.arange(Ho, dtype=f32, device=dev) * stride - padding)[:, None, None, None]
    base_x = (torch.arange(Wo, dtype=f32, device=dev) * stride - padding)[None, :, None, None]
    tap = torch.arange(K, device=dev)
    u = (tap // kw).to(f32) * dilation
    v = (tap % kw).to(f32) * dilation
    return base_y + u + offset_y.float(), base_x + v + offset_x.float()


def deform_conv2d_hat(x, offset_y, offset_x, mask, weight, bias,
                      stride=1, padding=1, dilation=1):
    """x [B, H, W, C]; offsets and mask [B, Ho, Wo, G, K]; weight
    [K, C, Cout]; bias [Cout] -> [B, Ho, Wo, Cout] in x's dtype.
    Sampling and weights in bf16, accumulation in f32."""
    B, H, W, C = x.shape
    K, _, Cout = weight.shape
    _, Ho, Wo, G, _ = mask.shape
    P = Ho * Wo
    py, px = sample_coords(offset_y, offset_x, stride, padding, dilation)
    # wg[g] = [K, Cg, Cout], rows ordered (k, cg) within the group
    wg = weight.reshape(K, G, C // G, Cout).permute(1, 0, 2, 3)
    out = deform_conv_fwd(
        x.to(torch.bfloat16).contiguous(),
        py.reshape(B, P, G, K).contiguous(),
        px.reshape(B, P, G, K).contiguous(),
        mask.float().reshape(B, P, G, K).contiguous(),
        wg.to(torch.bfloat16).contiguous(),
        bias.float().contiguous())
    return out.reshape(B, Ho, Wo, Cout).to(x.dtype)
