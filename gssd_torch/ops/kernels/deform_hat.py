"""Modulated deformable conv (DCNv2) through the hand-written CUDA
kernels ``csrc/deform_conv_fwd.cu`` and ``csrc/deform_conv_bwd.cu``, the
ports of ``gssd_tpu/ops/pallas/deform_hat.py`` (the forward kernels
behind ``deform_conv2d_hat`` and the backward kernels of ``hat_bwd``).

``deform_conv_fwd`` and ``deform_conv_bwd`` are the kernel boundaries.
On CUDA tensors they launch the kernels; on CPU tensors they run
``deform_conv_fwd_plain`` and ``deform_conv_bwd_plain``, the same
arithmetic in plain PyTorch. ``deform_conv2d_hat`` keeps the JAX entry
point's contract, prepares the kernels' inputs as it does (absolute f32
sample coordinates, bf16 input and bf16 weights regrouped per deformable
group) and joins the two boundaries in a ``torch.autograd.Function``;
the chain back to the offsets, mask, input and weight casts stays with
autograd. ``dcn_contract.py`` holds the kernels to the plain versions'
roundings.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gssd_torch.ops.kernels.build import CudaKernel

KERNEL = CudaKernel(
    "deform_conv_fwd.cu", "deform_conv_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9)
# one launch = dU with the corner terms and the samples, dx (the samples
# bucketed by corner cell, then one fixed-order gather per element), the
# dW partials over splits of B*P and their sum
BWD_KERNEL = CudaKernel(
    "deform_conv_bwd.cu", "deform_conv_bwd",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10)
# the backward's dx gather holds C/G / 64 channel pairs a lane in registers
MAX_CG = 512
# the backward's dW blocks: 128 channels x up to 256 Cout columns, over
# 64-pixel chunks; enough splits of B*P for DW_WAVES blocks an SM
DW_WAVES = 4
# the most 64-pixel chunks one dW split sums in one chain of wgmmas (None:
# no cap). On the H100 the chain's f32 sums drift from the contract in
# f64 in proportion to its length, ~1.2e-9 of mean |dW| a pixel, where
# the plain version's stay within ~1.6e-6 (``tools/dw_witness.py``:
# 3.8e-5 at 64x64, batch 32, 4 splits; 5.1e-6 at this cap, 32 splits, in
# about the same time); the partials are added in split order in f32.
DW_MAX_CHUNKS = 64


def deform_conv_fwd_plain(x, py, px, m, wg, bias):
    """Plain PyTorch version of the kernel: for each tap, blend the four
    corners of bf16 ``x`` with the corner weights bf16(ay*bx*m) (f32 hat
    weights times the mask, rounded as the TPU kernel rounds them; a
    corner outside the map is 0), round the sample to bf16, contract it
    with the bf16 weights in f32, then add the bias."""
    return fwd_rounded(x, py, px, m, wg, bias)


def fwd_rounded(x, py, px, m, wg, bias, round_w=True, round_samp=True):
    """``deform_conv_fwd_plain`` with each of its roundings as a switch
    (``dcn_contract`` turns one off to plant a fault)."""
    B, H, W, C = x.shape
    _, P, G, K = py.shape
    Cg = C // G
    xf = x.float().reshape(B, H * W, G, Cg)
    y0, x0 = torch.floor(py), torch.floor(px)
    out = torch.zeros(B, P, wg.shape[-1], dtype=torch.float32, device=x.device)
    for k in range(K):
        samp = torch.zeros(B, P, G, Cg, dtype=torch.float32, device=x.device)
        for dy in (0, 1):
            for dx in (0, 1):
                yy = y0[..., k] + dy
                xx = x0[..., k] + dx
                inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                s = _hat(py[..., k], yy) * _hat(px[..., k], xx) * m[..., k]
                w = torch.where(inb, _bf16(s, round_w), 0.0)
                idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
                vals = torch.gather(xf, 1, idx[..., None].expand(B, P, G, Cg))
                samp = samp + w[..., None] * vals
        samp = _bf16(samp, round_samp).reshape(B, P, C)
        out = out + samp @ wg[:, k].float().reshape(C, -1)
    return out + bias


def _bf16(t, on=True):
    """``t`` rounded to bf16 and back to f32 (or as it is, ``on`` off)."""
    return t.to(torch.bfloat16).float() if on else t.float()


def _check(fn, x, py, px, m, wg, extra_name, extra):
    """Validate the inputs of a kernel boundary: the shared ones and
    ``extra``, the forward's bias [Cout] or the backward's g [B, P,
    Cout]. Returns (B, H, W, C, P, G, K, Cout)."""
    B, H, W, C = x.shape
    if py.dim() != 4:
        raise ValueError(f"{fn}: py must be [B, P, G, K], got {tuple(py.shape)}")
    _, P, G, K = py.shape
    Cout = wg.shape[-1]
    extra_shape = {"bias": (Cout,), "g": (B, P, Cout)}[extra_name]
    for name, t, dt, shape in (
        ("x", x, torch.bfloat16, (B, H, W, C)),
        ("py", py, torch.float32, (B, P, G, K)),
        ("px", px, torch.float32, (B, P, G, K)),
        ("m", m, torch.float32, (B, P, G, K)),
        ("wg", wg, torch.bfloat16, (G, K, C // G, Cout)),
        (extra_name, extra, torch.float32, extra_shape),
    ):
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{fn}: inputs on different devices")
    if C % G:
        raise ValueError(f"{fn}: C={C} is not a multiple of G={G}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.device.type == "cuda" and (C // G) % 2:
        raise ValueError(f"{fn}: the kernel takes an even C/G, got {C // G}")
    return B, H, W, C, P, G, K, Cout


def deform_conv_fwd(x, py, px, m, wg, bias):
    """x [B, H, W, C] bf16; py, px, m [B, P, G, K] f32 (absolute sample
    coordinates and modulation); wg [G, K, C/G, Cout] bf16; bias [Cout]
    f32 -> out [B, P, Cout] f32. All contiguous."""
    B, H, W, C, P, G, K, Cout = _check("deform_conv_fwd", x, py, px, m, wg, "bias", bias)
    if x.device.type == "cpu":
        return deform_conv_fwd_plain(x, py, px, m, wg, bias)
    if any(t.data_ptr() % 16 for t in (x, py, px, m, wg, bias)):
        raise ValueError("deform_conv_fwd: inputs must be 16-byte aligned")
    wg, cout8 = _pad_cols(wg)
    out = torch.empty(B, P, Cout, dtype=torch.float32, device=x.device)
    KERNEL.launch(torch.cuda.current_stream(x.device).cuda_stream,
                  *(t.data_ptr() for t in (x, py, px, m, wg, bias, out)),
                  B, H, W, C, G, K, P, Cout, cout8)
    return out


def _pad_cols(t):
    """``t`` with its last dimension zero-padded to a multiple of 8 (TMA
    reads rows of 16-byte multiples; a copy only where Cout is ragged),
    and that width."""
    n = t.shape[-1]
    n8 = -(-n // 8) * 8
    return (t if n8 == n else F.pad(t, (0, n8 - n)).contiguous()), n8


def _hat(p, q):
    """Bilinear hat weight max(0, 1 - |p - q|) in f32, as the TPU kernel
    builds it."""
    return torch.clamp(1.0 - (p - q).abs(), min=0.0)


def deform_conv_bwd_plain(x, py, px, m, wg, g):
    """Plain PyTorch version of the backward kernel (``hat_bwd``): per
    tap, dU = bf16(bf16(g) . W_k^T); per corner q inside the map, dS =
    <dU, x[q]>, dm += dS*ay*bx, dpy += m*dS*day*bx, dpx += m*dS*ay*dbx
    (day, dbx = -1 at the floor, +1 above it), dx[q] += bf16(ay*bx*m)*dU,
    samp += bf16(ay*bx*m)*x[q]; dW_k = bf16(samp)^T . bf16(g). dx and dW
    are rounded to bf16."""
    dpy, dpx, dm, dx, dw = deform_conv_bwd_f32(x, py, px, m, wg, g)
    return dpy, dpx, dm, dx.to(torch.bfloat16), dw.to(torch.bfloat16)


def deform_conv_bwd_f32(x, py, px, m, wg, g):
    """``deform_conv_bwd_plain`` before dx and dW are rounded to bf16."""
    return bwd_rounded(x, py, px, m, wg, g)


def bwd_rounded(x, py, px, m, wg, g, round_w=True, round_g=True, round_du=True,
                round_samp=True):
    """``deform_conv_bwd_f32`` with each of its roundings as a switch
    (``dcn_contract`` turns one off to plant a fault): the corner
    weights, g before the dU and dW products, dU before dS and dx, the
    sample before dW."""
    B, H, W, C = x.shape
    _, P, G, K = py.shape
    Cg = C // G
    xf = x.float().reshape(B, H * W, G, Cg)
    gb = _bf16(g, round_g)
    y0, x0 = torch.floor(py), torch.floor(px)
    dpy, dpx, dm = (torch.zeros_like(py) for _ in range(3))
    dx = torch.zeros(B, H * W, G, Cg, dtype=torch.float32, device=x.device)
    dw = torch.zeros(G, K, Cg, wg.shape[-1], dtype=torch.float32, device=x.device)
    for k in range(K):
        pyk, pxk, mk = py[..., k], px[..., k], m[..., k]
        du = _bf16(torch.einsum("bpn,gcn->bpgc", gb, wg[:, k].float()), round_du)
        samp = torch.zeros(B, P, G, Cg, dtype=torch.float32, device=x.device)
        for dy in (0, 1):
            for dxx in (0, 1):
                qy, qx = y0[..., k] + dy, x0[..., k] + dxx
                ay, bx = _hat(pyk, qy), _hat(pxk, qx)
                inb = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
                idx = (qy.clamp(0, H - 1) * W + qx.clamp(0, W - 1)).long()
                idx = idx[..., None].expand(B, P, G, Cg)
                vals = torch.gather(xf, 1, idx)
                ds = (du * vals).sum(-1)
                s0 = ay * bx
                mds = ds * mk
                zero = torch.zeros_like(ds)
                dm[..., k] += torch.where(inb, ds * s0, zero)
                dpy[..., k] += torch.where(inb, mds * (1.0 if dy else -1.0) * bx, zero)
                dpx[..., k] += torch.where(inb, mds * ay * (1.0 if dxx else -1.0), zero)
                sw = torch.where(inb, _bf16(s0 * mk, round_w), zero)
                samp = samp + sw[..., None] * vals
                dx.scatter_add_(1, idx, sw[..., None] * du)
        dw[:, k] = torch.einsum("bpgc,bpn->gcn", _bf16(samp, round_samp), gb)
    return dpy, dpx, dm, dx.reshape(B, H, W, C), dw


def dw_splits(bp, gk, cg, cout, sms, max_chunks=None):
    """How many ranges of B*P the backward's dW is split into: enough
    blocks (128 channels x up to 256 Cout columns each) for DW_WAVES a
    streaming multiprocessor, and enough that no range holds more than
    ``max_chunks`` 64-pixel chunks (no cap: None); at most one range a
    chunk."""
    chunks = -(-bp // 64)
    blocks = -(-cout // 256) * gk * -(-cg // 128)
    n = -(-DW_WAVES * sms // blocks)
    if max_chunks is not None:
        n = max(n, -(-chunks // max_chunks))
    return max(1, min(chunks, n))


def deform_conv_bwd(x, py, px, m, wg, g):
    """The gradients of ``deform_conv_fwd`` (without the bias): x, py,
    px, m, wg as there, g [B, P, Cout] f32 the output gradient -> (dpy,
    dpx, dm [B, P, G, K] f32, dx [B, H, W, C] bf16, dwg [G, K, C/G, Cout]
    bf16)."""
    B, H, W, C, P, G, K, Cout = _check("deform_conv_bwd", x, py, px, m, wg, "g", g)
    if x.device.type == "cpu":
        return deform_conv_bwd_plain(x, py, px, m, wg, g)
    if any(t.data_ptr() % 16 for t in (x, py, px, m, wg, g)):
        raise ValueError("deform_conv_bwd: inputs must be 16-byte aligned")
    if C // G > MAX_CG:
        raise ValueError(f"deform_conv_bwd: the kernel takes C/G <= {MAX_CG}, got {C // G}")
    dev = x.device
    Cg, GK, BP = C // G, G * K, B * P
    wg, cout8 = _pad_cols(wg)
    gb, _ = _pad_cols(g.to(torch.bfloat16).reshape(BP, Cout))
    dpy, dpx, dm = (torch.empty(B, P, G, K, dtype=torch.float32, device=dev)
                    for _ in range(3))
    dx = torch.empty(B, H, W, C, dtype=torch.bfloat16, device=dev)
    dwg = torch.empty(G, K, Cg, Cout, dtype=torch.bfloat16, device=dev)
    # scratch: dU (for dx), the bf16 samples (each (g, k) slice padded to
    # 8 channels for TMA), dW's f32 partials
    du = torch.empty(B, P, G, K, Cg, dtype=torch.bfloat16, device=dev)
    samp = torch.empty(BP, GK, -(-Cg // 8) * 8, dtype=torch.bfloat16, device=dev)
    splits = dw_splits(BP, GK, Cg, Cout, torch.cuda.get_device_properties(dev).multi_processor_count,
                       DW_MAX_CHUNKS)
    part = torch.empty(splits, GK * Cg * Cout, dtype=torch.float32, device=dev)
    # dx's buckets: counts and offsets per corner cell, a total per (b, g),
    # one entry a sample
    cells = B * G * (H + 1) * (W + 1)
    buckets = torch.empty(2 * cells + 1 + B * G + B * P * G * K, dtype=torch.int32,
                          device=dev)
    BWD_KERNEL.launch(torch.cuda.current_stream(dev).cuda_stream,
                      *(t.data_ptr() for t in (x, py, px, m, wg, gb, dpy, dpx, dm, dx,
                                               dwg, du, samp, part, buckets)),
                      B, H, W, C, G, K, P, Cout, cout8, splits)
    return dpy, dpx, dm, dx, dwg


class DeformConvHat(torch.autograd.Function):
    """out = deform_conv_fwd(x, py, px, m, wg, bias) with its gradients
    from ``deform_conv_bwd``; the bias gradient is the sum of g."""

    @staticmethod
    def forward(ctx, x, py, px, m, wg, bias):
        ctx.save_for_backward(x, py, px, m, wg)
        return deform_conv_fwd(x, py, px, m, wg, bias)

    @staticmethod
    def backward(ctx, g):
        x, py, px, m, wg = ctx.saved_tensors
        g = g.float().contiguous()
        dpy, dpx, dm, dx, dwg = deform_conv_bwd(x, py, px, m, wg, g)
        return dx, dpy, dpx, dm, dwg, g.sum(dim=(0, 1))


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
    Sampling and weights in bf16, accumulation in f32. Differentiable
    in all six inputs."""
    B, H, W, C = x.shape
    K, _, Cout = weight.shape
    _, Ho, Wo, G, _ = mask.shape
    P = Ho * Wo
    py, px = sample_coords(offset_y, offset_x, stride, padding, dilation)
    # wg[g] = [K, Cg, Cout], rows ordered (k, cg) within the group
    wg = weight.reshape(K, G, C // G, Cout).permute(1, 0, 2, 3)
    out = DeformConvHat.apply(
        x.to(torch.bfloat16).contiguous(),
        py.reshape(B, P, G, K).contiguous(),
        px.reshape(B, P, G, K).contiguous(),
        mask.float().reshape(B, P, G, K).contiguous(),
        wg.to(torch.bfloat16).contiguous(),
        bias.float().contiguous())
    return out.reshape(B, Ho, Wo, Cout).to(x.dtype)
