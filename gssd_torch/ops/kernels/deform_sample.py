"""Modulated deformable sampling as separable dense contractions, and the
deformable conv built on it (``dcn_impl='pallas'``).

Bilinear sampling at (py, px) is a rank-1 separable contraction with hat
weights:

    sampled[p, c] = sum_qy sum_qx A[p, qy] * B[p, qx] * x[qy, qx, c]
    A[p, qy] = max(0, 1 - |py[p] - qy|) * m[p],   B[p, qx] = max(0, 1 - |px[p] - qx|)

``abx_fwd``, ``abx_dx`` and ``abx_dab`` are the boundaries of the
hand-written CUDA kernels ``csrc/deform_sample_fwd.cu``,
``csrc/deform_sample_dx.cu`` and ``csrc/deform_sample_dab.cu``, the ports
of ``gssd_tpu/ops/pallas/deform_sample.py`` ``_fwd_kernel``,
``_dx_kernel`` and ``_dab_kernel``. On CUDA tensors they launch the
kernels; on CPU tensors they run the ``*_plain`` versions beside them,
the same arithmetic in plain PyTorch. Their roundings are the TPU
kernels':

- fwd: A, B, x in bf16; T = A . x[:, qx] accumulated in f32, times the
  bf16 B in f32, summed over qx in f32 (the caller rounds to x's dtype;
  the kernel adds only the terms inside each hat row's non-zero range,
  multiply and add separate: the plain version's bits at hat rows);
- dx: A, B, g in bf16; every term A * (B * g) in f32, where it is exact;
  f32 output (the kernel adds only the terms inside each hat row's
  non-zero range, in ascending p: the dense sum's bits for finite
  inputs);
- dab: dA = sum bf16(B * g) . x and dB = sum bf16(A * g) . x with bf16 x
  and f32 accumulation; f32 outputs (the kernel sorts the pixels by the
  first non-zero of their hat row and walks only the columns their rows
  reach, on the tensor cores).

Every kernel reads the hat rows' non-zero ranges from a first pass
(``csrc/hat_ranges.cuh``) and takes any H and W.

``abx_sample`` joins them in a ``torch.autograd.Function`` at the (A, B,
xg) boundary, as the JAX ``custom_vjp`` does; the chain back to the
offsets and mask runs through ``hat_weights``, whose derivative is JAX's
autodiff of ``max(0, 1 - |pos - q|)`` (see ``HatWeights``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from gssd_torch.ops.kernels.build import CudaKernel

# one launch = the hat rows' non-zero ranges, then the sample kernel
FWD_KERNEL = CudaKernel(
    "deform_sample_fwd.cu", "deform_sample_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
# one launch = the hat rows' non-zero ranges, then dx over them
DX_KERNEL = CudaKernel(
    "deform_sample_dx.cu", "deform_sample_dx",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
# one launch = the ranges, the pixels' buckets, the dA pass, the dB pass
DAB_KERNEL = CudaKernel(
    "deform_sample_dab.cu", "deform_sample_dab",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5)

_BF16 = torch.bfloat16


def abx_fwd_plain(a, b, x):
    """Plain PyTorch version of the forward kernel: a [N, G, P, H], b [N,
    G, P, W], x [N, G, H, W, Cg] bf16 -> [N, G, P, Cg] f32. Products of
    bf16 values are exact in f32, so f32 matmuls give the bf16 products
    with f32 accumulation."""
    af, bf, xf = a.float(), b.float(), x.float()
    out = torch.zeros(*a.shape[:3], x.shape[-1], dtype=torch.float32, device=a.device)
    for qx in range(x.shape[3]):
        out = out + bf[..., qx, None] * torch.matmul(af, xf[:, :, :, qx])
    return out


def abx_dx_plain(a, b, g):
    """Plain PyTorch version of the dx kernel: a [N, G, P, H], b [N, G, P,
    W], g [N, G, P, Cg] bf16 -> dx [N, G, H, W, Cg] f32 = sum_p a (b g)."""
    af, bf, gf = a.float(), b.float(), g.float()
    N, G, P, H = a.shape
    W = b.shape[-1]
    out = torch.empty(N, G, H, W, g.shape[-1], dtype=torch.float32, device=a.device)
    for qx in range(W):
        out[:, :, :, qx] = torch.matmul(af.transpose(-1, -2), bf[..., qx, None] * gf)
    return out


def abx_dab_plain(x, g, a, b):
    """Plain PyTorch version of the dA/dB kernel: x [N, G, H, W, Cg], g
    [N, G, P, Cg], a [N, G, P, H], b [N, G, P, W] bf16 -> (dA [N, G, P,
    H], dB [N, G, P, W]) f32, dA = sum_{qx, c} bf16(b g) x and dB =
    sum_{qy, c} bf16(a g) x."""
    xf, gf, af, bf = x.float(), g.float(), a.float(), b.float()
    da = torch.zeros_like(af)
    db = torch.zeros_like(bf)
    for qx in range(x.shape[3]):
        e = (bf[..., qx, None] * gf).to(_BF16).float()
        da = da + torch.matmul(e, xf[:, :, :, qx].transpose(-1, -2))
    for qy in range(x.shape[2]):
        f = (af[..., qy, None] * gf).to(_BF16).float()
        db = db + torch.matmul(f, xf[:, :, qy].transpose(-1, -2))
    return da, db


def _check(fn, a, b, x=None, g=None):
    """Validate a kernel boundary's inputs: a [N, G, P, H], b [N, G, P, W]
    and x [N, G, H, W, Cg] and/or g [N, G, P, Cg], all bf16, contiguous, on
    one device; on the card also the kernels' limits (C/G a multiple of 8,
    N * G <= 65535, 16-byte aligned). Returns (N, G, P, H, W, Cg)."""
    if a.dim() != 4 or b.dim() != 4:
        raise ValueError(f"{fn}: A and B must be [N, G, P, n], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    N, G, P, H = a.shape
    W = b.shape[-1]
    Cg = (x if x is not None else g).shape[-1]
    named = [("A", a, (N, G, P, H)), ("B", b, (N, G, P, W))]
    if x is not None:
        named.append(("x", x, (N, G, H, W, Cg)))
    if g is not None:
        named.append(("g", g, (N, G, P, Cg)))
    for name, t, shape in named:
        if t.dtype != _BF16:
            raise TypeError(f"{fn}: {name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"{fn}: inputs on different devices")
    dev = a.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {a.device}")
    if dev == "cuda":
        if Cg % 8 or N * G > 65535:
            raise ValueError(f"{fn}: the kernel takes C/G a multiple of 8 and N * G <= 65535, "
                             f"got C/G={Cg}, N * G={N * G}")
        if any(t.data_ptr() % 16 for _, t, _ in named):
            raise ValueError(f"{fn}: inputs must be 16-byte aligned")
    return N, G, P, H, W, Cg


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def abx_fwd(a, b, x):
    """a [N, G, P, H], b [N, G, P, W], x [N, G, H, W, Cg] bf16 ->
    sampled [N, G, P, Cg] f32."""
    N, G, P, H, W, Cg = _check("abx_fwd", a, b, x=x)
    if a.device.type == "cpu":
        return abx_fwd_plain(a, b, x)
    out = torch.empty(N, G, P, Cg, dtype=torch.float32, device=a.device)
    # (first, last) non-zero index of each A and B row
    ranges = torch.empty(N, G, P, 4, dtype=torch.int32, device=a.device)
    FWD_KERNEL.launch(_stream(a), a.data_ptr(), b.data_ptr(), x.data_ptr(), out.data_ptr(),
                      ranges.data_ptr(), N * G, P, H, W, Cg)
    return out


def abx_dx(a, b, g):
    """a [N, G, P, H], b [N, G, P, W], g [N, G, P, Cg] bf16 -> dx [N, G,
    H, W, Cg] f32."""
    N, G, P, H, W, Cg = _check("abx_dx", a, b, g=g)
    if a.device.type == "cpu":
        return abx_dx_plain(a, b, g)
    out = torch.empty(N, G, H, W, Cg, dtype=torch.float32, device=a.device)
    # (first, last) non-zero index of each A and B row
    ranges = torch.empty(N, G, P, 4, dtype=torch.int32, device=a.device)
    DX_KERNEL.launch(_stream(a), a.data_ptr(), b.data_ptr(), g.data_ptr(), out.data_ptr(),
                     ranges.data_ptr(), N * G, P, H, W, Cg)
    return out


def abx_dab(x, g, a, b):
    """x [N, G, H, W, Cg], g [N, G, P, Cg], a [N, G, P, H], b [N, G, P, W]
    bf16 -> (dA [N, G, P, H], dB [N, G, P, W]) f32."""
    N, G, P, H, W, Cg = _check("abx_dab", a, b, x=x, g=g)
    if a.device.type == "cpu":
        return abx_dab_plain(x, g, a, b)
    da = torch.empty(N, G, P, H, dtype=torch.float32, device=a.device)
    db = torch.empty(N, G, P, W, dtype=torch.float32, device=a.device)
    ranges = torch.empty(N, G, P, 4, dtype=torch.int32, device=a.device)
    # per pass and (n, g): the pixels in bucket order, their tiles and the
    # bucket counts, sized by the kernel's library
    buckets = torch.empty(DAB_KERNEL.query("scratch_ints", N * G, P, H, W), dtype=torch.int32,
                          device=a.device)
    DAB_KERNEL.launch(_stream(a), *(t.data_ptr() for t in (x, g, a, b, da, db, ranges, buckets)),
                      N * G, P, H, W, Cg)
    return da, db


def _bf16(t):
    return t.to(_BF16).contiguous()


class AbxSample(torch.autograd.Function):
    """sampled = abx_fwd(A, B, xg) in xg's dtype; the backward takes dx
    from ``abx_dx`` and dA, dB from ``abx_dab`` (one launch each), in the
    dtypes of xg, A and B."""

    @staticmethod
    def forward(ctx, A, B, xg):
        a, b, x = _bf16(A), _bf16(B), _bf16(xg)
        ctx.save_for_backward(a, b, x)
        ctx.dtypes = (A.dtype, B.dtype, xg.dtype)
        return abx_fwd(a, b, x).to(xg.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        gb = _bf16(g)
        dx = abx_dx(a, b, gb)
        da, db = abx_dab(x, gb, a, b)
        ta, tb, tx = ctx.dtypes
        return da.to(ta), db.to(tb), dx.to(tx)


def abx_sample(A, B, xg):
    """A [N, G, P, H], B [N, G, P, W], xg [N, G, H, W, Cg] -> sampled [N,
    G, P, Cg] in xg's dtype. Differentiable in all three."""
    return AbxSample.apply(A, B, xg)


class HatWeights(torch.autograd.Function):
    """hat[..., q] = max(0, 1 - |pos - q|) for q in 0..n-1, with JAX's
    derivative of that expression: d|d|/dd = 1 at d = 0 (jnp.abs) and a
    tie of jnp.maximum at 1 - |d| = 0 split in half. At an integer pos
    the derivative is -1 at q = pos, -0.5 at pos - 1 and +0.5 at pos + 1
    (torch's abs and clamp would give other values there)."""

    @staticmethod
    def forward(ctx, pos, n):
        d = pos[..., None] - torch.arange(n, dtype=pos.dtype, device=pos.device)
        ctx.save_for_backward(d)
        return torch.clamp(1.0 - d.abs(), min=0.0)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        z = 1.0 - d.abs()
        dmax = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
        sign = torch.where(d >= 0, 1.0, -1.0)
        return (g * dmax * -sign).sum(-1), None


def hat_weights(pos, n: int):
    """Dense bilinear hat weights: [..., P] positions -> [..., P, n]."""
    return HatWeights.apply(pos, n)


def deform_conv2d_pallas(x, offset_y, offset_x, mask, weight, bias,
                         stride=1, padding=1, dilation=1):
    """``deform_conv2d``'s contract computed with the separable sampler:
    x [N, H, W, C]; offsets and mask [N, Ho, Wo, G, K]; weight [K, C,
    Cout]; bias [Cout] -> [N, Ho, Wo, Cout] in x's dtype. Per tap: the
    mask folded into A, the sample in x's dtype, its product with the tap
    weight (rounded to the sample's dtype) in f32, taps summed in f32,
    then the bias. Stride 1 only, as in the JAX package."""
    if stride != 1:
        raise ValueError("deform_conv2d_pallas supports stride 1 only")
    N, H, W, C = x.shape
    K = weight.shape[0]
    kw = math.isqrt(K)
    _, Ho, Wo, G, _ = mask.shape
    Cg, P = C // G, Ho * Wo
    dev = x.device
    base_y = (torch.arange(Ho, dtype=torch.float32, device=dev) - padding)[None, :, None, None]
    base_x = (torch.arange(Wo, dtype=torch.float32, device=dev) - padding)[None, None, :, None]
    xg = x.reshape(N, H, W, G, Cg).permute(0, 3, 1, 2, 4).contiguous()

    def per_group(t):  # [N, Ho, Wo, G] -> [N, G, P]
        return t.reshape(N, P, G).permute(0, 2, 1)

    out = None
    for k in range(K):
        u, v = divmod(k, kw)
        py = per_group(base_y + u * dilation + offset_y[..., k])
        px = per_group(base_x + v * dilation + offset_x[..., k])
        mk = per_group(mask[..., k])
        A = hat_weights(py, H) * mk[..., None]
        Bm = hat_weights(px, W)
        sampled = abx_sample(A, Bm, xg).permute(0, 2, 1, 3).reshape(N, P, C)
        tap = torch.matmul(sampled.float(), weight[k].to(sampled.dtype).float())
        out = tap if out is None else out + tap
    out = out + bias.float()
    return out.reshape(N, Ho, Wo, -1).to(x.dtype)
