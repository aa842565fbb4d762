"""The wide-spatial, narrow-channel 3x3 conv of the stem (conv1_1,
conv1_2), forward and backward, through the hand-written CUDA kernels
``csrc/stem_conv_fwd.cu`` and ``csrc/stem_conv_bwd.cu`` (the ports of
``gssd_tpu/ops/pallas/stem_conv.py`` ``_fwd_kernel`` and ``_bwd_kernel``,
which the JAX package reaches through ``USE_PALLAS_WIDE_CONV``).

``stem_conv_fwd`` and ``stem_conv_bwd`` are the kernel boundaries. On
CUDA tensors they launch the kernels; on CPU tensors they run
``stem_conv_fwd_plain`` and ``stem_conv_bwd_plain``, the same arithmetic
as f32 ``F.conv2d`` on bf16-rounded operands. ``stem_conv`` joins them in
a ``torch.autograd.Function`` over the port's f32 grouped parameters.

The function is ``conv3x3_wide`` (a 3x3, stride 1, zero "same" padding
conv) on the port's NCHW tensors with grouped weights [Cout, Cin/G, 3,
3]:

- forward: the patches rounded to bf16, the weights in the compute dtype
  (x's dtype), f32 accumulation, the f32 bias added to the f32 sum, one
  rounding to x's dtype (the plain grouped conv of ``ConvBNRelu`` rounds
  the conv to the compute dtype and adds a rounded bias: other numbers).
  The kernel multiplies bf16 operands on the tensor cores: f32 weights
  reach it as three bf16 parts (``split_bf16``) that sum back to w
  exactly, so an f32 forward differs from the plain version only in the
  order of its f32 sums (``STEM_F32_MEAN_TOL`` holds it to that, read by
  ``f32_mean_err``; ``stem_conv_fwd_split`` emulates the kernel with any
  number of parts);
- backward: g and the flipped, transposed weights rounded to bf16 (also
  in an f32 model); dx is their conv (the forward's kernel, one part, no
  bias), f32-accumulated and rounded to x's dtype, skipped when autograd
  does not need it; dW is the f32 sum over
  (b, y, x) of bf16 patches times bf16 g and reaches the f32 parameter
  unrounded; db = sum of f32(g), outside the kernel. The kernels run both
  products on the tensor cores (bf16 operands, f32 sums) and sum every
  output in a fixed order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gssd_torch.ops.kernels.build import CudaKernel
from gssd_torch.ops.kernels.flash_contract import split_bf16

# one launch = the weights' packing and the conv
FWD_KERNEL = CudaKernel(
    "stem_conv_fwd.cu", "stem_conv_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8)
# one launch = the dx weights' packing and the conv kernel for dx (when
# asked for), the dW partial sums and their reduction, in order
BWD_KERNEL = CudaKernel(
    "stem_conv_bwd.cu", "stem_conv_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9)
# channels a group in and out of the conv kernel (forward and dx: its
# accumulators and staged rows; ConvBNRelu's wide-conv gate keeps both
# <= 64)
MAX_GROUP = 64
# the f32 forward's contract: mean |y - y64| / mean |y64| against the
# function in f64 (``stem_conv_fwd_f64``). On the card the kernel reads
# ~5-7e-8 at the stem's channels (cuDNN's f32 conv 0.7-1.8e-7), a two-part
# split (``stem_conv_fwd_split(..., parts=2)``) ~2e-6; on the CPU the
# three-part emulation 4-6e-8, two parts 1.7-2.1e-6 (PERF.md §6)
STEM_F32_MEAN_TOL = 3e-7

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# dW: rows per pixel tile of the partial-sum kernel, and the number of
# blocks a launch aims for (a few per SM of an H100's 132)
_DW_TILE_ROWS = 8
_DW_TARGET_BLOCKS = 528


def _flipped_transposed(w: torch.Tensor, groups: int) -> torch.Tensor:
    """[Cout, Cin/G, 3, 3] -> the dx weights [Cin, Cout/G, 3, 3] in bf16:
    wt[g*Cgi + ci, j, ky, kx] = w[g*Cgo + j, ci, 2 - ky, 2 - kx]."""
    cout, cgi = w.shape[0], w.shape[1]
    wt = w.reshape(groups, cout // groups, cgi, 3, 3).transpose(1, 2)
    return wt.reshape(groups * cgi, cout // groups, 3, 3).flip(2, 3).to(torch.bfloat16)


def stem_conv_fwd_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: an f32 conv of bf16(x)
    with w (as given), plus the f32 bias, rounded once to x's dtype."""
    y = F.conv2d(x.to(torch.bfloat16).float(), w.float(), None, padding=1, groups=groups)
    return (y + bias.float()[None, :, None, None]).to(x.dtype)


def stem_conv_fwd_split(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, groups: int,
                        parts: int) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch: f32 convs of
    bf16(x) with each of ``parts`` bf16 parts of w (``split_bf16``), added
    in f32 in order, plus the f32 bias, rounded once to x's dtype. Three
    parts keep the contract of an f32 forward; two break it."""
    xb = x.to(torch.bfloat16).float()
    y = None
    for part in split_bf16(w, parts):
        c = F.conv2d(xb, part.float(), None, padding=1, groups=groups)
        y = c if y is None else y + c
    return (y + bias.float()[None, :, None, None]).to(x.dtype)


def stem_conv_fwd_f64(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """The forward's function in f64: the conv of bf16(x) with w plus the
    bias, unrounded (the reference of ``STEM_F32_MEAN_TOL``)."""
    y = F.conv2d(x.to(torch.bfloat16).double(), w.double(), None, padding=1, groups=groups)
    return y + bias.double()[None, :, None, None]


def f32_mean_err(y: torch.Tensor, y64: torch.Tensor) -> float:
    """mean |y - y64| / mean |y64| in f64: the f32 forward's contract
    reading against ``stem_conv_fwd_f64``."""
    return ((y.double() - y64).abs().mean() / y64.abs().mean()).item()


# the plain dW: the unfolded patches it holds at once (f32 elements, 128
# MB), and the pixels one product sums (its partial sums are then added
# by torch.sum)
_DW_PLAIN_ELEMS = 2**25
_DW_PLAIN_PIXELS = 4096


def stem_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, groups: int) -> torch.Tensor:
    """dW [Cout, Cin/G, 3, 3] f32 = the sum over (b, y, x) of bf16(x)'s 3x3
    patches times bf16(g), in f32: per chunk of images the unfolded
    patches [G, Cin/G * 9, pixels] times g [G, pixels, Cout/G] as
    products of _DW_PLAIN_PIXELS pixels each, their partial sums added by
    ``torch.sum``, the chunks' sums added in order. (cuDNN's f32 weight
    gradient, TF32 off, deterministic or not, reads 1.46e-4 of max from
    the sum in f64 at 64 -> 64 channels ungrouped, batch 32, 300 x 300;
    these products 5.3e-7 to 7.1e-7 at the four FSSD stem sites:
    ``tools/stem_dw_witness.py``, PERF.md §6, PR 14.)"""
    B, Cin, H, W = x.shape
    cout, cg = g.shape[1], Cin // groups
    step = max(1, _DW_PLAIN_ELEMS // (Cin * 9 * H * W))
    dw = torch.zeros(groups, cg * 9, cout // groups, dtype=torch.float32, device=x.device)
    for i in range(0, B, step):
        n = min(step, B - i)
        pad = -(n * H * W) % _DW_PLAIN_PIXELS  # zero pixels add nothing
        p = F.unfold(x[i:i + n].to(torch.bfloat16).float(), 3, padding=1)  # [n, Cin 9, HW]
        p = p.reshape(n, groups, cg * 9, H * W).permute(1, 2, 0, 3).reshape(groups, cg * 9, -1)
        p = F.pad(p, (0, pad)).reshape(groups, cg * 9, -1, _DW_PLAIN_PIXELS).transpose(1, 2)
        gb = g[i:i + n].to(torch.bfloat16).float().reshape(n, groups, cout // groups, H * W)
        gb = gb.permute(1, 0, 3, 2).reshape(groups, n * H * W, cout // groups)
        gb = F.pad(gb, (0, 0, 0, pad)).reshape(groups, -1, _DW_PLAIN_PIXELS, cout // groups)
        dw += torch.matmul(p, gb).sum(dim=1)
    return dw.permute(0, 2, 1).reshape(cout, cg, 3, 3)


def stem_conv_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, groups: int,
                        need_dx: bool = True
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of the backward kernels -> (dx in x's dtype
    or None, dW [Cout, Cin/G, 3, 3] f32), from bf16(g), bf16(x) and the
    bf16 flipped, transposed weights, in f32 (dW: ``stem_conv_dw_plain``)."""
    dx = None
    if need_dx:
        wt = _flipped_transposed(w, groups).float()
        dx = F.conv2d(g.to(torch.bfloat16).float(), wt, None, padding=1,
                      groups=groups).to(x.dtype)
    return dx, stem_conv_dw_plain(x, g, groups)


def _check(fn: str, x: torch.Tensor, w: torch.Tensor, groups: int,
           extra: Tuple[Tuple[str, torch.Tensor, torch.dtype, tuple], ...]):
    """Validate a boundary's inputs; returns (B, Cin, Cout, H, W)."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"{fn}: x must be [B, Cin, H, W] and w [Cout, Cin/G, 3, 3], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    if groups < 1 or Cin % groups or Cout % groups or w.shape[1] * groups != Cin:
        raise ValueError(f"{fn}: {Cin} -> {Cout} channels do not split into {groups} groups "
                         f"of w {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn}: x must be bfloat16 or float32, got {x.dtype}")
    for name, t, dt, shape in (("x", x, x.dtype, tuple(x.shape)),) + extra:
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous (NCHW)")
        if t.device != x.device:
            raise ValueError(f"{fn}: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return B, Cin, Cout, H, W


def _aligned(fn, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn}: inputs must be 16-byte aligned")


def stem_conv_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """x [B, Cin, H, W] bf16 or f32; w [Cout, Cin/G, 3, 3] in x's dtype;
    bias [Cout] f32; all contiguous -> [B, Cout, H, W] in x's dtype. The
    kernel takes Cin/G and Cout/G up to ``MAX_GROUP``; f32 weights go to
    it as three bf16 parts."""
    B, Cin, Cout, H, W = _check("stem_conv_fwd", x, w, groups, (
        ("w", w, x.dtype, tuple(w.shape)), ("bias", bias, torch.float32, (w.shape[0],))))
    if x.device.type == "cpu":
        return stem_conv_fwd_plain(x, w, bias, groups)
    if max(Cin, Cout) // groups > MAX_GROUP:
        raise ValueError(f"stem_conv_fwd: the kernel takes at most {MAX_GROUP} channels a "
                         f"group, got {Cin // groups} -> {Cout // groups}")
    parts = 1 if x.dtype == torch.bfloat16 else 3
    wparts = w if parts == 1 else torch.stack(split_bf16(w, parts))
    _aligned("stem_conv_fwd", x, wparts, bias)
    wpack = torch.empty(FWD_KERNEL.query("wpack_elems", Cin, Cout, groups, parts),
                        dtype=torch.bfloat16, device=x.device)
    out = torch.empty(B, Cout, H, W, dtype=x.dtype, device=x.device)
    FWD_KERNEL.launch(torch.cuda.current_stream(x.device).cuda_stream,
                      x.data_ptr(), wparts.data_ptr(), bias.data_ptr(), wpack.data_ptr(),
                      out.data_ptr(), B, Cin, Cout, groups, H, W, _DTYPE_CODE[x.dtype], parts)
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_bands(B: int, H: int, blocks_per_band: int) -> Tuple[int, int]:
    """(rows per band, bands) of the dW partial sums: about
    _DW_TARGET_BLOCKS blocks in all, whole pixel tiles per band."""
    want = max(1, min(_cdiv(_DW_TARGET_BLOCKS, B * blocks_per_band),
                      _cdiv(H, _DW_TILE_ROWS)))
    rows = _cdiv(_cdiv(H, want), _DW_TILE_ROWS) * _DW_TILE_ROWS
    return rows, _cdiv(H, rows)


def stem_conv_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, groups: int,
                  need_dx: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """x [B, Cin, H, W] (the forward's input) and g [B, Cout, H, W] (the
    output gradient) of one dtype, bf16 or f32; w [Cout, Cin/G, 3, 3] any
    float dtype; all contiguous -> (dx [B, Cin, H, W] in x's dtype, or
    None without ``need_dx``; dW [Cout, Cin/G, 3, 3] f32)."""
    B, Cin, Cout, H, W = _check("stem_conv_bwd", x, w, groups, (
        ("w", w, w.dtype, tuple(w.shape)),
        ("g", g, x.dtype, (x.shape[0], w.shape[0], x.shape[2], x.shape[3]))))
    if x.device.type == "cpu":
        return stem_conv_bwd_plain(x, w, g, groups, need_dx)
    wt = _flipped_transposed(w, groups).contiguous()
    _aligned("stem_conv_bwd", x, g, wt)
    dev = x.device
    cgi, cgo = Cin // groups, Cout // groups
    if need_dx and max(cgi, cgo) > MAX_GROUP:
        raise ValueError(f"stem_conv_bwd: the dx kernel takes at most {MAX_GROUP} channels "
                         f"a group, got {cgi} -> {cgo}")
    rows, bands = dw_bands(B, H, groups * _cdiv(cgi, 16) * _cdiv(cgo, 16))
    part = torch.empty(bands * B, Cout, cgi, 9, dtype=torch.float32, device=dev)
    dw = torch.empty(Cout, cgi, 3, 3, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    # the dx weights, packed in the mma fragments' order
    wpack = torch.empty(BWD_KERNEL.query("wpack_elems", Cin, Cout, groups) if need_dx else 0,
                        dtype=torch.bfloat16, device=dev)
    BWD_KERNEL.launch(torch.cuda.current_stream(dev).cuda_stream,
                      x.data_ptr(), g.data_ptr(), wt.data_ptr(),
                      dx.data_ptr() if need_dx else None, wpack.data_ptr(), part.data_ptr(),
                      dw.data_ptr(), B, Cin, Cout, groups, H, W, rows, bands,
                      _DTYPE_CODE[x.dtype])
    return dx, dw


class StemConv(torch.autograd.Function):
    """y = stem_conv_fwd(x, w in x's dtype, bias) for the f32 parameters w
    [Cout, Cin/G, 3, 3] and bias [Cout]; the backward returns the f32 dW
    of ``stem_conv_bwd`` and db = sum of f32(g) for them, and dx only
    where x needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, bias, groups):
        ctx.groups = groups
        ctx.save_for_backward(x, w)
        return stem_conv_fwd(x, w.to(x.dtype).contiguous(), bias.float().contiguous(), groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx, dw = stem_conv_bwd(x, w, g, ctx.groups, need_dx=ctx.needs_input_grad[0])
        return dx, dw, g.float().sum(dim=(0, 2, 3)), None


def stem_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              groups: int) -> torch.Tensor:
    """3x3 / stride 1 / same conv of NCHW ``x`` (bf16 or f32) with the
    grouped f32 ``weight`` [Cout, Cin/G, 3, 3] and f32 ``bias`` through
    the stem kernels; differentiable in all three."""
    return StemConv.apply(x.contiguous(), weight, bias, groups)
