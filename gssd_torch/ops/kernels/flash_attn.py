"""Fused SAGAN attention, softmax(q k^T) v, forward and backward without
the [N, M] map in device memory.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the boundaries
of the hand-written CUDA kernels ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` (the ports of
``gssd_tpu/ops/pallas/flash_attn.py`` ``_fwd_kernel`` and
``_bwd_kernel``). On CUDA tensors they launch the kernels; on CPU
tensors they run ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``, the same arithmetic in plain PyTorch.
They never fall back from one to the other. ``flash_attention`` joins
the two in a ``torch.autograd.Function``.

Forward: unscaled f32 logits, f32 softmax, P normalised in f32 and
rounded to bf16, P.V accumulated in f32. Backward: D = rowsum(dO * O),
P = exp(S - lse) in f32, dV = bf16(P)^T dO, dP = dO V^T, dS = P * (dP -
D) in f32, dQ = dS K and dK = dS^T Q as f32 products; the gradients are
rounded to bf16. ``flash_contract`` states this rounding contract and
the mean-error check that holds the kernels to it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gssd_torch.ops.kernels.build import CudaKernel

# largest key count the JAX package sends to its fused kernel
# (flash_eligible there: a TPU VMEM budget); the CPU keeps it, so that the
# CPU tests compare the JAX package's route. The card's kernels stream the
# keys and have no such limit.
MAX_M = 8192

KERNEL = CudaKernel(
    "flash_attn_fwd.cu", "flash_attn_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
# one launch = the backward kernel, then dq_reduce (the fixed-order sum of
# the per-key-tile dQ partials)
BWD_KERNEL = CudaKernel(
    "flash_attn_bwd.cu", "flash_attn_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6)
MAX_BWD_DV = 512


def flash_eligible(m: int, device) -> bool:
    """Whether ``SelfAttention`` sends m keys on ``device`` to the fused
    boundaries: on a CUDA device always (a shape the kernels refuse
    raises there; nothing falls back to the plain path on the card), on
    the CPU up to MAX_M keys, as the JAX package decides."""
    return torch.device(device).type == "cuda" or m <= MAX_M


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. bf16 inputs; products of
    bf16 values are exact in f32, so f32 matmuls give the bf16 dots with
    f32 accumulation."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(torch.bfloat16)
    return torch.matmul(p.float(), v.float()), lse


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be [B, L, d], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention_fwd: q, k, v on different devices")
    (b, _, dk), (bk, m, dkk), (bv, mv, _) = q.shape, k.shape, v.shape
    if not (b == bk == bv and m == mv and dk == dkk):
        raise ValueError(
            f"flash_attention_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, N, dk], k [B, M, dk], v [B, M, dv] bf16, contiguous ->
    (o [B, N, dv] f32, lse [B, N] f32)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, N, dk = q.shape
    M, dv = k.shape[1], v.shape[2]
    if dk % 16 or not 16 <= dk <= 128 or dv % 16:
        raise ValueError(
            f"flash_attention_fwd: the kernel takes dk in 16..128 and dv in "
            f"multiples of 16, got dk={dk}, dv={dv}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: inputs must be 16-byte aligned")
    o = torch.empty(B, N, dv, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, N, dtype=torch.float32, device=q.device)
    KERNEL.launch(torch.cuda.current_stream(q.device).cuda_stream,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, N, M, dk, dv)
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """Plain PyTorch version of the backward kernel: bf16 q, k, v, do;
    f32 o, lse -> (dq, dk, dv) bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    d = (dof * o).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) - lse[..., None])
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(1, 2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - d)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def flash_attention_bwd(q, k, v, o, lse, do):
    """q [B, N, dk], k [B, M, dk], v [B, M, dv], do [B, N, dv] bf16; o
    [B, N, dv], lse [B, N] f32 (the forward's outputs); all contiguous
    -> (dq, dk, dv) bf16 in the shapes of q, k, v."""
    _check(q, k, v)
    B, N, dk = q.shape
    M, dv = k.shape[1], v.shape[2]
    for name, t, dt, shape in (("o", o, torch.float32, (B, N, dv)),
                               ("lse", lse, torch.float32, (B, N)),
                               ("do", do, torch.bfloat16, (B, N, dv))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if dk % 16 or not 16 <= dk <= 128 or dv % 16 or not 16 <= dv <= MAX_BWD_DV:
        raise ValueError(
            f"flash_attention_bwd: the kernel takes dk in 16..128 and dv in "
            f"16..{MAX_BWD_DV}, multiples of 16, got dk={dk}, dv={dv}")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: inputs must be 16-byte aligned")
    # D = rowsum(f32(dO) * O), as the JAX package computes it outside its kernel
    delta = (do.float() * o).sum(dim=-1)
    # f32 dQ partials, one slot per 64-key tile (two per block of 128 keys)
    slots = 2 * -(-M // 128)
    part = torch.empty(slots, B, N, dk, dtype=torch.float32, device=q.device)
    dq = torch.empty(B, N, dk, dtype=torch.bfloat16, device=q.device)
    dk_ = torch.empty(B, M, dk, dtype=torch.bfloat16, device=q.device)
    dv_ = torch.empty(B, M, dv, dtype=torch.bfloat16, device=q.device)
    # f32 running sums of dV over its chains of 1024 queries
    dv_run = torch.empty(B, M, dv, dtype=torch.float32, device=q.device)
    BWD_KERNEL.launch(torch.cuda.current_stream(q.device).cuda_stream,
                      *(t.data_ptr() for t in (q, k, v, do, lse, delta, part, dq, dk_, dv_,
                                               dv_run)),
                      B, N, M, dk, dv, slots)
    return dq, dk_, dv_


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T) v (f32) for bf16 q, k, v through the two
    kernel boundaries; the backward takes the output gradient in bf16,
    as the JAX package's VJP does."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, g.to(torch.bfloat16).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q @ k^T) @ v for q [B, N, dk], k [B, M, dk], v [B, M, dv]
    in q's dtype; the inputs are rounded to bf16 first. Differentiable."""
    def prep(t):
        return t.to(torch.bfloat16).contiguous()

    return FlashAttention.apply(prep(q), prep(k), prep(v)).to(q.dtype)
