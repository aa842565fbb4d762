"""Fused SAGAN attention forward: softmax(q k^T) v without the [N, M]
map in device memory.

``flash_attention_fwd`` is the boundary of the hand-written CUDA kernel
``csrc/flash_attn_fwd.cu`` (the port of
``gssd_tpu/ops/pallas/flash_attn.py`` ``_fwd_kernel``). On a CUDA tensor
it launches the kernel; on a CPU tensor it runs
``flash_attention_fwd_plain``, the same arithmetic in plain PyTorch:
unscaled f32 logits, f32 softmax, P normalised in f32 and rounded to
bf16, P.V accumulated in f32. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gssd_torch.ops.kernels.build import CudaKernel

# largest key count the JAX package sends to its fused kernel
# (flash_eligible); beyond it SelfAttention takes the plain path
MAX_M = 8192

KERNEL = CudaKernel(
    "flash_attn_fwd.cu", "flash_attn_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)


def flash_eligible(m: int) -> bool:
    return m <= MAX_M


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


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q @ k^T) @ v for q [B, N, dk], k [B, M, dk], v [B, M, dv]
    in q's dtype; the inputs are rounded to bf16 first."""
    def prep(t):
        return t.to(torch.bfloat16).contiguous()

    o, _ = flash_attention_fwd(prep(q), prep(k), prep(v))
    return o.to(q.dtype)
