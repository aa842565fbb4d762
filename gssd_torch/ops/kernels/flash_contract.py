"""The rounding contract of the attention kernels, the check that guards
it, and plain emulations of the contract kept and broken.

The contract is that of ``gssd_tpu/ops/pallas/flash_attn.py``:
- forward: the softmax is normalised in f32 and THEN rounded to bf16
  for P.V (an online softmax rounds the unnormalised P and divides
  after the product: another function at the bf16 level);
- backward: dS = P * (dP - D) stays f32 into dQ = dS K and dK = dS^T Q.

A max-error check against the plain versions (``KERNEL_TOL`` = 1e-2 of
max) cannot tell the contract from its usual violations: a single bf16
flip of P already moves an output by 2^-8 of a term. A mean error over
a mean value can: ``mean_rel_err`` is mean |got - want| / mean |want|,
and ``MEAN_TOL`` holds each kernel to it, on ``contract_inputs``:
values on a grid of 1/4, so that every logit and every dP = dO V^T is
exact in f32 whatever the order of its sums. (With full-precision
inputs the logits' f32 summation order alone moves P by ~1e-6 and the
bf16 gradients by 1-2e-6 of their mean, as much as a two-part split.)
There, exact reorderings (another summation order, exp2 for exp, dS
split into three bf16 parts) read <= ~3e-7; an online softmax reads
~1e-3, a bf16 dS ~1.5e-3 and a two-part split >= ~1.3e-6
(``tests/test_torch_flash_contract.py`` on the CPU, ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` on the card).

``fwd_exact`` is the forward's contract computed exactly (f64 softmax,
P rounded once to bf16, P.V in f64), the reference ``chip_smoke.py``
holds the forward kernel to; ``bwd_exact`` is the backward's, which it
holds the backward kernel to (the plain version's f32 dQ sums over the
keys drift from it as the keys grow: 1.9e-6 of the mean at 22,500
keys, above the limit, where the kernel's fixed-order sum of per-tile
partials reads 4.2e-7; ``tools/flash_bwd_witness.py``, PERF.md). Any f32 softmax, the plain version's
too, puts the odd element of P on the other side of a bf16 rounding
boundary than the exact value; where that element is large and the
output small (few keys, small batch), that one flip moves the mean past
the limit (one row of 128 outputs at N = 16, batch 8: ~3.6e-5).

The emulations are plain PyTorch on any device: ``fwd_exp2`` and
``bwd_split(parts=3)`` keep the contract, ``fwd_online_softmax``,
``bwd_split(parts=2)`` and ``bwd_split(parts=1)`` (a bf16 dS) break it.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

# limits of mean |kernel - plain| / mean |plain| per output on contract
# inputs, at every attention site (readings in PERF.md). O and dV are
# long sums of bf16(P) products on the tensor cores; dq and dk carry dS.
MEAN_TOL = {"o": 1e-5, "dq": 1.2e-6, "dk": 1.2e-6, "dv": 1e-5}
# at small sizes one bf16 step of one element moves the mean: each
# limit allows this many steps of the largest element on top
FLIP_STEPS = 1

LOG2E = 1.0 / math.log(2.0)


def contract_inputs(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor rounded to a multiple of 1/4, in bf16: products of
    two such values are multiples of 1/16, and the sums of up to 512 of
    them that the logits and dP take stay exact in f32."""
    return tuple((t.float() * 4).round().div(4).to(torch.bfloat16) for t in tensors)


def mean_rel_err(got: torch.Tensor, want: torch.Tensor, scale: float = None) -> float:
    """mean |got - want| / mean |want| in f32, or in f64 against an f64
    ``want`` (``scale`` replaces the denominator where ``want`` is zero
    in exact arithmetic)."""
    dtype = torch.float64 if want.dtype == torch.float64 else torch.float32
    err = (got.to(dtype) - want).abs().mean().item()
    den = want.to(dtype).abs().mean().item() if scale is None else scale
    return err / den if den > 0 else (0.0 if err == 0 else math.inf)


def mean_limit(name: str, want: torch.Tensor, scale: float = None) -> float:
    """``MEAN_TOL[name]`` plus ``FLIP_STEPS`` bf16 steps (2^-8 relative)
    of the largest element of ``want``, as a share of its summed
    magnitude (negligible at the real sites' sizes)."""
    w = want.float().abs()
    den = (w.mean().item() if scale is None else scale) * w.numel()
    floor = FLIP_STEPS * 2.0 ** -8 * w.max().item() / den if den > 0 else 0.0
    return MEAN_TOL[name] + floor


def _bwd_scale(want: Sequence[torch.Tensor], m: int):
    return max(t.float().abs().mean().item() for t in want) if m == 1 else None


def bwd_mean_limits(want: Sequence[torch.Tensor], m: int) -> List[float]:
    """``mean_limit`` of (dq, dk, dv), against the scale of
    ``bwd_mean_errs``."""
    scale = _bwd_scale(want, m)
    return [mean_limit(name, t, scale) for name, t in zip(("dq", "dk", "dv"), want)]


def bwd_mean_errs(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
                  m: int) -> List[float]:
    """``mean_rel_err`` of (dq, dk, dv). With one key (m = 1) the softmax
    is constant, dq and dk are 0 in exact arithmetic, and all three are
    measured against the largest of the three means."""
    scale = _bwd_scale(want, m)
    return [mean_rel_err(a, b, scale) for a, b in zip(got, want)]


def split_bf16(x: torch.Tensor, parts: int) -> List[torch.Tensor]:
    """f32 ``x`` as ``parts`` bf16 tensors, each the bf16 rounding of
    what the earlier ones leave. Three parts sum back to ``x`` exactly:
    each remainder is exact in f32, and the third has at most 8
    significant bits."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        out.append(part)
        rest = rest - part.float()
    return out


def round_bf16_exact(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` rounded once to bf16's 8 significant bits, to nearest
    even, in f64 (no f32 step between, so no double rounding; values
    below bf16's normal range keep 8 bits, which moves no sum here)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 256.0), e - 8)


def fwd_exact(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's contract computed exactly: logits and softmax in
    f64, P rounded once to bf16 (``round_bf16_exact``), P.V summed in
    f64; (o, lse) in f64. One batch element at a time, so the f64
    logits of the largest sites stay small."""
    out, lses = [], []
    for b in range(q.shape[0]):
        s = torch.matmul(q[b].double(), k[b].double().transpose(0, 1))
        lse = torch.logsumexp(s, dim=-1)
        p = round_bf16_exact(torch.exp(s - lse[:, None]))
        out.append(torch.matmul(p, v[b].double()))
        lses.append(lse)
        del s, p
    return torch.stack(out), torch.stack(lses)


def bwd_exact(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's contract computed exactly, one batch element at a
    time: P = exp(q k^T - lse) (lse the forward's f32 output, as the
    kernel takes it), D = rowsum(dO * O), dP = dO V^T, dS = P * (dP - D),
    dQ = dS K, dK = dS^T Q and dV = P'^T dO with P' = P rounded once to
    bf16, all in f64; each gradient rounded once to bf16
    (``round_bf16_exact``). (dq, dk, dv) in f64."""
    outs = []
    for b in range(q.shape[0]):
        qd, kd, vd, dod = (t[b].double() for t in (q, k, v, do))
        p = torch.exp(torch.matmul(qd, kd.transpose(0, 1)) - lse[b].double()[:, None])
        dv = torch.matmul(round_bf16_exact(p).transpose(0, 1), dod)
        d = (dod * o[b].double()).sum(dim=-1, keepdim=True)
        ds = p * (torch.matmul(dod, vd.transpose(0, 1)) - d)
        del p
        outs.append(tuple(round_bf16_exact(t) for t in
                          (torch.matmul(ds, kd), torch.matmul(ds.transpose(0, 1), qd), dv)))
        del ds
    return tuple(torch.stack(parts) for parts in zip(*outs))


def fwd_exp2(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contract with exp2((s - lse) * log2 e) in place of exp(s -
    lse), as a kernel computes P with ``ex2``."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp2((s - lse[..., None]) * LOG2E).to(torch.bfloat16)
    return torch.matmul(p.float(), v.float()), lse


def fwd_online_softmax(q, k, v, tile: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """A violation: the online softmax over key tiles, which rounds the
    unnormalised exp(s - running max) to bf16 and divides after P.V."""
    qf = q.float()
    B, N, _ = q.shape
    m = torch.full((B, N, 1), -math.inf, device=q.device)
    den = torch.zeros(B, N, 1, device=q.device)
    acc = torch.zeros(B, N, v.shape[2], device=q.device)
    for j in range(0, k.shape[1], tile):
        s = torch.matmul(qf, k[:, j:j + tile].float().transpose(1, 2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), v[:, j:j + tile].float())
        den = den * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return acc / den, (m + torch.log(den))[..., 0]


def bwd_split(q, k, v, o, lse, do, parts: int):
    """The backward with dQ = dS K and dK = dS^T Q taken as the sum of
    ``parts`` products of bf16 parts of dS (``split_bf16``) with f32
    sums: 3 keeps the contract; 2, and 1 (a bf16 dS), break it."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    d = (dof * o).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) - lse[..., None])
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(1, 2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - d)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    for part in split_bf16(ds, parts):
        dq = dq + torch.matmul(part.float(), kf)
        dk = dk + torch.matmul(part.float().transpose(1, 2), qf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
