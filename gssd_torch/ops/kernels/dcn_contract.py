"""The rounding contract of the hat DCN kernels (``deform_conv_fwd``,
``deform_conv_bwd``), the check that guards it, and plain emulations of
the contract broken.

The contract is that of ``gssd_tpu/ops/pallas/deform_hat.py`` as the
plain versions in ``deform_hat.py`` write it:
- each corner weight ay * bx * m is rounded to bf16 (forward, the
  backward's samples and dx);
- each sample is rounded to bf16 before the products with the weights
  (forward) and with g (the backward's dW);
- g is rounded to bf16 before the dU and dW products;
- dU is rounded to bf16 before dS (the corner terms dpy, dpx, dm) and dx.

A max-error check against the plain versions (``KERNEL_TOL`` = 1e-2 of
max in ``chip_smoke.py``) cannot tell the contract from its usual
violations: the forward that kept its corner weights in f32 read 2.2e-3
of max. A mean error over a mean value can: ``mean_rel_err`` is mean
|got - want| / mean |want| per output, and ``MEAN_TOL`` holds each output
to it. A kernel that keeps the roundings differs from the plain version
only in the order of its f32 sums (and, rarely, in a bf16 rounding that
order flips); each violation moves every element by up to a bf16 step of
what it left unrounded. ``FAULTS`` plants the four violations in the
plain versions, on any device; each must read above the limit of every
output in ``AFFECTS`` (``tests/test_torch_dcn_contract.py`` on the CPU,
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card; readings
in PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from gssd_torch.ops.kernels import deform_hat as dh
from gssd_torch.ops.kernels.flash_contract import round_bf16_exact

FWD_OUTPUTS = ("out",)
BWD_OUTPUTS = ("dpy", "dpx", "dm", "dx", "dwg")
# limits of mean |kernel - plain| / mean |plain| per output, at every
# site the card checks, 2.3x to 7x above the H100's readings (out 8.6e-6,
# dpy, dpx, dm 5.2e-6, dx 1.4e-6, dwg 1.4e-5 at batch 32, 38x38; the
# tensor cores' f32 sums in another order than the plain version's) and
# 37x or more below every planted fault (>= 1.5e-3; PERF.md §6)
MEAN_TOL = {"out": 3e-5, "dpy": 2e-5, "dpx": 2e-5, "dm": 2e-5, "dx": 1e-5, "dwg": 4e-5}
# at small sizes one bf16 step of one element moves the mean: each
# limit allows this many steps of the largest element on top
FLIP_STEPS = 1

# the planted faults: the rounding each leaves out (the switches of
# dh.fwd_rounded and dh.bwd_rounded)
FAULTS = {
    "f32_corner_weights": dict(round_w=False),
    "unrounded_sample": dict(round_samp=False),
    "unrounded_g": dict(round_g=False),
    "unrounded_du": dict(round_du=False),
}
# the outputs each fault must move above their limits
AFFECTS = {
    "f32_corner_weights": ("out", "dx", "dwg"),
    "unrounded_sample": ("out", "dwg"),
    "unrounded_g": BWD_OUTPUTS,
    "unrounded_du": ("dpy", "dpx", "dm", "dx"),
}


def mean_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """mean |got - want| / mean |want| in f32."""
    err = (got.float() - want.float()).abs().mean().item()
    den = want.float().abs().mean().item()
    return err / den if den > 0 else (0.0 if err == 0 else math.inf)


def mean_limit(name: str, want: torch.Tensor) -> float:
    """``MEAN_TOL[name]`` plus ``FLIP_STEPS`` bf16 steps (2^-8 relative)
    of the largest element of ``want``, as a share of its summed
    magnitude (negligible at the real sites' sizes)."""
    w = want.float().abs()
    den = w.mean().item() * w.numel()
    return MEAN_TOL[name] + (FLIP_STEPS * 2.0 ** -8 * w.max().item() / den if den > 0 else 0.0)


def readings(names: Sequence[str], got: Sequence[torch.Tensor],
             want: Sequence[torch.Tensor]) -> Dict[str, float]:
    return {n: mean_rel_err(a, b) for n, a, b in zip(names, got, want)}


def limits(names: Sequence[str], want: Sequence[torch.Tensor]) -> Dict[str, float]:
    return {n: mean_limit(n, b) for n, b in zip(names, want)}


def fwd_fault(x, py, px, m, wg, bias, fault: str) -> torch.Tensor:
    """The plain forward with ``fault``'s rounding left out (a fault that
    touches ``out``)."""
    return dh.fwd_rounded(x, py, px, m, wg, bias, **FAULTS[fault])


def bwd_fault(x, py, px, m, wg, g, fault: str):
    """The plain backward with ``fault``'s rounding left out; dx and dW
    rounded to bf16 as the plain version rounds them."""
    dpy, dpx, dm, dx, dw = dh.bwd_rounded(x, py, px, m, wg, g, **FAULTS[fault])
    return dpy, dpx, dm, dx.to(torch.bfloat16), dw.to(torch.bfloat16)


def fwd_faults(args) -> Dict[str, Dict[str, float]]:
    """The readings of the faults that touch the forward, against the
    plain forward on ``args`` (x, py, px, m, wg, bias)."""
    want = dh.deform_conv_fwd_plain(*args)
    return {f: readings(FWD_OUTPUTS, (fwd_fault(*args, f),), (want,))
            for f in FAULTS if "out" in AFFECTS[f]}


def bwd_faults(args, want=None) -> Dict[str, Dict[str, float]]:
    """The readings of every fault against the plain backward on ``args``
    (x, py, px, m, wg, g); ``want``: that plain backward, if at hand."""
    want = dh.deform_conv_bwd_plain(*args) if want is None else want
    return {f: readings(BWD_OUTPUTS, bwd_fault(*args, f), want) for f in FAULTS}


def violations(errs: Dict[str, float], lims: Dict[str, float]) -> Dict[str, tuple]:
    """The outputs whose reading exceeds its limit: {name: (err, limit)}."""
    return {n: (e, lims[n]) for n, e in errs.items() if not e <= lims[n]}


def faults_missed(faults: Dict[str, Dict[str, float]], lims: Dict[str, float]) -> Dict[str, tuple]:
    """The (fault, output) pairs of ``AFFECTS`` whose planted reading is
    not above the output's limit: {"fault/output": (err, limit)}."""
    return {f"{f}/{n}": (errs[n], lims[n]) for f, errs in faults.items()
            for n in AFFECTS[f] if n in errs and not errs[n] > lims[n]}


def dw_exact(x, py, px, m, wg, g) -> torch.Tensor:
    """The backward's dW under the contract computed exactly: each
    sample summed in f64 from the bf16 corner weights bf16(ay * bx * m)
    (f32 hats, as the plain versions form them) and bf16 x, rounded once
    to bf16; g rounded to bf16; dW_k = samp^T . bf16(g) summed over B*P
    in f64 and rounded once to bf16 (``round_bf16_exact``). Arguments as
    ``deform_hat.deform_conv_bwd``'s; returns [G, K, C/G, Cout] f64
    holding bf16 values, the witness ``tools/dw_witness.py`` holds the
    kernel's dW and the plain version's to."""
    B, H, W, C = x.shape
    _, P, G, K = py.shape
    Cg = C // G
    xd = x.double().reshape(B, H * W, G, Cg)
    gb = g.to(torch.bfloat16).double().reshape(B * P, -1)
    y0, x0 = torch.floor(py), torch.floor(px)
    dw = torch.empty(G, K, Cg, gb.shape[-1], dtype=torch.float64, device=x.device)
    for k in range(K):
        samp = torch.zeros(B, P, G, Cg, dtype=torch.float64, device=x.device)
        for dy in (0, 1):
            for dx in (0, 1):
                qy, qx = y0[..., k] + dy, x0[..., k] + dx
                inb = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
                s0 = dh._hat(py[..., k], qy) * dh._hat(px[..., k], qx) * m[..., k]
                w = torch.where(inb, s0.to(torch.bfloat16).double(), 0.0)
                idx = (qy.clamp(0, H - 1) * W + qx.clamp(0, W - 1)).long()
                vals = torch.gather(xd, 1, idx[..., None].expand(B, P, G, Cg))
                samp += w[..., None] * vals
                del vals
        samp = round_bf16_exact(samp).reshape(B * P, G, Cg)
        dw[:, k] = torch.einsum("pgc,pn->gcn", samp, gb)
        del samp
    return round_bf16_exact(dw)
