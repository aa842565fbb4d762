"""Arithmetic that several per-layer metrics' readers share."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from benchmark import work

ATTN_KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90", "dq_reduce")
DCN_KERNELS = ("deform_fwd_sm90", "deform_du_sm90", "deform_dw_sm90", "dw_reduce",
               "bucket_count", "bucket_scan", "bucket_fill", "bucket_sort", "dx_gather")
# the port's launch counters of each function's kernels, forward and backward
COUNTERS = {"attention": ("flash_attn_fwd", "flash_attn_bwd"),
            "dcn": ("deform_conv_fwd", "deform_conv_bwd")}


def roofline(ctx, kind: str, kernels: Sequence[str], backward: bool) -> Optional[float]:
    """Share (%) of the function's least time, summed over its sites of
    the traced units (forward, and backward with ``backward``), in the
    device time of ``kernels``. None where the kernels did not run, or
    ran another number of times than the sites ask for (the port's
    launch counters, ``KERNELS``)."""
    tr = ctx.trace
    sites = work.attention_sites(ctx.model) if kind == "attention" else work.dcn_sites(ctx.model)
    want = {COUNTERS[kind][0]: len(sites) * tr.units,
            COUNTERS[kind][1]: len(sites) * tr.units if backward else 0}
    got = {k: tr.launch_counts.get(k, 0) for k in want}
    print(f"{kind} launches over {tr.units} units: {got} (sites ask for {want})", file=sys.stderr)
    seconds = tr.seconds_of(kernels)
    if got != want or seconds <= 0:
        return None
    least = work.sites_bound_s(kind, ctx.model, ctx.batch, backward) * tr.units
    return 100.0 * least / seconds


def idle_percent(ctx) -> Optional[float]:
    """100 x (1 - the union of the kernels' intervals / the traced window)."""
    tr = ctx.trace
    if not tr.kernels() or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(tr.kernels()) / tr.window_s)


def mfu(ctx, backward: bool) -> Optional[float]:
    """The whole step's share of the card's bf16 peak, in %, on the
    device's own clock: model FLOPs a slice (the plain reference's,
    forward and with ``backward`` the backward) x the slices of the traced
    units, over the traced span (the first device operation's start to the
    last one's end, idle gaps included), over the peak."""
    tr = ctx.trace
    if not tr.device:
        return None
    span = max(s + d for _, s, d in tr.device) - min(s for _, s, _ in tr.device)
    if span <= 0:
        return None
    return 100.0 * ctx.model_flops(backward) * tr.units * ctx.batch / span / work.PEAK_BF16_FLOPS


def launches_per_unit(ctx) -> Optional[float]:
    tr = ctx.trace
    n = tr.launches()
    print(f"kernel-launch calls {n} over {tr.units} units; the port's counters "
          f"{tr.launch_counts}", file=sys.stderr)
    return n / tr.units if n else None
