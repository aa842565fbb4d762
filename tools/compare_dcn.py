#!/usr/bin/env python3
"""Time the port's hat DCN kernels (``deform_conv_fwd``,
``deform_conv_bwd``) against those of another checkout at the three sites
chip_smoke.py holds them to, on one card, in turns (baseline, current,
current, baseline), and print one JSON line per site and a summary.

    python3 tools/compare_dcn.py --baseline <root of another checkout>

The baseline's ``gssd_torch/csrc/deform_conv_{fwd,bwd}.cu`` are built with
the same nvcc flags into a temporary directory (``compare_attention``'s
helpers) and called as their own wrappers called them: a baseline whose
C functions take the current signatures goes through the current
wrappers; one from before the wgmma redesign (no Cout8 argument, a
forward of 7 pointers and 8 ints, a backward of 14 pointers and 8 ints
with dU and sample scratch) through a copy of its wrapper. Sites: the
forward at batch 8 and 32 and the backward at batch 32 (38x38, 1024 ->
512, 4 groups), both at 75x75 (512 -> 256, batch 16). Both sides are
held to the plain versions by the rounding contract
(``dcn_contract.readings``, reported; the current kernel must keep it),
and the baseline's outputs must agree with the current kernel's within
chip_smoke's KERNEL_TOL of max.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from compare_attention import _Baseline, bind, compile_sources, in_turns  # noqa: E402


def build_baseline(root, out_dir):
    with open(os.path.join(root, "gssd_torch", "csrc", "deform_conv_bwd.cu")) as f:
        current_style = "deform_du_sm90" in f.read()
    libs = compile_sources(root, ("deform_conv_fwd", "deform_conv_bwd"), out_dir)
    fwd, bwd = libs["deform_conv_fwd"].deform_conv_fwd, libs["deform_conv_bwd"].deform_conv_bwd
    if current_style:
        return dict(current_style=True, fwd=bind(fwd, 7, 9), bwd=bind(bwd, 15, 10))
    return dict(current_style=False, fwd=bind(fwd, 7, 8), bwd=bind(bwd, 14, 8))


def _call(fn, *args):
    import torch

    _Baseline(fn).launch(torch.cuda.current_stream().cuda_stream,
                         *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))


def old_fwd(fn):
    """The wrapper of a forward from before the redesign."""
    import torch

    def fwd(x, py, px, m, wg, bias):
        B, H, W, C = x.shape
        _, P, G, K = py.shape
        out = torch.empty(B, P, wg.shape[-1], dtype=torch.float32, device=x.device)
        _call(fn, x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, wg.shape[-1])
        return out

    return fwd


def old_bwd(fn):
    """The wrapper of a backward from before the redesign (dU GEMM,
    corner kernel with the sample scratch, dx gather, dW GEMM)."""
    import torch

    def bwd(x, py, px, m, wg, g):
        B, H, W, C = x.shape
        _, P, G, K = py.shape
        Cout, dev = wg.shape[-1], x.device
        gb = g.to(torch.bfloat16)
        dpy, dpx, dm = (torch.empty(B, P, G, K, device=dev) for _ in range(3))
        dx = torch.empty(B, H, W, C, dtype=torch.bfloat16, device=dev)
        dwg = torch.empty(G, K, C // G, Cout, dtype=torch.bfloat16, device=dev)
        du, samp = (torch.empty(B, P, G, K, C // G, dtype=torch.bfloat16, device=dev)
                    for _ in range(2))
        cells = B * G * (H + 1) * (W + 1)
        buckets = torch.empty(2 * cells + 1 + B * G + B * P * G * K, dtype=torch.int32,
                              device=dev)
        _call(fn, x, py, px, m, wg, gb, dpy, dpx, dm, dx, dwg, du, samp, buckets,
              B, H, W, C, G, K, P, Cout)
        return dpy, dpx, dm, dx, dwg

    return bwd


@contextlib.contextmanager
def baseline_kernels(dh, base):
    """dh.deform_conv_fwd / _bwd call the baseline's kernels inside."""
    saved = dh.KERNEL, dh.BWD_KERNEL, dh.deform_conv_fwd, dh.deform_conv_bwd
    if base["current_style"]:
        dh.KERNEL, dh.BWD_KERNEL = _Baseline(base["fwd"]), _Baseline(base["bwd"])
    else:
        dh.deform_conv_fwd, dh.deform_conv_bwd = old_fwd(base["fwd"]), old_bwd(base["bwd"])
    try:
        yield
    finally:
        dh.KERNEL, dh.BWD_KERNEL, dh.deform_conv_fwd, dh.deform_conv_bwd = saved


def sites(cs):
    """(label, direction, args) of the three sites, seeded as chip_smoke's."""
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    yield f"38x38 B={cs.BATCH}", "fwd", cs.dcn_inputs(cs.BATCH)
    x, py, px, m, wg, bias = cs.dcn_inputs(cs.TRAIN_BATCH)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    gout = torch.randn(*py.shape[:2], wg.shape[-1], device="cuda", generator=g)
    yield f"38x38 B={cs.TRAIN_BATCH}", "fwd", (x, py, px, m, wg, bias)
    yield f"38x38 B={cs.TRAIN_BATCH}", "bwd", (x, py, px, m, wg, gout)
    B, H, C, G, K, Cout = cs.PL_BATCH, 75, 512, 4, 9, 256
    off = torch.rand(2, B, H, H, G, K, device="cuda", generator=g) * 6 - 3
    py, px = (t.reshape(B, H * H, G, K).contiguous() for t in dh.sample_coords(off[0], off[1]))
    x = torch.randn(B, H, H, C, device="cuda", generator=g).bfloat16()
    m = torch.rand(B, H * H, G, K, device="cuda", generator=g)
    wg = ((torch.rand(G, K, C // G, Cout, device="cuda", generator=g) * 2 - 1)
          / math.sqrt(K * C)).bfloat16()
    bias = torch.randn(Cout, device="cuda", generator=g) * 0.1
    gout = torch.randn(B, H * H, Cout, device="cuda", generator=g)
    yield f"75x75 B={B}", "fwd", (x, py, px, m, wg, bias)
    yield f"75x75 B={B}", "bwd", (x, py, px, m, wg, gout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="root of the checkout to compare with")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import dcn_contract as dc
    from gssd_torch.ops.kernels import deform_hat as dh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build([KERNELS["deform_conv_fwd"], KERNELS["deform_conv_bwd"]])
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        base = build_baseline(args.baseline, tmp)
        for label, d, site_args in sites(cs):
            names = dc.FWD_OUTPUTS if d == "fwd" else dc.BWD_OUTPUTS

            def current(d=d, site_args=site_args):
                fn = dh.deform_conv_fwd if d == "fwd" else dh.deform_conv_bwd
                out = fn(*site_args)
                return (out,) if d == "fwd" else out

            def baseline(current=current):
                with baseline_kernels(dh, base):
                    return current()

            plain = (dh.deform_conv_fwd_plain(*site_args),) if d == "fwd" else \
                dh.deform_conv_bwd_plain(*site_args)
            got_b, got_c = baseline(), current()
            torch.cuda.synchronize()
            current_errs = dc.readings(names, got_c, plain)
            bad = dc.violations(current_errs, dc.limits(names, plain))
            bad.update({n: (err, cs.KERNEL_TOL * scale) for n, a, b in zip(names, got_b, got_c)
                        for err, scale in [((a.float() - b.float()).abs().max().item(),
                                            b.float().abs().max().item())]
                        if not err <= cs.KERNEL_TOL * scale})
            if bad:
                print(f"FAIL: at {label} {d}, the current kernel breaks its contract or the "
                      f"baseline disagrees with it: {bad}", file=sys.stderr)
                return 1
            row = dict(site=label, direction=d, contract_current=current_errs,
                       contract_baseline=dc.readings(names, got_b, plain),
                       **in_turns(cs.time_ms, baseline, current, args.iters))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del plain, got_b, got_c
            torch.cuda.empty_cache()
    print(json.dumps({"power": smi, "sites": len(rows),
                      "slowest_vs_baseline": min(r["speedup"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
