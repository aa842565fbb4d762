#!/usr/bin/env python3
"""Time the port's stem conv forward, and its backward (whose dx kernel
is the forward's conv), against those of another checkout at
PixelLink++'s two stem sites (batch 16, 300x300, bf16), on one card, in
turns (baseline, current, current, baseline), and print one JSON line per
site and boundary and a summary.

    python3 tools/compare_stem.py --baseline <root of another checkout>

The baseline's ``gssd_torch/csrc/stem_conv_{fwd,bwd}.cu`` are built with
the same nvcc flags into a temporary directory (``compare_attention``'s
helpers) and called as their own wrappers called them: a forward from
before the shared conv (its C function takes x, w, bias, out and no
packed-weight scratch) directly, any other through the current wrapper;
the backward through the current wrapper, its dx weights' scratch sized
by the library's ``stem_conv_bwd_wpack_elems`` or, where it has none, by
the fixed size its wrapper allocated. Each line also carries both sides'
device time by kernel (torch.profiler), which splits dx from dW. The
two sides must agree as chip_smoke's phase 14 holds each to the plain
version: y and dx within STEM_ULP_MAX ulp of each other with at most
twice STEM_DIFF_SHARE of the elements differing, dW the same bits (its
kernel did not change).
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
from profile_kernels import device_ms  # noqa: E402

NAMES = ("stem_conv_fwd", "stem_conv_bwd")


class _SizedBaseline(_Baseline):
    """A baseline backward whose library may not say how much dx-weight
    scratch it takes: then its wrapper's fixed size (G x 9 x 4 x 64 x 24)."""

    def query(self, name, *ints):
        if hasattr(self.lib, f"{self.fn.__name__}_{name}"):
            return super().query(name, *ints)
        return ints[2] * 9 * 4 * 64 * 24


def build_baseline(root, out_dir):
    libs = compile_sources(root, NAMES, out_dir)
    fwd_lib = libs["stem_conv_fwd"]
    shared = hasattr(fwd_lib, "stem_conv_fwd_wpack_elems")
    fwd = bind(fwd_lib.stem_conv_fwd, 5, 8) if shared else bind(fwd_lib.stem_conv_fwd, 4, 7)
    return dict(shared=shared, fwd=fwd, fwd_lib=fwd_lib, bwd_lib=libs["stem_conv_bwd"],
                bwd=bind(libs["stem_conv_bwd"].stem_conv_bwd, 7, 9))


def old_fwd(fn):
    """The forward wrapper of a baseline from before the shared conv."""
    import torch

    def fwd(x, w, bias, groups):
        B, Cin, H, W = x.shape
        out = torch.empty(B, w.shape[0], H, W, dtype=x.dtype, device=x.device)
        _Baseline(fn).launch(torch.cuda.current_stream().cuda_stream, x.data_ptr(), w.data_ptr(),
                             bias.data_ptr(), out.data_ptr(), B, Cin, w.shape[0], groups, H, W,
                             0 if x.dtype == torch.bfloat16 else 1)
        return out

    return fwd


@contextlib.contextmanager
def baseline_kernels(sc, base):
    """sc.stem_conv_fwd and stem_conv_bwd call the baseline's kernels inside."""
    saved = sc.FWD_KERNEL, sc.BWD_KERNEL, sc.stem_conv_fwd
    sc.BWD_KERNEL = _SizedBaseline(base["bwd"], base["bwd_lib"])
    if base["shared"]:
        sc.FWD_KERNEL = _Baseline(base["fwd"], base["fwd_lib"])
    else:
        sc.stem_conv_fwd = old_fwd(base["fwd"])
    try:
        yield
    finally:
        sc.FWD_KERNEL, sc.BWD_KERNEL, sc.stem_conv_fwd = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="root of the checkout to compare with")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import stem_conv as sc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build([KERNELS[name] for name in NAMES])
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    B, H, W, G = cs.PL_BATCH, 300, 300, 4
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        base = build_baseline(args.baseline, tmp)
        for name, cin, cout in cs.STEM_SITES:
            x = torch.rand(B, cin, H, W, device="cuda", generator=g).bfloat16()
            w = torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g) * math.sqrt(
                2 / (9 * cin / G))
            b = torch.randn(cout, device="cuda", generator=g) * 0.5
            gout = torch.randn(B, cout, H, W, device="cuda", generator=g).bfloat16()
            wb = w.bfloat16()
            need_dx = name != "conv1_1"  # conv1_1's input is the image
            for kernel in ("fwd", "bwd"):
                def current(kernel=kernel):
                    if kernel == "fwd":
                        return (sc.stem_conv_fwd(x, wb, b, G),)
                    return sc.stem_conv_bwd(x, w, gout, G, need_dx)

                def baseline(current=current):
                    with baseline_kernels(sc, base):
                        return current()

                got_b, got_c = baseline(), current()
                torch.cuda.synchronize()
                out = "y" if kernel == "fwd" else "dx"
                ulp, share = (cs._agreement(got_c[0], got_b[0]) if got_c[0] is not None
                              else (0.0, 0.0))
                dw_same = kernel == "fwd" or torch.equal(got_b[1], got_c[1])
                if not (ulp <= cs.STEM_ULP_MAX and share <= 2 * cs.STEM_DIFF_SHARE and dw_same):
                    print(f"FAIL: {name} {kernel}: the baseline and the current kernel differ "
                          f"({out} {ulp} ulp, {share} of the elements; dW the same bits: "
                          f"{dw_same})", file=sys.stderr)
                    return 1
                row = dict(site=name, B=B, Cin=cin, Cout=cout, G=G, need_dx=need_dx,
                           boundary=f"stem_conv_{kernel}", max_ulp=ulp, share_differing=share,
                           bit_equal=all(u is None or torch.equal(u, v)
                                         for u, v in zip(got_b, got_c)),
                           **in_turns(cs.time_ms, baseline, current, args.iters))
                row["baseline_kernels_ms"] = device_ms(baseline, 10)
                row["current_kernels_ms"] = device_ms(current, 10)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del got_b, got_c
            del x, w, gout
            torch.cuda.empty_cache()
    print(json.dumps({"power": smi, "rows": len(rows),
                      "slowest_vs_baseline": min(r["speedup"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
