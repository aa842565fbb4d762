#!/usr/bin/env python3
"""Time the port's separable-sampler kernels (``deform_sample_fwd``,
``deform_sample_dx``, ``deform_sample_dab``) against those of another
checkout at the 38x38 site chip_smoke.py holds them to, on one card, in
turns (baseline, current, current, baseline), and print one JSON line per
site and a summary.

    python3 tools/compare_sample.py --baseline <root of another checkout>

The baseline's ``gssd_torch/csrc/deform_sample_{fwd,dx,dab}.cu`` are built
with the same nvcc flags into a temporary directory (``compare_attention``'s
helpers) and called as their own wrappers called them: a baseline whose
forward reads the hat rows' ranges (``hat_ranges``) takes the current
signatures and goes through the current wrappers; one from before (the
dense kernels: a forward of 4 pointers and 5 ints, a dA/dB of 6 pointers
and 5 ints, no scratch) through a copy of its wrappers. Sites
(``chip_smoke.sample_inputs``): the forward at batch 8 and 32, dx and dA/dB
at batch 32. Each line says whether the two sides' outputs are the same
bits and their largest difference; the tool fails if dx differs at all
(its code did not change) or if the forward or dA/dB differ by more than
chip_smoke's SAMPLE_TOL of max.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from compare_attention import _Baseline, bind, compile_sources, in_turns  # noqa: E402

NAMES = ("deform_sample_fwd", "deform_sample_dx", "deform_sample_dab")


def build_baseline(root, out_dir):
    with open(os.path.join(root, "gssd_torch", "csrc", "deform_sample_fwd.cu")) as f:
        ranged = "hat_ranges" in f.read()
    libs = compile_sources(root, NAMES, out_dir)
    base = dict(ranged=ranged, dx=bind(libs["deform_sample_dx"].deform_sample_dx, 5, 5))
    fwd = libs["deform_sample_fwd"].deform_sample_fwd
    dab = libs["deform_sample_dab"].deform_sample_dab
    if ranged:
        base["fwd"], base["dab"] = bind(fwd, 5, 5), bind(dab, 8, 5)
        base["dab_lib"] = libs["deform_sample_dab"]
    else:
        base["fwd"], base["dab"] = bind(fwd, 4, 5), bind(dab, 6, 5)
    return base


def _call(fn, *args):
    import torch

    _Baseline(fn).launch(torch.cuda.current_stream().cuda_stream,
                         *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))


def dense_fwd(fn):
    """The wrapper of a forward from before the ranges (no scratch)."""
    import torch

    def fwd(a, b, x):
        N, G, P, H = a.shape
        out = torch.empty(N, G, P, x.shape[-1], dtype=torch.float32, device=a.device)
        _call(fn, a, b, x, out, N * G, P, H, b.shape[-1], x.shape[-1])
        return out

    return fwd


def dense_dab(fn):
    """The wrapper of a dA/dB from before the buckets (no scratch)."""
    import torch

    def dab(x, g, a, b):
        N, G, P, H = a.shape
        W = b.shape[-1]
        da = torch.empty(N, G, P, H, dtype=torch.float32, device=a.device)
        db = torch.empty(N, G, P, W, dtype=torch.float32, device=a.device)
        _call(fn, x, g, a, b, da, db, N * G, P, H, W, x.shape[-1])
        return da, db

    return dab


@contextlib.contextmanager
def baseline_kernels(ds, base):
    """ds.abx_fwd, abx_dx and abx_dab call the baseline's kernels inside."""
    saved = ds.FWD_KERNEL, ds.DX_KERNEL, ds.DAB_KERNEL, ds.abx_fwd, ds.abx_dab
    ds.DX_KERNEL = _Baseline(base["dx"])
    if base["ranged"]:
        ds.FWD_KERNEL = _Baseline(base["fwd"])
        ds.DAB_KERNEL = _Baseline(base["dab"], base["dab_lib"])
    else:
        ds.abx_fwd, ds.abx_dab = dense_fwd(base["fwd"]), dense_dab(base["dab"])
    try:
        yield
    finally:
        ds.FWD_KERNEL, ds.DX_KERNEL, ds.DAB_KERNEL, ds.abx_fwd, ds.abx_dab = saved


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
    from gssd_torch.ops.kernels import deform_sample as ds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build([KERNELS[name] for name in NAMES])
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        base = build_baseline(args.baseline, tmp)
        for batch, kernels in ((cs.BATCH, ("fwd",)), (cs.TRAIN_BATCH, ("fwd", "dx", "dab"))):
            a, b, x, gout = cs.sample_inputs(batch)
            for kernel in kernels:
                def current(kernel=kernel):
                    if kernel == "fwd":
                        return (ds.abx_fwd(a, b, x),)
                    if kernel == "dx":
                        return (ds.abx_dx(a, b, gout),)
                    return ds.abx_dab(x, gout, a, b)

                def baseline(current=current):
                    with baseline_kernels(ds, base):
                        return current()

                got_b, got_c = baseline(), current()
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in zip(got_b, got_c))
                diff = max((u - v).abs().max().item() for u, v in zip(got_b, got_c))
                rel = max(((u - v).abs().max() / v.abs().max()).item()
                          for u, v in zip(got_b, got_c))
                if (kernel == "dx" and not same) or not rel <= cs.SAMPLE_TOL[kernel]:
                    print(f"FAIL: at 38x38 B={batch} {kernel}, the baseline and the current "
                          f"kernel differ by {diff} (rel {rel:.3g})", file=sys.stderr)
                    return 1
                row = dict(site=f"38x38 B={batch}", kernel=f"deform_sample_{kernel}",
                           bit_equal=same, max_abs_diff=diff, rel_diff=rel,
                           **in_turns(cs.time_ms, baseline, current, args.iters))
                rows.append(row)
                print(json.dumps(row), flush=True)
                del got_b, got_c
            del a, b, x, gout
            torch.cuda.empty_cache()
    print(json.dumps({"power": smi, "sites": len(rows),
                      "slowest_vs_baseline": min(r["speedup"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
