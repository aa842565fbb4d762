#!/usr/bin/env python3
"""Device time of one PixelLink++ (4s) training step with the wide-conv
switch on, by kernel, with this checkout's stem conv kernels and with
another checkout's, in turns (baseline, current, current, baseline), in
one process on one card.

    python3 tools/profile_step.py --baseline <root of another checkout>

A step runs on one repeated batch of 16 of the synthetic set (no data
loader) from chip_smoke's seeded weights: 3 warm-up steps, 5 steps timed
on the host clock (synchronised), then 3 steps under torch.profiler. The
baseline's ``stem_conv_{fwd,bwd}.cu`` are built and called as
``tools/compare_stem.py`` calls them; every other kernel is this
checkout's. Prints one JSON line per turn: the wall ms a step, the
device ms a step (the kernels' summed device time; the rest of the wall
time the device idles) and the kernels that take the most, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import compare_stem  # noqa: E402
from profile_kernels import device_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="root of the checkout to compare with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.config import OptimConfig
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import stem_conv as sc
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.steps import backward, pixellink_forward_loss, update
    from gssd_torch.train_pixellink import parse_args, pixellink_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build(KERNELS.values())
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "ml")
        make_synthetic_dataset(data, num_subjects=12, slices_per_subject=3, image_size=512,
                               seed=1234)
        base = compare_stem.build_baseline(args.baseline, tmp)
        pargs = parse_args(["--reference_recipe", "pixellink++"])
        plc = pixellink_config(pargs)
        ocfg = OptimConfig(lr=pargs.lr, momentum=pargs.momentum,
                           weight_decay=pargs.weight_decay, gamma=pargs.gamma,
                           stepvalues=tuple(pargs.stepvalues),
                           modify_dcn_lr=pargs.modify_dcn_lr)
        with cs.wide_conv():
            model = cs.seeded_pixellink("bfloat16").to("cuda").train()
            batch = cs.pixellink_batch(data, cs.PL_BATCH, "cuda")
            opt = make_optimizer(model, ocfg)

            def step(i=0):
                loss, _ = pixellink_forward_loss(model, batch, plc)
                update(opt, backward(model, opt, loss), ocfg, i)

            for side in ("baseline", "current", "current", "baseline"):
                ctx = (compare_stem.baseline_kernels(sc, base) if side == "baseline"
                       else contextlib.nullcontext())
                with ctx:
                    for i in range(3):
                        step(i)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for i in range(5):
                        step(i)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / 5 * 1e3
                    kernels = device_ms(step, 3)
                top = sorted(kernels.items(), key=lambda kv: -kv[1])
                stem = {k: v for k, v in kernels.items()
                        if any(n in k for n in ("stem::", "dw_mma", "dw_reduce", "dx_mma",
                                                "pack_dx"))}
                print(json.dumps({"side": side, "wall_ms_per_step": wall,
                                  "device_ms_per_step": sum(kernels.values()),
                                  "stem_kernels_ms": stem, "top_kernels_ms": dict(top[:10]),
                                  "power": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
