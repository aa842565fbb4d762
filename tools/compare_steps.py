#!/usr/bin/env python3
"""Time one training step of GSSD++ (batch 32, on the ``hat``, ``pallas``
and ``fused`` DCN routes) and of PixelLink++ (4s, batch 16, the wide-conv
switch on) for this checkout and another, on one card, in turns
(baseline, current, current, baseline), each in a process of its own
that imports its checkout's gssd_torch.

    python3 tools/compare_steps.py --baseline <root of another checkout>

A step runs on one repeated batch of the synthetic set (no data loader,
so the host's augmentation thread is out of the timing) from each
checkout's own seeded weights (``chip_smoke.seeded_model``,
``seeded_pixellink``): 1 warm-up step, then STEPS steps, each split by
CUDA events into forward + loss, backward and optimizer. Prints one JSON
line per turn (the median of each part and of the step) and a summary
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10


def turn(data: str) -> dict:
    """One checkout's step times (run in a child whose sys.path starts
    with that checkout)."""
    import torch

    import chip_smoke as cs
    from gssd_torch.config import LossConfig, OptimConfig
    from gssd_torch.ops.deform_conv import DCN
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.steps import backward, forward_loss, pixellink_forward_loss, update
    from gssd_torch.train_pixellink import parse_args, pixellink_config

    build(KERNELS.values())

    def split(step_parts):
        times = []
        for i in range(STEPS + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            step_parts(i, ev)
            torch.cuda.synchronize()
            times.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        med = {}
        for j, key in enumerate(("forward_loss_ms", "backward_ms", "optimizer_ms")):
            vals = sorted(t[j] for t in times[1:])
            med[key] = vals[len(vals) // 2]
        steps = sorted(sum(t) for t in times[1:])
        med["step_ms"] = steps[len(steps) // 2]
        return med

    out = {}
    model, priors = cs.seeded_model("bfloat16")
    model = model.to("cuda").train()
    priors = torch.tensor(priors, device="cuda")
    batch = cs.fixed_batch(data, cs.TRAIN_BATCH, "cuda")
    opt, ocfg, lcfg = make_optimizer(model, cs._optim()), cs._optim(), LossConfig()

    def gssd_step(i, ev):
        ev[0].record()
        loss_l, loss_c, _ = forward_loss(model, priors, batch, lcfg)
        ev[1].record()
        grads = backward(model, opt, loss_l + loss_c)
        ev[2].record()
        update(opt, grads, ocfg, i)
        ev[3].record()

    for impl in ("hat", "pallas", "fused"):
        for mod in model.modules():
            if isinstance(mod, DCN):
                mod.impl = impl
        out[f"gssd_{impl}_b32"] = split(gssd_step)
    del model, opt, batch
    torch.cuda.empty_cache()

    args = parse_args(["--reference_recipe", "pixellink++"])
    plc = pixellink_config(args)
    pocfg = OptimConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                        gamma=args.gamma, stepvalues=tuple(args.stepvalues),
                        modify_dcn_lr=args.modify_dcn_lr)
    with cs.wide_conv():
        pl = cs.seeded_pixellink("bfloat16").to("cuda").train()
        pbatch = cs.pixellink_batch(data, cs.PL_BATCH, "cuda")
        popt = make_optimizer(pl, pocfg)

        def pl_step(i, ev):
            ev[0].record()
            loss, _ = pixellink_forward_loss(pl, pbatch, plc)
            ev[1].record()
            grads = backward(pl, popt, loss)
            ev[2].record()
            update(popt, grads, pocfg, i)
            ev[3].record()

        out["pixellink_switch_on_b16"] = split(pl_step)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="root of the checkout to compare with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gssd_torch.data import make_synthetic_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    roots = {"baseline": os.path.abspath(args.baseline), "current": ROOT}
    rows = {"baseline": [], "current": []}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "ml")
        make_synthetic_dataset(data, num_subjects=12, slices_per_subject=3, image_size=512,
                               seed=1234)
        for side in ("baseline", "current", "current", "baseline"):
            env = dict(os.environ, PYTHONPATH=roots[side])
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", data],
                                  cwd=roots[side], env=env, capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode:
                print(f"FAIL: the {side} turn failed:\n{proc.stderr[-4000:]}", file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            rows[side].append(res)
            print(json.dumps({"side": side, **res}), flush=True)
    summary = {}
    for key in rows["current"][0]:
        base = [r[key]["step_ms"] for r in rows["baseline"]]
        cur = [r[key]["step_ms"] for r in rows["current"]]
        summary[key] = {"baseline_step_ms": base, "current_step_ms": cur,
                        "ratio": (sum(cur) / len(cur)) / (sum(base) / len(base))}
    print(json.dumps({"power": smi, "steps": STEPS, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
