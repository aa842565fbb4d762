"""VOC SSD300 trainer of the port: ``python -m gssd_torch.train_voc``.

The JAX package's ``train_voc.py``, with its flags and defaults: the
vanilla SSD300 of the upstream fork (3 input channels, 21 classes, no
grouping, no BatchNorm, no fuse convs: ``ssd_type='ssd', num_phases=1``)
on a VOCdevkit tree (``gssd_torch.data.voc.VOCDataset`` with
``SSDAugmentation`` on its single phase axis, ``BatchLoader``), the
MultiBox loss and SGD with the published LR steps; every
``--val_every`` iterations from ``--speedrun`` on, and at the last, the
VOC mAP of ``--eval_sets`` at IoU 0.5 (``gssd_torch.eval.voc_map``,
difficult objects ignored) and a checkpoint
``<output>/checkpoints/<model_name>/<model_name>_<iter>_CV0.pt``.
``--resume N`` restores checkpoint N (weights, momenta, step) and
continues from iteration N; ``--test True --checkpoint N`` evaluates
checkpoint N.

Data parallelism as in ``gssd_torch.train`` (JAX's ``plan_parallelism(1,
B)``): one process per card, capped by ``GSSD_DP_DEVICES``, each rank on
its rows of every batch (the whole batch drawn and augmented on every
rank), the loss normaliser and the gradients summed over the ranks; the
ranks split each evaluation batch (``parallel.mesh.plan_infer_step``)
and each computes the mAP of the gathered detections, or, where their
count does not divide ``--eval_batch``, rank 0 evaluates alone while the
others wait; rank 0 prints and writes the checkpoints. ``--test`` runs on
the ranks where their count divides ``--eval_batch``, else in one
process.

It prints the loss parts every 10th iteration; every iteration is timed
from the batch on the device to the updated weights, synchronised
(``records``). Runs on the GPU (``--device cuda``, the default) and
refuses to start without one unless ``--device cpu`` is given.

Example:
  python -m gssd_torch.train_voc --voc_root VOCdevkit --max_iter 120000 \\
      --lr 1e-3 --stepvalues 80000 100000
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from gssd_torch import resolve_device
from gssd_torch.infer import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="gssd_torch VOC SSD300 trainer")
    p.add_argument("--voc_root", default="VOCdevkit", type=str)
    p.add_argument("--train_sets", default="2007:trainval", type=str,
                   help="comma list of year:name image sets")
    p.add_argument("--eval_sets", default="2007:val", type=str)
    p.add_argument("--ssd_dim", default=300, type=int)
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--max_gt", default=50, type=int)
    p.add_argument("--means", default=114.0, type=float,
                   help="scalar pixel mean subtracted by the transform")
    p.add_argument("--use_normalize", default=False, type=str2bool)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--stepvalues", nargs="*", type=int, default=[80000, 100000])
    p.add_argument("--gamma", default=0.1, type=float)
    p.add_argument("--ohnm_neg_ratio", default=3, type=int)
    p.add_argument("--max_iter", default=120000, type=int)
    p.add_argument("--val_every", default=5000, type=int)
    p.add_argument("--speedrun", default=1, type=int)
    p.add_argument("--seed", default=1111, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="ssd300_voc", type=str)
    p.add_argument("--resume", default=None, type=int)
    p.add_argument("--compute_dtype", default="bfloat16", type=str,
                   choices=["bfloat16", "float32"])
    p.add_argument("--eval_batch", default=16, type=int)
    p.add_argument("--confidence_threshold", default=0.01, type=float)
    p.add_argument("--use_07_metric", default=True, type=str2bool)
    p.add_argument("--test", default=False, type=str2bool)
    p.add_argument("--checkpoint", default=None, type=int)
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def _sets(spec: str):
    return [tuple(s.split(":")) for s in spec.split(",") if s]


def model_config(args):
    """The vanilla SSD of the upstream fork at ``args``' size and classes."""
    from gssd_torch.config import ModelConfig

    return ModelConfig(ssd_type="ssd", size=args.ssd_dim, num_classes=args.num_classes,
                       num_phases=1, slices_per_phase=3, batch_norm=False, groups_vgg=1,
                       groups_extra=1, use_fuseconv=False, compute_dtype=args.compute_dtype)


def main(argv=None, devices=None) -> Dict[str, Any]:
    """Train (or, with --test, evaluate a checkpoint) over the usable
    devices or ``devices`` (``gssd_torch.train.trainer.launch_trainer``).
    Returns {"voc_map": the last mAP dict ({"map", "ap_<class>"}; None if
    none ran), "evals": every evaluation with its iteration and
    checkpoint, "records": per iteration its loss parts, ms and input
    wait, "median_step_ms" (after the first iteration), "step": SGD steps
    taken in all, "model", "optimizer"}; with --test, {"voc_map": ...};
    from several ranks, rank 0's without "model" and "optimizer", with
    "ranks"."""
    from gssd_torch.train.trainer import launch_trainer

    args = parse_args(argv)
    if args.test and args.checkpoint is None:
        raise ValueError("--test requires --checkpoint")
    return launch_trainer(_train, args, devices)


def _train(rank, args) -> Dict[str, Any]:
    """One rank's run of ``main``."""
    device = resolve_device(args.device)

    from gssd_torch.config import DetectConfig, LossConfig, OptimConfig
    from gssd_torch.data import (BaseTransform, BatchLoader, SSDAugmentation, device_prefetch,
                                 take_rows)
    from gssd_torch.data.voc import VOCDataset
    from gssd_torch.eval.voc_map import run_voc_map
    from gssd_torch.models import build_model
    from gssd_torch.parallel.mesh import plan_infer_step
    from gssd_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.train.steps import make_infer_step, train_step
    from gssd_torch.utils.logging import MetricsLogger, NullLogger

    model, priors = build_model(model_config(args), device="cpu", seed=args.seed)
    model = model.to(device)
    priors_t = torch.tensor(priors, device=device)
    loss_cfg = LossConfig(num_classes=args.num_classes, neg_pos_ratio=args.ohnm_neg_ratio,
                          max_gt_boxes=args.max_gt)
    optim_cfg = OptimConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                            gamma=args.gamma, stepvalues=tuple(args.stepvalues))
    optimizer = make_optimizer(model, optim_cfg)

    base_tf = BaseTransform(args.ssd_dim, args.means, False, args.use_normalize)
    eval_set = VOCDataset(args.voc_root, _sets(args.eval_sets), keep_difficult=False)
    infer_step = plan_infer_step(
        make_infer_step(model, priors_t, DetectConfig(num_classes=args.num_classes)), rank,
        args.eval_batch)
    if rank.first:
        logger = MetricsLogger(os.path.join(args.output, "logs", args.model_name))
        logger.log_args(vars(args))
    else:
        logger = NullLogger()
    ckpt_dir = os.path.join(args.output, "checkpoints")

    def eval_map(iteration):
        res = run_voc_map(lambda batch: infer_step(batch).cpu().numpy(), eval_set, base_tf,
                          args.num_classes, args.confidence_threshold, 0.5,
                          args.use_07_metric, args.eval_batch)
        logger.log_scalars("voc_map", iteration, res, file="test")
        if rank.first:
            print(f"iter {iteration} VOC mAP: {res['map']:.4f}", flush=True)
        return res

    start_iter, step = 0, 0
    if args.resume is not None or args.test:
        start_iter = args.checkpoint if args.test else args.resume
        step = restore_checkpoint(model, optimizer, ckpt_dir, args.model_name, start_iter, 0)
        if rank.first:
            print(f"restored iteration {start_iter} (step {step})")
    if args.test:
        res = eval_map(start_iter)
        if rank.first:
            print(json.dumps(res))
        logger.close()
        return {"voc_map": res}

    aug = SSDAugmentation(pixeljitter=0.0, ratio=1.5, size=args.ssd_dim, mean=args.means,
                          use_normalize=args.use_normalize, seed=args.seed)
    train_set = VOCDataset(args.voc_root, _sets(args.train_sets), transform=aug,
                           keep_difficult=False)
    loader = BatchLoader(train_set, args.batch_size, args.max_gt, seed=args.seed)
    cast = {"image": torch.bfloat16} if args.compute_dtype == "bfloat16" else None
    stream = device_prefetch(take_rows(loader, rank.rows), device, cast=cast)

    records, evals, res = [], [], None
    try:
        for iteration in range(start_iter, args.max_iter):
            tw = time.perf_counter()
            batch = next(stream)
            ts = time.perf_counter()
            m = train_step(model, optimizer, priors_t, batch, loss_cfg, optim_cfg, step)
            m = {k: (v if isinstance(v, float) else float(v.item())) for k, v in m.items()}
            step += 1
            records.append({"iter": iteration, **m, "ms": (time.perf_counter() - ts) * 1e3,
                            "wait_ms": (ts - tw) * 1e3})
            if iteration % 10 == 0 and rank.first:
                logger.log_scalars("loss", iteration, m)
                print(f"iter {iteration}: loss={m['loss']:.4f} (l={m['loss_l']:.4f} "
                      f"c={m['loss_c']:.4f}) {records[-1]['ms']:.1f} ms/step", flush=True)
            last = iteration == args.max_iter - 1
            if ((iteration % args.val_every == 0 and iteration > start_iter)
                    or last) and iteration >= args.speedrun:
                if rank.evaluates(args.eval_batch):
                    res = eval_map(iteration)
                if rank.first:
                    ckpt = save_checkpoint(model, optimizer, step, ckpt_dir, args.model_name,
                                           iteration, 0)
                    print(f"checkpoint -> {ckpt}", flush=True)
                    evals.append({"iter": iteration, "voc_map": res, "checkpoint": ckpt})
                rank.barrier()  # the other ranks wait for the checkpoint
    finally:
        loader.close()
        logger.close()

    steps = [r["ms"] for r in records[1:]] or [r["ms"] for r in records]
    median = statistics.median(steps) if steps else float("nan")
    if rank.first:
        ranks = "" if rank.plan.world_size == 1 else f", {rank.plan.world_size} ranks"
        print(f"median {median:.1f} ms/step after the first, "
              f"{args.batch_size / median * 1e3:.1f} images/s (batch {args.batch_size}, "
              f"device {device}{ranks})", flush=True)
    return {"voc_map": res, "evals": evals, "records": records, "median_step_ms": median,
            "step": step, "model": model, "optimizer": optimizer}


if __name__ == "__main__":
    main()
