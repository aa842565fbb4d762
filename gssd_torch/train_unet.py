"""UNet liver-segmentation trainer of the port: ``python -m gssd_torch.train_unet``.

The JAX package's ``train_unet.py`` (:1-189), with its flags and
defaults: UNet (``gssd_torch.models.unet``) on the portal phase's centre
slice (``ct[2, 1]`` of each ml_ready ``{id}_ct.npy``, one input channel)
against the liver mask (``{id}_mask.npy`` > 0); a slice-level holdout of
``--test_size`` and the batch stream drawn with numpy from ``--seed`` (the
training slices in split order, then a permutation each epoch); SGD (lr
1e-4, momentum 0.8, weight decay 5e-4, batch 8, no LR steps) through
``gssd_torch.train.optim`` on the per-batch balanced class-weighted pixel
NLL (background weighted by the foreground fraction fg, the liver by 1 -
fg); every ``--val_every`` iterations and at the last, the validation
loss, ``pixel_acc`` and ``fg_iou`` (logged through
``gssd_torch.utils.logging``) and a checkpoint
``<output>/checkpoints/<model_name>/<model_name>_<iter>_CV0.pt``.
``--resume N`` restores checkpoint N (weights, BatchNorm statistics,
momenta, step) and continues from iteration N with the batch stream
restarted from its beginning, as the JAX trainer does. ``--synthetic``
generates ``gssd_torch.data``'s synthetic set where ``--datapath`` holds
none.

It prints the loss and slices/s every 10th iteration; every iteration is
timed from the batch on the device to the updated weights, synchronised
(``records``). Runs on the GPU (``--device cuda``, the default) and
refuses to start without one unless ``--device cpu`` is given.

Example:
  python -m gssd_torch.train_unet --synthetic True --max_iter 200 --val_every 50
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from gssd_torch import resolve_device
from gssd_torch.infer import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="gssd_torch UNet liver-seg trainer")
    p.add_argument("--datapath", default="", type=str)
    p.add_argument("--synthetic", default=False, type=str2bool)
    p.add_argument("--test_size", default=0.1, type=float,
                   help="validation slice fraction")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--momentum", default=0.8, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--feature_scale", default=1, type=int,
                   help="UNet width divisor (1 = the paper's widths)")
    p.add_argument("--max_iter", default=2000, type=int)
    p.add_argument("--val_every", default=200, type=int)
    p.add_argument("--seed", default=1111, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="unet_liverseg", type=str)
    p.add_argument("--resume", default=None, type=int)
    p.add_argument("--compute_dtype", default="float32", type=str,
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def load_slices(datapath: str) -> Tuple[np.ndarray, np.ndarray]:
    """ml_ready dir -> (images [N, S, S, 1] f32 0..1, masks [N, S, S] int32)."""
    with open(os.path.join(datapath, "metadata.txt")) as f:
        ids = [line.split("|")[0] for line in f.read().splitlines() if line]
    imgs, masks = [], []
    for rel in ids:
        ct = np.load(os.path.join(datapath, rel + "_ct.npy"))
        mask = np.load(os.path.join(datapath, rel + "_mask.npy"))
        imgs.append(ct[2, 1][..., None].astype(np.float32))  # portal, centre
        masks.append((mask > 0).astype(np.int32))
    return np.stack(imgs), np.stack(masks)


def batches(images: np.ndarray, masks: np.ndarray, idx: np.ndarray, bs: int,
            seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches of ``bs`` slices: ``idx`` in order, then a new
    permutation of it each epoch from a generator seeded with ``seed``."""
    g = np.random.default_rng(seed)
    while True:
        for i in range(0, len(idx) - bs + 1, bs):
            sel = idx[i:i + bs]
            yield images[sel], masks[sel]
        idx = g.permutation(idx)


def main(argv=None) -> Dict[str, Any]:
    """Train; returns {"valid": the last validation's loss, pixel_acc and
    fg_iou (as the JAX trainer returns), "evals": every validation with
    its iteration and checkpoint, "records": per iteration its loss, ms
    and input wait, "median_step_ms" (after the first iteration),
    "slices_per_s", "step": SGD steps taken in all, "model",
    "optimizer"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    from gssd_torch.config import OptimConfig
    from gssd_torch.models.unet import UNet, segmentation_nll_loss
    from gssd_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.train.steps import backward, update
    from gssd_torch.utils.logging import MetricsLogger

    if args.synthetic and not args.datapath:
        args.datapath = os.path.join(args.output, "synthetic_ml_ready")
    if args.synthetic and not os.path.exists(os.path.join(args.datapath, "metadata.txt")):
        from gssd_torch.data import make_synthetic_dataset

        print(f"generating synthetic dataset at {args.datapath}")
        make_synthetic_dataset(args.datapath)

    images, masks = load_slices(args.datapath)
    n = len(images)
    order = np.random.default_rng(args.seed).permutation(n)
    n_val = max(1, int(n * args.test_size))
    val_idx, train_idx = order[:n_val], order[n_val:]
    print(f"{len(train_idx)} train / {n_val} valid slices of {images.shape}")

    model = UNet(n_classes=2, feature_scale=args.feature_scale,
                 compute_dtype=args.compute_dtype, seed=args.seed).to(device)
    optim_cfg = OptimConfig(lr=args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay, stepvalues=())
    optimizer = make_optimizer(model, optim_cfg)
    ckpt_dir = os.path.join(args.output, "checkpoints")
    start_iter, step = 0, 0
    if args.resume is not None:
        step = restore_checkpoint(model, optimizer, ckpt_dir, args.model_name, args.resume, 0)
        start_iter = args.resume
        print(f"resumed from iteration {args.resume} (step {step})")

    logger = MetricsLogger(os.path.join(args.output, "logs", args.model_name))
    logger.log_args(vars(args))

    def to_device(x, y):
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def train_step(x, y) -> torch.Tensor:
        model.train()
        # per-batch balanced class weights: background weighted by the
        # foreground fraction, the foreground by the rest
        fg = y.float().mean()
        loss = segmentation_nll_loss(model(x), y, class_weight=torch.stack([fg, 1.0 - fg]))
        update(optimizer, backward(model, optimizer, loss), optim_cfg, step)
        return loss.detach()

    def eval_step(x, y) -> Tuple[float, float, float]:
        model.eval()
        with torch.no_grad():
            out = model(x)
            loss = segmentation_nll_loss(out, y)
            pred = out.argmax(-1)
            acc = (pred == y).float().mean()
            inter = ((pred == 1) & (y == 1)).sum()
            union = ((pred == 1) | (y == 1)).sum()
            return float(loss), float(acc), float(inter / union.clamp(min=1))

    stream = batches(images, masks, train_idx, min(args.batch_size, len(train_idx)), args.seed)
    records, evals, res = [], [], None
    t0, last = time.perf_counter(), start_iter
    try:
        for iteration in range(start_iter, args.max_iter):
            tw = time.perf_counter()
            x, y = to_device(*next(stream))
            ts = time.perf_counter()
            loss = float(train_step(x, y))  # waits for the step's device work
            step += 1
            records.append({"iter": iteration, "loss": loss,
                            "ms": (time.perf_counter() - ts) * 1e3,
                            "wait_ms": (ts - tw) * 1e3})
            if iteration % 10 == 0:
                dt = max(time.perf_counter() - t0, 1e-6)
                print(f"iter {iteration}: loss={loss:.4f} "
                      f"{(iteration - last) * x.shape[0] / dt:.1f} slices/s", flush=True)
                logger.log_scalars("loss", iteration, {"loss": loss})
            if ((iteration % args.val_every == 0 and iteration > start_iter)
                    or iteration == args.max_iter - 1):
                vb = min(args.batch_size, n_val)
                got = [eval_step(*to_device(images[val_idx[i:i + vb]], masks[val_idx[i:i + vb]]))
                       for i in range(0, n_val - vb + 1, vb)]
                res = {key: float(np.mean([g[j] for g in got]))
                       for j, key in enumerate(("loss", "pixel_acc", "fg_iou"))}
                print(f"iter {iteration} valid: {json.dumps(res)}", flush=True)
                logger.log_scalars("valid", iteration, res, file="valid")
                ckpt = save_checkpoint(model, optimizer, step, ckpt_dir, args.model_name,
                                       iteration, 0)
                evals.append({"iter": iteration, **res, "checkpoint": ckpt})
    finally:
        logger.close()

    steps = [r["ms"] for r in records[1:]] or [r["ms"] for r in records]
    median = statistics.median(steps) if steps else float("nan")
    slices = args.batch_size / median * 1e3
    print(f"median {median:.1f} ms/step after the first, {slices:.1f} slices/s (batch "
          f"{args.batch_size}, device {device})", flush=True)
    return {"valid": res, "evals": evals, "records": records, "median_step_ms": median,
            "slices_per_s": slices, "step": step, "model": model, "optimizer": optimizer}


if __name__ == "__main__":
    main()
