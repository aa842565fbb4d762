"""Trainer CLI of the port: ``python -m gssd_torch.train``.

One fold of the JAX package's ``train.py``, with its flag names: host
augmentation, SGD with the published LR steps (x0.1 on dcn_* with
``--modify_dcn_lr``), a validation loss every ``--val_every``
iterations, and at the end the model's state_dict as
``<output>/checkpoints/<model_name>/<model_name>_<last iter>_CV0.pt``,
which ``python -m gssd_torch.infer --weights`` loads. Each iteration
prints loss, loss_l, loss_c, lr and ms/step (the step from the batch on
the device to the updated weights, synchronised) and the time spent
waiting for the batch.

Runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given. Cross-validation folds,
resume, test mode, AP/IoBB evaluation, the multi-process loader and
device augmentation are not ported yet (ROADMAP.md) and raise.

Example (GSSD++ on synthetic data):
  python -m gssd_torch.train --reference_recipe gssd++ --synthetic True \
      --batch_size 32 --max_iter 100 --output runs/gssd_pp
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from gssd_torch import resolve_device
from gssd_torch.config import LossConfig, ModelConfig, OptimConfig
from gssd_torch.infer import REFERENCE_RECIPES, str2bool


def build_parser():
    p = argparse.ArgumentParser(description="gssd_torch trainer")
    # data
    p.add_argument("--datapath", default="", type=str)
    p.add_argument("--synthetic", default=False, type=str2bool,
                   help="generate a synthetic ml_ready dataset in place")
    p.add_argument("--load_data_to_ram", default=False, type=str2bool)
    p.add_argument("--num_workers", default=1, type=int)
    p.add_argument("--means", default=0.0, type=float)
    p.add_argument("--use_normalize", default=True, type=str2bool)
    p.add_argument("--p_only", default=False, type=str2bool)
    p.add_argument("--gt_pixel_jitter", default=0.01, type=float)
    p.add_argument("--expand_ratio", default=1.5, type=float)
    p.add_argument("--max_gt", default=16, type=int)
    p.add_argument("--aug_method", default="host",
                   choices=["host", "vanilla", "device", "device_cached"])
    # model
    p.add_argument("--ssd_type", default="gssd", choices=["gssd", "ssd"])
    p.add_argument("--ssd_dim", default=300, type=int)
    p.add_argument("--num_classes", default=2, type=int)
    p.add_argument("--batch_norm", default=True, type=str2bool)
    p.add_argument("--groups_vgg", default=4, type=int)
    p.add_argument("--groups_extra", default=4, type=int)
    p.add_argument("--feature_scale", default=1, type=int)
    p.add_argument("--use_fuseconv", default=True, type=str2bool)
    p.add_argument("--use_self_attention", default=False, type=str2bool)
    p.add_argument("--use_self_attention_base", default=False, type=str2bool)
    p.add_argument("--num_dcn_layers", default=0, type=int)
    p.add_argument("--groups_dcn", default=1, type=int)
    p.add_argument("--dcn_cat_sab", default=False, type=str2bool)
    p.add_argument("--detach_sab", default=False, type=str2bool)
    p.add_argument("--max_pool_factor", default=1, type=int)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--dcn_impl", default="hat", choices=["hat", "xla"])
    # optimization (defaults: the published recipe)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--stepvalues", nargs="*", type=int, default=[30000, 50000])
    p.add_argument("--gamma", default=0.1, type=float)
    p.add_argument("--clip", default=None, type=float)
    p.add_argument("--modify_dcn_lr", default=False, type=str2bool)
    p.add_argument("--ohnm_neg_ratio", default=3, type=int)
    p.add_argument("--jaccard_threshold", default=0.5, type=float)
    # harness
    p.add_argument("--max_iter", default=60000, type=int)
    p.add_argument("--val_every", default=500, type=int,
                   help="validation loss every this many iterations")
    p.add_argument("--speedrun", default=1, type=int,
                   help="no validation before this iteration")
    p.add_argument("--cross_validation", default=1, type=int)
    p.add_argument("--num_test_subjects", default=10, type=int)
    p.add_argument("--resume", default=None, type=int)
    p.add_argument("--seed", default=1111, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="gssd", type=str)
    p.add_argument("--test", default=False, type=str2bool)
    p.add_argument("--ap_list", default="", type=str,
                   help="AP thresholds; AP/IoBB evaluation is not ported yet")
    p.add_argument("--iobb_list", default="", type=str)
    p.add_argument("--reference_recipe", default=None, choices=["gssd", "gssd++"],
                   help="preset the published training flags; explicit "
                        "flags still override")
    p.add_argument("--device", default="cuda", type=str)
    return p


# recipe keys of the evaluation half, which the trainer does not run
_EVAL_KEYS = ("ap_list", "iobb_list", "use_07_metric", "confidence_threshold")


def parse_args(argv=None):
    """Two-pass parse: --reference_recipe installs the published flag
    set as defaults, then anything typed explicitly still wins."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reference_recipe is not None:
        recipe = REFERENCE_RECIPES[args.reference_recipe]
        parser.set_defaults(**{k: v for k, v in recipe.items() if k not in _EVAL_KEYS})
        args = parser.parse_args(argv)
    return args


def _refuse(args) -> None:
    todo = {
        "--cross_validation > 1": args.cross_validation > 1,
        "--resume": args.resume is not None,
        "--test": args.test,
        "AP/IoBB evaluation (--ap_list, --iobb_list)": bool(args.ap_list or args.iobb_list),
        "--aug_method device*": args.aug_method.startswith("device"),
        "--num_workers > 1 (the multi-process loader)": args.num_workers > 1,
    }
    asked = [name for name, on in todo.items() if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported to gssd_torch yet (see ROADMAP.md, "
            "Queue A); use the JAX trainer train.py")


def model_config(args) -> ModelConfig:
    return ModelConfig(
        ssd_type=args.ssd_type, size=args.ssd_dim, num_classes=args.num_classes,
        batch_norm=args.batch_norm, groups_vgg=args.groups_vgg,
        groups_extra=args.groups_extra, feature_scale=args.feature_scale,
        use_fuseconv=args.use_fuseconv, use_self_attention=args.use_self_attention,
        use_self_attention_base=args.use_self_attention_base,
        num_dcn_layers=args.num_dcn_layers, groups_dcn=args.groups_dcn,
        dcn_cat_sab=args.dcn_cat_sab, detach_sab=args.detach_sab,
        max_pool_factor=args.max_pool_factor, compute_dtype=args.compute_dtype,
        dcn_impl=args.dcn_impl)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> Dict[str, Any]:
    """Train; returns {"records": one dict per iteration, "valid": the
    validation losses, "median_step_ms": median ms/step after the first
    step, "weights": path of the saved state_dict}."""
    args = parse_args(argv)
    _refuse(args)
    device = resolve_device(args.device)

    from gssd_torch.data import (BaseTransform, BatchLoader, DataSplitter,
                                 LesionDataset, SSDAugmentation, make_synthetic_dataset)
    from gssd_torch.models import build_model
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.train.steps import eval_step, train_step

    if args.synthetic and not args.datapath:
        args.datapath = os.path.join(args.output, "synthetic_ml_ready")
    if args.synthetic and not os.path.exists(os.path.join(args.datapath, "metadata.txt")):
        print(f"generating synthetic dataset at {args.datapath}")
        make_synthetic_dataset(args.datapath)

    model, priors = build_model(model_config(args), device="cpu", seed=args.seed)
    model = model.to(device)
    priors_t = torch.tensor(priors, device=device)
    loss_cfg = LossConfig(num_classes=args.num_classes, overlap_thresh=args.jaccard_threshold,
                          neg_pos_ratio=args.ohnm_neg_ratio, max_gt_boxes=args.max_gt)
    optim_cfg = OptimConfig(lr=args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay, gamma=args.gamma,
                            stepvalues=tuple(args.stepvalues), clip=args.clip,
                            modify_dcn_lr=args.modify_dcn_lr)
    optimizer = make_optimizer(model, optim_cfg)

    splitter = DataSplitter(args.datapath, args.cross_validation, args.num_test_subjects)
    aug = SSDAugmentation(pixeljitter=args.gt_pixel_jitter, ratio=args.expand_ratio,
                          size=args.ssd_dim, mean=args.means,
                          use_normalize=args.use_normalize, p_only=args.p_only,
                          seed=args.seed)
    train_set = LesionDataset(args.datapath, splitter.data_cv_train[0], transform=aug,
                              load_to_ram=args.load_data_to_ram)
    loader = iter(BatchLoader(train_set, args.batch_size, args.max_gt, seed=args.seed))
    base_tf = BaseTransform(args.ssd_dim, args.means, args.p_only, args.use_normalize)
    valid_loader = iter(BatchLoader(
        LesionDataset(args.datapath, splitter.data_cv_eval[0], transform=base_tf),
        args.batch_size, args.max_gt, seed=args.seed + 100))

    records, valid = [], []
    for it in range(args.max_iter):
        t0 = time.perf_counter()
        batch = to_device(next(loader), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        m = train_step(model, optimizer, priors_t, batch, loss_cfg, optim_cfg, it)
        rec = {"iter": it, **{k: (v if isinstance(v, float) else float(v.item()))
                              for k, v in m.items()}}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["ms"] = (time.perf_counter() - t1) * 1e3
        rec["wait_ms"] = (t1 - t0) * 1e3
        records.append(rec)
        print(f"iter {it}: loss={rec['loss']:.4f} (l={rec['loss_l']:.4f} "
              f"c={rec['loss_c']:.4f}) lr={rec['lr']:.2e} {rec['ms']:.1f} ms/step "
              f"input_wait={rec['wait_ms']:.1f} ms", flush=True)

        last = it == args.max_iter - 1
        if ((it % args.val_every == 0 and it > 0) or last) and it >= args.speedrun:
            vm = eval_step(model, priors_t, to_device(next(valid_loader), device), loss_cfg)
            vrec = {"iter": it, **{k: float(v.item()) for k, v in vm.items()}}
            valid.append(vrec)
            print(f"iter {it} valid: loss={vrec['loss']:.4f} (l={vrec['loss_l']:.4f} "
                  f"c={vrec['loss_c']:.4f})", flush=True)

    ckpt_dir = os.path.join(args.output, "checkpoints", args.model_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    weights = os.path.join(ckpt_dir, f"{args.model_name}_{args.max_iter - 1}_CV0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    steps = [r["ms"] for r in records[1:]] or [r["ms"] for r in records]
    median = statistics.median(steps) if steps else float("nan")
    print(f"median {median:.1f} ms/step after the first step, "
          f"{args.batch_size / median * 1e3:.1f} slices/s (batch {args.batch_size}, "
          f"device {device}); weights -> {weights}", flush=True)
    return {"records": records, "valid": valid, "median_step_ms": median, "weights": weights}
