"""Trainer CLI of the port: ``python -m gssd_torch.train``.

The JAX package's ``train.py``, with its flag names, for every model
of its ``--ssd_type`` (ssd, gssd and GSSD++, and the FSSD family: fssd,
groupfssd, fusedssd; ``gssd_torch.models.build_model``): k-fold
cross-validation (``--cross_validation K``, K independent folds through
``gssd_torch.parallel.folds``), the training input path of
``--aug_method`` and ``--num_workers``, SGD with the published LR steps
(x0.1 on dcn_* with ``--modify_dcn_lr``) and, every ``--val_every``
iterations from ``--speedrun`` on (and at the last iteration), the
validation loss, the AP/IoBB evaluation of each fold's validation set
and of the test set (logged per fold as ``eval_ap_cv<f>`` and
``test_ap_cv<f>``, and as their means over the folds) and one checkpoint
a fold, ``<output>/checkpoints/<model_name>/<model_name>_<iter>_CV<f>.pt``
(step, model state, optimizer momenta; ``python -m gssd_torch.infer
--weights`` reads it too, ``--checkpoint N --fold f`` finds it).
``--resume N`` restores every fold's checkpoint N and continues from
iteration N at the stored step's LR; ``--test True --checkpoint N``
evaluates each fold's checkpoint N on the test set and prints the mean
over the folds. An iteration takes one SGD step of every fold, fold 0
first; it prints the fold-mean loss parts (and with K > 1 each fold's
loss), lr, the ms from the first batch on the device to the last fold's
updated weights (synchronised) and the time spent waiting for the
batches; slices/s count ``batch_size * K``. Logs go to
``<output>/logs/<model_name>/`` (tab-separated text; TensorBoard too
where it imports).

Per fold f (as the JAX trainer seeds them): the model from
``fold_seed(seed, f)`` (``--seed`` itself for fold 0, so that a one-fold
run is unchanged), the training stream and its augmentation from
``seed + f``, the validation-loss stream from ``seed + 100 + f``.

Input paths (each fold its own): ``--aug_method host`` augments on the
host, in one thread or, with ``--num_workers > 1``, in forked worker
processes whose stream is a function of (seed, batch index); ``device``
loads the raw slices the same ways and augments them on the card;
``device_cached`` keeps the fold's training split on the card and ships
only each batch's indices and scalars. Every path reaches the step
through ``device_prefetch`` (pinned buffers, a side stream, two batches
in flight). ``--profile_dir`` writes a ``torch.profiler`` trace of
iterations start+20 to start+30; ``--warmup_eval`` builds the CUDA
kernels and runs every fold's evaluation step once at startup.

Data parallelism (``gssd_torch.parallel.mesh``, JAX's
``plan_parallelism``): the run spreads over every card, capped by
``GSSD_DP_DEVICES`` (on the CPU, ``GSSD_DP_DEVICES`` gloo ranks), one
process per card, and prints ``parallelism: <plan> layout=<layout>``.
Under ``data`` every rank trains every fold on its rows of the batch;
under ``fold_data`` each fold's ranks split its batch. The ranks compute
what one process computes at the whole batch (BatchNorm statistics,
loss normalisers and gradients over the fold's batch,
``gssd_torch.parallel.collectives``); each draws the whole batch's
stream and keeps its rows. Rank 0 prints and logs the fold means; the
first rank of each fold writes its checkpoints (the one-process format).
The evaluations split too (``parallel.mesh.plan_infer_step``, JAX's
``jit_plan_infer_step``): a fold's ranks share each batch of
``--eval_batch`` and every one of them receives the detections of the
whole batch, so each computes the AP/IoBB of one process; where their
count does not divide ``--eval_batch``, the fold's first rank evaluates
alone while the others wait. ``--test`` runs on the plan's ranks, each
loading every fold's checkpoint in turn, where their count divides
``--eval_batch``, else in one process. A run of several ranks prints
which case it takes (``evaluation: ...``).

``launch_trainer`` (the plan and the ranks), ``prepare`` (device, data
split, logs) and ``run`` (the loop, evaluation, checkpoints, resume,
test mode) are shared with the PixelLink++ trainer,
``gssd_torch.train_pixellink``.

``--test True --visualize True`` first dumps fold 0's checkpoint over
the test set, image by image, into ``<output>/visualize/<model_name>/``
(``gssd_torch.utils.visualize.dump_eval_visuals``: input, gt, the first
DCN layer's offsets and the first map of each attention list as
``.npy``, and the detection and offset overlays as JPEGs). Where
TensorBoard imports, every 100th iteration logs fold 0's batch as a
panel of portal slices with their boxes.

Runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given.

Example (GSSD++ on synthetic data, 5 folds):
  python -m gssd_torch.train --reference_recipe gssd++ --synthetic True \
      --cross_validation 5 --batch_size 32 --max_iter 100 \
      --aug_method device_cached --output runs/gssd_pp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gssd_torch import resolve_device
from gssd_torch.config import DetectConfig, LossConfig, ModelConfig, OptimConfig
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
                   choices=["host", "vanilla", "device", "device_cached"],
                   help="'host'/'vanilla': the numpy pipeline; 'device': the raw slices "
                        "augmented on the card; 'device_cached': the training split held on "
                        "the card, augmented there (caps at GSSD_DEVICE_CACHE_GB)")
    # model
    p.add_argument("--ssd_type", default="gssd",
                   choices=["ssd", "gssd", "fssd", "groupfssd", "fusedssd"],
                   help="ssd (ungrouped), gssd (grouped + fuse convs; GSSD++ with the "
                        "attention/DCN flags), fssd / groupfssd (feature-fusion pyramid), "
                        "fusedssd (deconv conv5_3 -> conv4_3 fusion); the FSSD family "
                        "ignores the attention and DCN flags")
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
    p.add_argument("--dcn_impl", default="hat",
                   choices=["xla", "pallas", "fused", "hat"])
    p.add_argument("--remat_attention", default=False, type=str2bool,
                   help="recompute the attention blocks in the backward")
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
                   help="validation loss, AP/IoBB and a checkpoint every this "
                        "many iterations")
    p.add_argument("--speedrun", default=1, type=int,
                   help="no validation before this iteration")
    p.add_argument("--cross_validation", default=1, type=int)
    p.add_argument("--num_test_subjects", default=10, type=int)
    p.add_argument("--start_iter", default=0, type=int)
    p.add_argument("--resume", default=None, type=int,
                   help="iteration to resume from. Exact resume of the data-stream order "
                        "additionally needs --num_workers > 1 (host augmentation) or --aug_method "
                        "device_cached (their stream is a function of the batch index; the "
                        "thread loader restarts its stream from batch 0)")
    p.add_argument("--seed", default=1111, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="gssd", type=str)
    p.add_argument("--log_iters", default=True, type=str2bool)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace (CPU and CUDA) of iterations 20-30 "
                        "after the start into this directory (Chrome trace JSON)")
    # eval
    p.add_argument("--test", default=False, type=str2bool)
    p.add_argument("--checkpoint", default=None, type=int)
    p.add_argument("--confidence_threshold", default=0.2, type=float)
    p.add_argument("--use_07_metric", default=False, type=str2bool)
    p.add_argument("--ap_list", default="0.3,0.5,0.7", type=str)
    p.add_argument("--iobb_list", default="0.3,0.5,0.7", type=str)
    p.add_argument("--visualize", default=False, type=str2bool)
    p.add_argument("--warmup_eval", default=False, type=str2bool,
                   help="build the CUDA kernels and run the evaluation step and the "
                        "inference forward once at startup")
    p.add_argument("--eval_batch", default=16, type=int,
                   help="inference batch of the AP/IoBB evaluation")
    p.add_argument("--reference_recipe", default=None, choices=["gssd", "gssd++"],
                   help="preset the published training flags; explicit "
                        "flags still override")
    p.add_argument("--device", default="cuda", type=str)
    return p


def parse_args(argv=None):
    """Two-pass parse: --reference_recipe installs the published flag
    set as defaults, then anything typed explicitly still wins."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reference_recipe is not None:
        parser.set_defaults(**REFERENCE_RECIPES[args.reference_recipe])
        args = parser.parse_args(argv)
    return args


def _refuse(args, unported=()) -> None:
    """Raise for the flags a trainer names in ``unported`` and for flag
    sets that cannot run."""
    asked = [f"--{name}" for name in unported if getattr(args, name)]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not supported by this gssd_torch trainer (see "
            "ROADMAP.md)")
    if args.test and args.checkpoint is None:
        raise ValueError("--test requires --checkpoint")
    if args.cross_validation < 1:
        raise ValueError(f"--cross_validation {args.cross_validation}: at least 1 fold")


def _floats(text: str):
    return [float(t) for t in text.split(",") if t.strip()]


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
        dcn_impl=args.dcn_impl, remat_attention=args.remat_attention)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass
class Setup:
    """What every trainer of the port builds before its models: the
    device, the logger, the data split and the evaluation sets (one
    validation set a fold)."""

    device: torch.device
    logger: Any
    splitter: Any
    base_tf: Any
    valid_sets: List[Any]
    test_set: Any
    ckpt_dir: str
    ap_list: List[float]
    iobb_list: List[float]


def synthesize(args) -> None:
    """--synthetic: generate the dataset at --datapath (default
    ``<output>/synthetic_ml_ready``) unless it is there."""
    from gssd_torch.data import make_synthetic_dataset

    if args.synthetic and not args.datapath:
        args.datapath = os.path.join(args.output, "synthetic_ml_ready")
    if args.synthetic and not os.path.exists(os.path.join(args.datapath, "metadata.txt")):
        print(f"generating synthetic dataset at {args.datapath}")
        make_synthetic_dataset(args.datapath)


def _spawned_run(rank, body: Callable, args, wide_conv: bool = False) -> Dict[str, Any]:
    """A spawned rank's run of ``body`` on its own card, with the parent's
    ``USE_WIDE_CONV_KERNEL`` (``wide_conv``; a spawned process starts from
    the module's default): the result without the live objects (models,
    optimizers, fold members), with the rank's kernel launches and a
    digest of each of its trained models' state (parameters, statistics,
    spectral vectors; none after --test)."""
    import copy
    import hashlib

    from gssd_torch.ops import layers
    from gssd_torch.ops.kernels import KERNELS

    layers.USE_WIDE_CONV_KERNEL = wide_conv
    args = copy.copy(args)
    args.device = str(rank.device)
    res = body(rank, args)
    if args.test:  # the folds' AP/IoBB; no model trained
        models, live = [], ()
    else:
        models = [m.model for m in res["folds"]] if "folds" in res else [res["model"]]
        live = ("model", "optimizer", "folds")
    digests = []
    for model in models:
        h = hashlib.sha256()
        for name, t in model.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        digests.append(h.hexdigest())
    out = {k: v for k, v in res.items() if k not in live}
    out.update(launches={name: k.launches for name, k in KERNELS.items()},
               state_digests=digests)
    return out


def launch_trainer(body: Callable, args, devices=None, unported=None) -> Dict[str, Any]:
    """Plan the run over the usable devices (``devices``, a list that may
    name one card twice, takes their place), print the plan as the JAX
    trainers do, and run ``body(rank, args)``: in this process for a plan
    of one rank, else once per rank (``parallel.launch``); with --test,
    on every rank of the plan where their count divides --eval_batch
    (``parallel.mesh.evaluation_plan``), else in this process. A plan of
    several ranks also prints how its evaluations run. Returns the body's
    result; from spawned ranks, rank 0's (without its models) with
    ``"ranks"``: every rank's, each with its kernel launches and
    ``state_digests``. ``unported`` (a tuple) refuses flags first, as
    ``prepare`` does."""
    from gssd_torch.ops import layers
    from gssd_torch.parallel.launch import Rank, launch
    from gssd_torch.parallel.mesh import describe_eval, evaluation_plan, plan_parallelism

    if unported is not None:
        _refuse(args, unported)
    plan = plan_parallelism(getattr(args, "cross_validation", 1), args.batch_size, devices,
                            args.device)
    print(f"parallelism: {plan.describe()} layout={plan.layout}", flush=True)
    if plan.world_size > 1:
        if args.test:
            print(f"--test {describe_eval(plan.world_size, args.eval_batch)}", flush=True)
            plan = evaluation_plan(plan, args.eval_batch)
        else:
            print(describe_eval(plan.n_data, args.eval_batch), flush=True)
    if plan.world_size == 1:
        return body(Rank(plan), args)
    if hasattr(args, "synthetic"):
        synthesize(args)
    results = launch(_spawned_run, plan, body, args, layers.USE_WIDE_CONV_KERNEL)
    return {**results[0], "ranks": results}


def prepare(args, rank, unported=()) -> Setup:
    """Refuse the flags named in ``unported``,
    resolve the device (no card, no run unless --device cpu), generate
    the synthetic set if asked, open the logs and split the data into
    ``--cross_validation`` folds and the test set. Of the ranks
    (``gssd_torch.parallel.launch.Rank``), only the first of a fold's
    ranks logs, and only rank 0 writes the arguments."""
    _refuse(args, unported)
    device = resolve_device(args.device)
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.utils.logging import MetricsLogger, NullLogger

    synthesize(args)
    if rank.leader:
        logger = MetricsLogger(os.path.join(args.output, "logs", args.model_name))
    else:
        logger = NullLogger()
    if rank.first:
        logger.log_args(vars(args))
    splitter = DataSplitter(args.datapath, args.cross_validation, args.num_test_subjects)
    return Setup(device, logger, splitter,
                 BaseTransform(args.ssd_dim, args.means, args.p_only, args.use_normalize),
                 [LesionDataset(args.datapath, ids) for ids in splitter.data_cv_eval],
                 LesionDataset(args.datapath, splitter.data_test),
                 os.path.join(args.output, "checkpoints"),
                 _floats(args.ap_list), _floats(args.iobb_list))


# the iterations (counted from the first of the run) that --profile_dir
# traces: from the first, up to but not including the second, or through
# the last iteration of the run
PROFILE_WINDOW = (20, 30)


def train_batches(args, setup: Setup, train_tf, collate_fn: Callable, fold: int = 0,
                  rows: Optional[slice] = None):
    """The training batch stream of ``fold`` (its training split, seed
    ``--seed + fold``) for ``--aug_method`` and ``--num_workers``, each
    batch's tensors on the device -> (iterator, the loaders to close, a
    line naming the path). A data-parallel rank passes its ``rows``: the
    stream draws the whole batch (indices, augmentation draws) as every
    rank does, and only those rows are kept, augmented on the card and
    copied there.

    The multi-process loader and the device cache start at batch
    ``--resume`` (or ``--start_iter``), so a resumed run sees the batches
    the uninterrupted one would have; the thread loader restarts its
    stream. Host images travel to the card in the model's compute dtype
    (the model's first op casts to it, so the bits are the same)."""
    from gssd_torch.data import (BatchLoader, DeviceAugmentation, DeviceCacheLoader,
                                 LesionDataset, MPBatchLoader, collate_raw, device_prefetch,
                                 take_rows)

    device, ids = setup.device, setup.splitter.data_cv_train[fold]
    seed = args.seed + fold
    start = args.resume or getattr(args, "start_iter", 0) or 0
    aug_method = getattr(args, "aug_method", "host")
    if aug_method == "device_cached":
        cached = DeviceCacheLoader(
            LesionDataset(args.datapath, ids), args.batch_size, size=args.ssd_dim,
            max_gt=args.max_gt, seed=seed, pixeljitter=args.gt_pixel_jitter,
            ratio=args.expand_ratio, mean=args.means, use_normalize=args.use_normalize,
            start_batch=start, device=device, rows=rows)
        return (device_prefetch(cached, device), [],
                f"device_cached: {len(ids)} slices, {cached.cache.nbytes / 2**20:.1f} MiB "
                f"uint8 on {cached.cache.device}, from batch {start}")
    on_device = aug_method == "device"
    dataset = LesionDataset(args.datapath, ids, transform=None if on_device else train_tf,
                            load_to_ram=args.load_data_to_ram)
    collate_fn = collate_raw if on_device else collate_fn
    if args.num_workers > 1:
        loader = MPBatchLoader(dataset, args.batch_size, args.max_gt, seed=seed,
                               collate_fn=collate_fn, num_workers=args.num_workers,
                               start_batch=start)
        how = f"{args.num_workers} worker processes, from batch {start}"
    else:
        loader = BatchLoader(dataset, args.batch_size, args.max_gt, seed=seed,
                             collate_fn=collate_fn)
        how = "one thread, from the stream's first batch"
    cast = {"image": torch.bfloat16} if args.compute_dtype == "bfloat16" else None
    # the device augmentation draws every item's geometry from the lists
    lists = ("boxes_list", "labels_list") if on_device else ()
    batches = device_prefetch(take_rows(loader, rows, keep=lists), device, cast=cast)
    if on_device:
        aug = DeviceAugmentation(
            size=args.ssd_dim, src_size=dataset.pull_image(0).shape[1],
            pixeljitter=args.gt_pixel_jitter, ratio=args.expand_ratio, mean=args.means,
            use_normalize=args.use_normalize, seed=seed, max_gt=args.max_gt,
            device=device)
        batches = (aug(b["raw_image"], b["boxes_list"], b["labels_list"], rows)
                   for b in batches)
    return batches, [loader], f"{aug_method}: {how}"


def visualize_set(dataset, base_tf, out_dir: str, predict: Callable, gt_scale: Callable,
                  conf_threshold: float, image_size: int) -> Dict[int, np.ndarray]:
    """The --visualize dumps of one model over ``dataset``, one image at a
    time, as the JAX trainers write them: ``predict([1, H, W, 12] f32)``
    -> (detections [C, K, 5] normalised, host numpy; the aux lists on the
    device), the gt boxes scaled into input pixels by ``gt_scale(raw
    image)``. Only what the dump writes is copied to the host: the first
    map of each aux list, in f32. Returns {index: detections}."""
    from gssd_torch.utils.visualize import dump_eval_visuals

    dets = {}
    for idx in range(len(dataset)):
        raw = dataset.pull_image(idx)
        anno = dataset.pull_anno(idx)
        x, _, _ = base_tf(raw)
        p, h, w, c = x.shape
        img = np.transpose(x, (1, 2, 0, 3)).reshape(h, w, p * c)
        det, aux = predict(img[None].astype(np.float32))
        maps = {k: [v[0][0].float().cpu().numpy()] for k, v in aux.items() if v}
        dump_eval_visuals(out_dir, idx, img, anno[:, :4] * gt_scale(raw), det,
                          offsets=maps.get("offsets"), attn=maps.get("attn"),
                          attn_base=maps.get("attn_base"), conf_threshold=conf_threshold,
                          image_size=image_size)
        dets[idx] = det
    print(f"visualize dumps written to {out_dir}", flush=True)
    return dets


def log_input_grid(logger, iteration: int, batch: Dict[str, torch.Tensor]) -> None:
    """Fold 0's batch as a panel of portal slices with their boxes
    (``input_grid_with_boxes``), to TensorBoard where it imports."""
    if logger.tb is None:
        return
    from gssd_torch.utils.visualize import input_grid_with_boxes

    images, boxes = (batch[key].float().cpu().numpy() for key in ("image", "boxes"))
    panel = input_grid_with_boxes(images, boxes, batch["valid"].cpu().numpy())
    logger.log_image("inputs/train_fold0", iteration, panel)


def _profile_start(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _profile_stop(prof, directory: str, first: int, last: int) -> str:
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_iter{first}-{last}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace of iterations {first}-{last} written to {path}", flush=True)
    return path


def run(args, setup: Setup, make_fold: Callable, collate_fn: Callable,
        parts: Tuple[Tuple[str, str], ...], rank, warm: Optional[Callable] = None,
        input_grid: bool = False) -> Dict[str, Any]:
    """The loop every trainer of the port shares, or with --test the
    evaluation of every fold's checkpoint.

    ``make_fold(f)`` builds fold f's ``FoldMember`` (its model, optimizer,
    step and evaluation closures and the transforms of its loaders; see
    ``gssd_torch.parallel.folds``); ``collate_fn`` stacks the loaders'
    items; ``parts`` names the loss parts to print as (label, key);
    ``warm(members)``, if given, runs once before the first iteration;
    ``input_grid`` logs fold 0's batch as an image every 100 iterations
    (TensorBoard only). With --test --visualize, fold 0's ``visualize``
    dumps the test set first.
    A record's ``wait_ms`` is the host time blocked on the folds' next
    batches, ``ms`` the K steps after it, synchronised; its metrics are
    the means over the folds, ``folds`` holds each fold's.

    ``rank`` (``gssd_torch.parallel.launch.Rank``) builds and trains only
    its folds, on its rows of each batch; the folds' metrics are gathered
    so that every rank holds the records of the one-process run, which
    rank 0 prints and logs. The ranks of a fold run its evaluations
    together where ``rank.evaluates`` (a ``make_fold`` splits the
    forward with ``parallel.mesh.plan_infer_step``), else its first rank
    alone; the first rank writes the fold's checkpoint, and every rank
    waits for every fold's. With --test, every rank evaluates every fold
    (``launch_trainer``) and only rank 0 prints and visualizes."""
    from gssd_torch.data import BatchLoader, LesionDataset, take_rows
    from gssd_torch.parallel.folds import fold_mean, fold_train_step
    from gssd_torch.train.checkpoint import (checkpoint_path, load_weights_partial,
                                             restore_checkpoint, save_checkpoint)

    device, logger, ckpt_dir = setup.device, setup.logger, setup.ckpt_dir
    k = args.cross_validation
    if args.test:
        # one model serves every fold's checkpoint in turn: a checkpoint of
        # the port holds the whole state, and what a partial load skips
        # keeps the initialisation of --seed, as the JAX trainer's does
        member, results, visualized = make_fold(0), [], None
        for f in range(k):
            load_weights_partial(member.model, checkpoint_path(ckpt_dir, args.model_name,
                                                               args.checkpoint, f))
            if args.visualize and f == 0 and rank.first:
                out_dir = os.path.join(args.output, "visualize", args.model_name)
                visualized = {"dir": out_dir,
                              "detections": member.visualize(setup.test_set, out_dir)}
            res = member.evaluate(setup.test_set, f"test_ap_cv{f}", args.checkpoint)
            if rank.first:
                print(f"[fold {f}] {res}")
            results.append(res)
        mean = fold_mean(results)
        if rank.first:
            print("test mean over folds:", json.dumps(mean), flush=True)
        logger.close()
        return {"test": mean, "folds": results, "visualized": visualized}

    members = [make_fold(f) for f in rank.folds]
    start_iter = getattr(args, "start_iter", 0)
    if args.resume is not None:
        for m in members:
            m.step = restore_checkpoint(m.model, m.optimizer, ckpt_dir, args.model_name,
                                        args.resume, m.fold)
        start_iter = args.resume
        steps = members[0].step if k == 1 else [m.step for m in members]
        if rank.first:
            print(f"resumed from iteration {args.resume} (step {steps})")
    if warm is not None:
        warm(members)

    streams, valid_streams, loaders = [], [], []
    for m in members:
        batches, fold_loaders, path = train_batches(args, setup, m.train_tf, collate_fn, m.fold,
                                                    rank.rows)
        if rank.leader:
            print(f"input{'' if k == 1 else f' (fold {m.fold})'}: {path}", flush=True)
        valid_loader = BatchLoader(
            LesionDataset(args.datapath, setup.splitter.data_cv_eval[m.fold],
                          transform=m.valid_tf),
            args.batch_size, args.max_gt, seed=args.seed + 100 + m.fold, collate_fn=collate_fn)
        streams.append(batches)
        valid_streams.append(take_rows(valid_loader, rank.rows))
        loaders += fold_loaders + [valid_loader]

    def split(rec):
        return " ".join(f"{label}={rec[key]:.4f}" for label, key in parts)

    def scalars(metrics):
        return {key: (v if isinstance(v, float) else float(v.item())) for key, v in metrics.items()}

    def iteration(it):
        t0 = time.perf_counter()
        batches = [next(s) for s in streams]
        t1 = time.perf_counter()
        own = {m.fold: scalars(out) for m, out in zip(members, fold_train_step(members, batches))}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t1) * 1e3
        folds = rank.fold_values(own)
        rec = {"iter": it, **fold_mean(folds), "folds": folds, "ms": ms,
               "wait_ms": (t1 - t0) * 1e3}
        records.append(rec)
        if rank.first:
            each = "" if k == 1 else " folds [" + " ".join(f"{f['loss']:.4f}" for f in folds) + "]"
            print(f"iter {it}: loss={rec['loss']:.4f} ({split(rec)}){each} lr={rec['lr']:.2e} "
                  f"{rec['ms']:.1f} ms/{'step' if k == 1 else f'iteration ({k} steps)'} "
                  f"input_wait={rec['wait_ms']:.1f} ms", flush=True)
            if getattr(args, "log_iters", True) and it % 10 == 0:
                keys = ("loss", *(key for _, key in parts), "lr", "grad_norm")
                logger.log_scalars("loss", it, {key: rec[key] for key in keys})
            if input_grid and it % 100 == 0:
                log_input_grid(logger, it, batches[0])
        evaluate_and_save(it)

    def evaluate_and_save(it):
        last = it == args.max_iter - 1
        if not (((it % args.val_every == 0 and it > start_iter) or last)
                and it >= args.speedrun):
            return
        vfolds = rank.fold_values({m.fold: scalars(m.valid_fn(to_device(next(vs), device)))
                                   for m, vs in zip(members, valid_streams)})
        vrec = fold_mean(vfolds)
        valid.append({"iter": it, **vrec, "folds": vfolds})
        if rank.first:
            logger.log_scalars("eval_loss", it, vrec, file="valid")
            print(f"iter {it} valid: loss={vrec['loss']:.4f} ({split(vrec)})", flush=True)
        own = {}
        for m in members if rank.evaluates(args.eval_batch) else ():
            res_v = m.evaluate(setup.valid_sets[m.fold], f"eval_ap_cv{m.fold}", it)
            res_t = m.evaluate(setup.test_set, f"test_ap_cv{m.fold}", it)
            if not rank.leader:
                continue
            ckpt = save_checkpoint(m.model, m.optimizer, m.step, ckpt_dir, args.model_name,
                                   it, m.fold)
            own[m.fold] = {"valid": res_v, "test": res_t, "checkpoint": ckpt}
            if k > 1:
                print(f"iter {it} fold {m.fold} valid: {json.dumps(res_v)} test: "
                      f"{json.dumps(res_t)}")
        # every rank waits here for the folds' checkpoints (and, where a
        # fold's first rank evaluates alone, for its evaluations)
        per_fold = rank.fold_values(own, sync=True)
        mean_v = fold_mean([p["valid"] for p in per_fold])
        mean_t = fold_mean([p["test"] for p in per_fold])
        evals.append({"iter": it, "valid": mean_v, "test": mean_t,
                      "checkpoint": per_fold[0]["checkpoint"], "folds": per_fold})
        if not rank.first:
            return
        logger.log_scalars("eval_ap", it, mean_v, file="valid")
        logger.log_scalars("test_ap", it, mean_t, file="test")
        print(f"iter {it} valid: {json.dumps(mean_v)}")
        print(f"iter {it} test:  {json.dumps(mean_t)}")
        for p in per_fold:
            print(f"checkpoint -> {p['checkpoint']}", flush=True)

    records, valid, evals, traces = [], [], [], []
    prof = None
    try:
        for it in range(start_iter, args.max_iter):
            if args.profile_dir and rank.first and it - start_iter == PROFILE_WINDOW[0]:
                prof, first = _profile_start(device), it
            if prof is None:
                iteration(it)
                continue
            with torch.profiler.record_function("train_iteration"):
                iteration(it)
            if it + 1 - start_iter == PROFILE_WINDOW[1] or it == args.max_iter - 1:
                traces.append(_profile_stop(prof, args.profile_dir, first, it))
                prof = None
    finally:
        if prof is not None:
            prof.stop()
        for lo in loaders:
            lo.close()
        logger.close()

    steps = [r["ms"] for r in records[1:]] or [r["ms"] for r in records]
    median = statistics.median(steps) if steps else float("nan")
    slices = args.batch_size * k / median * 1e3
    what = "step" if k == 1 else f"iteration ({k} folds)"
    if rank.first:
        ranks = "" if rank.plan.world_size == 1 else f", {rank.plan.world_size} ranks"
        print(f"median {median:.1f} ms/{what} after the first, {slices:.1f} slices/s (batch "
              f"{args.batch_size}{'' if k == 1 else f' x {k} folds'}, device {device}{ranks})",
              flush=True)
    return {"records": records, "valid": valid, "evals": evals, "median_step_ms": median,
            "slices_per_s": slices,
            "weights": evals[-1]["checkpoint"] if evals else None, "step": members[0].step,
            "traces": traces, "model": members[0].model, "optimizer": members[0].optimizer,
            "folds": members}


def warm_eval(args, members, device, rank) -> None:
    """--warmup_eval: build the CUDA kernels, then run every fold's
    validation-loss step on a batch of ``--batch_size`` (the rank's rows
    of it) and fold 0's inference step on the rows of ``--eval_batch``
    that the rank's forward takes (zeros; its share where the fold's
    ranks split the evaluation), as the JAX trainer warms its vmapped
    evaluation step and fold 0's inference, so that the first evaluation
    pays for neither. Eval mode: no model's state changes."""
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.parallel.mesh import eval_splits

    if device.type == "cuda":
        build(KERNELS.values())
    size, channels = args.ssd_dim, model_config(args).in_channels
    b, g = args.batch_size // rank.plan.n_data, args.max_gt
    share = args.eval_batch // rank.plan.n_data \
        if eval_splits(rank.plan.n_data, args.eval_batch) else args.eval_batch
    batch = {
        "image": torch.zeros((b, size, size, channels), device=device),
        "boxes": torch.tensor([0.3, 0.3, 0.6, 0.6], device=device).repeat(b, g, 1),
        "labels": torch.zeros((b, g), dtype=torch.int32, device=device),
        "valid": torch.ones((b, g), dtype=torch.bool, device=device)}
    for member in members:
        member.valid_fn(batch)
    members[0].infer(torch.zeros((share, size, size, channels)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("eval executables warmed", flush=True)


def main(argv=None, devices=None) -> Dict[str, Any]:
    """Train (or, with --test, evaluate a checkpoint) over the usable
    devices, or over ``devices`` (see ``launch_trainer``; a list that may
    name one card twice). Returns {"records":
    one dict per iteration (the fold means, and "folds": each fold's),
    "valid": the validation losses, "evals": per evaluation the
    iteration, the fold-mean valid and test AP/IoBB, fold 0's checkpoint
    and "folds": each fold's AP/IoBB and checkpoint, "median_step_ms":
    median ms an iteration after the first, "slices_per_s": batch x K
    over it, "weights": fold 0's last checkpoint (None if none), "step":
    SGD steps taken by each fold, "traces": the --profile_dir trace files
    written, "model", "optimizer": fold 0's, "folds": every fold's
    ``FoldMember``}; with --test, {"test": the mean over the folds of the
    checkpoints' AP/IoBB, "folds": each fold's, "visualized": with
    --visualize {"dir": the dump directory, "detections": {test index:
    fold 0's detections [C, K, 5]}}, else None}. A run of several ranks
    returns rank 0's dict without "model", "optimizer" and the fold
    members, with "ranks" (``launch_trainer``)."""
    return launch_trainer(_train, parse_args(argv), devices, unported=())


def _train(rank, args) -> Dict[str, Any]:
    """One rank's run of ``main``."""
    setup = prepare(args, rank)

    from gssd_torch.data import SSDAugmentation, collate
    from gssd_torch.eval import run_detection_eval
    from gssd_torch.models import build_model
    from gssd_torch.parallel.folds import FoldMember, fold_seed
    from gssd_torch.parallel.mesh import plan_infer_step
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.train.steps import (eval_step, make_infer_step, make_infer_step_with_aux,
                                        train_step)

    device, logger = setup.device, setup.logger
    loss_cfg = LossConfig(num_classes=args.num_classes, overlap_thresh=args.jaccard_threshold,
                          neg_pos_ratio=args.ohnm_neg_ratio, max_gt_boxes=args.max_gt)
    optim_cfg = OptimConfig(lr=args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay, gamma=args.gamma,
                            stepvalues=tuple(args.stepvalues), clip=args.clip,
                            modify_dcn_lr=args.modify_dcn_lr)
    def make_fold(f):
        model, priors = build_model(model_config(args), device="cpu",
                                    seed=fold_seed(args.seed, f))
        model = model.to(device)
        priors_t = torch.tensor(priors, device=device)
        optimizer = make_optimizer(model, optim_cfg)
        detect_cfg = DetectConfig(num_classes=args.num_classes)
        infer_step = make_infer_step(model, priors_t, detect_cfg)
        split_step = plan_infer_step(infer_step, rank, args.eval_batch)

        def evaluate(dataset, tag, iteration):
            sink: Dict[str, np.ndarray] = {}
            res = run_detection_eval(
                lambda batch: split_step(batch).cpu().numpy(), dataset, setup.base_tf,
                setup.ap_list, setup.iobb_list, args.confidence_threshold,
                args.use_07_metric, args.eval_batch, score_sink=sink)
            logger.log_scalars(tag, iteration, res, file="test")
            logger.log_histogram(f"{tag}/scores_raw", iteration, sink["raw"])
            logger.log_histogram(f"{tag}/scores_filtered", iteration, sink["filtered"])
            return res

        def visualize(dataset, out_dir):
            vstep = make_infer_step_with_aux(model, priors_t, detect_cfg)

            def predict(img):
                det, aux = vstep(img)
                return det[0].cpu().numpy(), aux

            return visualize_set(dataset, setup.base_tf, out_dir, predict,
                                 lambda raw: args.ssd_dim / raw.shape[1],
                                 args.confidence_threshold, args.ssd_dim)

        aug = SSDAugmentation(pixeljitter=args.gt_pixel_jitter, ratio=args.expand_ratio,
                              size=args.ssd_dim, mean=args.means,
                              use_normalize=args.use_normalize, p_only=args.p_only,
                              seed=args.seed + f)
        return FoldMember(
            f, model, optimizer,
            lambda batch, step: train_step(model, optimizer, priors_t, batch, loss_cfg,
                                           optim_cfg, step),
            lambda batch: eval_step(model, priors_t, batch, loss_cfg),
            evaluate, aug, setup.base_tf, infer=infer_step, visualize=visualize)

    def warm(members):
        warm_eval(args, members, device, rank)

    warming = (args.warmup_eval and not args.test and args.val_every <= args.max_iter
               and args.speedrun <= args.max_iter)
    return run(args, setup, make_fold, collate, (("l", "loss_l"), ("c", "loss_c")), rank,
               warm if warming else None, input_grid=True)
