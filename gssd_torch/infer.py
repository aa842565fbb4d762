#!/usr/bin/env python
"""Batch inference CLI of the port — the serving surface.

Loads weights and runs forward + softmax + Detect/NMS over an ml_ready
directory (or its test split), writing one JSON of detections per
slice: {"id", "scores", "boxes" [[x1, y1, x2, y2] px]}. Reports the
per-image latency of each batch (host to device copy, forward, Detect
and the copy back); the first batch, which builds the CUDA kernels and
warms the allocator, is left out of the summary.

The weights: ``--weights`` (a file), or a trainer checkpoint as the
JAX package's ``infer.py`` finds it, ``--checkpoint N`` of fold
``--fold f`` under ``--output`` and ``--model_name``:
``<output>/checkpoints/<model_name>/<model_name>_<N>_CV<f>.pt``. A fold
must lie below ``--cross_validation``.

Runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given.

Example (GSSD++, fold 3 of a 5-fold run):
  python -m gssd_torch.infer --reference_recipe gssd++ --cross_validation 5 \
      --datapath <ml_ready> --output runs/gssd_pp --checkpoint 60000 --fold 3 \
      --det_output dets.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from gssd_torch import resolve_device
from gssd_torch.config import DetectConfig, ModelConfig


def str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "1")


def build_parser():
    p = argparse.ArgumentParser(description="gssd_torch serving CLI")
    # data
    p.add_argument("--datapath", default="", type=str)
    p.add_argument("--load_data_to_ram", default=False, type=str2bool)
    p.add_argument("--means", default=0.0, type=float)
    p.add_argument("--use_normalize", default=True, type=str2bool)
    p.add_argument("--p_only", default=False, type=str2bool)
    p.add_argument("--cross_validation", default=1, type=int)
    p.add_argument("--num_test_subjects", default=10, type=int)
    p.add_argument("--split", default="test", choices=["test", "all"])
    p.add_argument("--fold", default=0, type=int,
                   help="the cross-validation fold whose --checkpoint to serve")
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
    # eval / serving
    p.add_argument("--confidence_threshold", default=0.2, type=float)
    p.add_argument("--eval_batch", default=16, type=int)
    p.add_argument("--reference_recipe", default=None,
                   choices=["gssd", "gssd++"],
                   help="preset the published model flags; explicit flags "
                        "still override")
    p.add_argument("--weights", default=None, type=str,
                   help="a .pt state_dict or trainer checkpoint of the port, "
                        "or an .npz of flat '/'-joined flax variables of the "
                        "JAX package")
    p.add_argument("--checkpoint", default=None, type=int,
                   help="serve the trainer's checkpoint of this iteration (and --fold) "
                        "under --output and --model_name")
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="gssd", type=str)
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--det_output", default="detections.json", type=str)
    return p


# Published training commands, verbatim flag sets (the JAX package's
# train.py REFERENCE_RECIPES); the serving parser reads the model and
# eval flags among them.
REFERENCE_RECIPES = {
    "gssd": dict(
        ssd_type="gssd", use_normalize=True,
        use_self_attention=False, use_self_attention_base=False,
        num_dcn_layers=0, dcn_cat_sab=False,
        batch_size=32, max_iter=60000, stepvalues=[30000, 50000],
        gamma=0.1, lr=1e-3, gt_pixel_jitter=0.0, speedrun=4999,
        ohnm_neg_ratio=3, cross_validation=1,
        use_07_metric=False, confidence_threshold=0.2,
        ap_list="0.3,0.5,0.7", iobb_list="0.3,0.5,0.7",
        model_name="GSSD",
    ),
    "gssd++": dict(
        ssd_type="gssd", use_normalize=True,
        use_self_attention=True, use_self_attention_base=True,
        groups_dcn=4, num_dcn_layers=1, dcn_cat_sab=True,
        modify_dcn_lr=True,
        batch_size=32, max_iter=60000, stepvalues=[30000, 50000],
        gamma=0.1, lr=1e-3, gt_pixel_jitter=0.0, speedrun=4999,
        ohnm_neg_ratio=3, cross_validation=1,
        use_07_metric=False, confidence_threshold=0.2,
        ap_list="0.3,0.5,0.7", iobb_list="0.3,0.5,0.7",
        model_name="GSSD_plusplus",
    ),
}


def parse_args(argv=None):
    """Two-pass parse: --reference_recipe installs the published flag
    set as defaults, then anything typed explicitly still wins."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reference_recipe is not None:
        parser.set_defaults(**REFERENCE_RECIPES[args.reference_recipe])
        args = parser.parse_args(argv)
    if (args.weights is None) == (args.checkpoint is None):
        parser.error("give one of --weights and --checkpoint")
    if args.fold and args.checkpoint is None:
        parser.error("--fold picks a trainer checkpoint: give --checkpoint")
    if not 0 <= args.fold < args.cross_validation:
        raise ValueError(f"--fold {args.fold}: a {args.cross_validation}-fold split "
                         f"(--cross_validation) has folds 0..{args.cross_validation - 1}")
    return args


def weights_path(args) -> str:
    """``--weights``, or the trainer checkpoint ``--checkpoint`` of fold
    ``--fold``."""
    if args.weights is not None:
        return args.weights
    from gssd_torch.train.checkpoint import checkpoint_path

    return checkpoint_path(os.path.join(args.output, "checkpoints"), args.model_name,
                           args.checkpoint, args.fold)


def model_config(args) -> ModelConfig:
    return ModelConfig(
        ssd_type=args.ssd_type,
        size=args.ssd_dim,
        num_classes=args.num_classes,
        batch_norm=args.batch_norm,
        groups_vgg=args.groups_vgg,
        groups_extra=args.groups_extra,
        feature_scale=args.feature_scale,
        use_fuseconv=args.use_fuseconv,
        use_self_attention=args.use_self_attention,
        use_self_attention_base=args.use_self_attention_base,
        num_dcn_layers=args.num_dcn_layers,
        groups_dcn=args.groups_dcn,
        dcn_cat_sab=args.dcn_cat_sab,
        detach_sab=args.detach_sab,
        max_pool_factor=args.max_pool_factor,
        compute_dtype=args.compute_dtype,
        dcn_impl=args.dcn_impl,
    )


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Strictly load a .pt (a state_dict, or a trainer checkpoint, whose
    "model" entry is one) or an .npz of flax variables."""
    if path.endswith(".npz"):
        from gssd_torch.params import load_jax_variables

        with np.load(path) as z:
            load_jax_variables(model, {k: z[k] for k in z.files})
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(state.get("model", state), strict=True)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    device = resolve_device(args.device)

    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.models import build_model
    from gssd_torch.train.steps import make_infer_step

    model, priors = build_model(model_config(args), device="cpu")
    weights = weights_path(args)
    print(f"weights: {weights}", flush=True)
    load_weights(model, weights)
    model = model.to(device).eval()
    infer_step = make_infer_step(model, torch.tensor(priors, device=device),
                                 DetectConfig(num_classes=args.num_classes))

    splitter = DataSplitter(args.datapath, args.cross_validation,
                            args.num_test_subjects)
    ids = splitter.data_test if args.split == "test" else (
        splitter.data_train + splitter.data_test)
    ds = LesionDataset(args.datapath, ids, load_to_ram=args.load_data_to_ram)
    tf = BaseTransform(args.ssd_dim, args.means, args.p_only,
                       args.use_normalize)

    images, sizes = [], []
    for i in range(len(ds)):
        raw = ds.pull_image(i)
        x, _, _ = tf(raw)
        p, h, w, c = x.shape
        # phase-major channels: ch = phase * 3 + slice
        images.append(np.transpose(x, (1, 2, 0, 3)).reshape(h, w, p * c))
        sizes.append((raw.shape[2], raw.shape[1]))

    results = []
    lat_ms = []  # per-image latency, one entry per batch after the first
    bs = args.eval_batch
    for start in range(0, len(ds), bs):
        chunk = images[start:start + bs]
        pad = bs - len(chunk)
        batch = np.stack(chunk + [chunk[-1]] * pad).astype(np.float32)
        t0 = time.perf_counter()
        # .cpu() waits for the device: the timing covers the work
        det = infer_step(batch).cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1e3 / len(chunk)
        if start:
            lat_ms.append(dt_ms)
        print(f"im_detect: {min(start + bs, len(ds))}/{len(ds)} "
              f"{dt_ms:.1f} ms/image")
        for bi in range(len(chunk)):
            rows = det[bi, 1]
            rows = rows[rows[:, 0] > args.confidence_threshold]
            W, H = sizes[start + bi]
            results.append({
                "id": ids[start + bi],
                "scores": [float(s) for s in rows[:, 0]],
                "boxes": [
                    [float(r[1] * W), float(r[2] * H),
                     float(r[3] * W), float(r[4] * H)]
                    for r in rows
                ],
            })
    with open(args.det_output, "w") as f:
        json.dump(results, f, indent=1)
    n_det = sum(len(r["scores"]) for r in results)
    if lat_ms:
        print(f"latency: mean {np.mean(lat_ms):.1f} ms/image, "
              f"median {np.median(lat_ms):.1f} ms/image "
              f"(excl. first batch, batch={bs}, device={device})")
    print(f"wrote {len(results)} slices, {n_det} detections "
          f"-> {args.det_output}")
    return {"detections": results, "latency_ms": lat_ms, "weights": weights}


if __name__ == "__main__":
    main()
