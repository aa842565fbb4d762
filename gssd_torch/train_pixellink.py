"""PixelLink++ trainer of the port: ``python -m gssd_torch.train_pixellink``.

The JAX package's ``train_pixellink.py``, with its flag names and
recipes (``--reference_recipe pixellink++``: batch 16, lr
5e-4, no LR steps, x0.1 LR on dcn_*, attention recomputed in the
backward): host augmentation with the pixel/link target maps, the 2:1
weighted pixel and link loss, and every ``--val_every`` iterations from
``--speedrun`` on (and at the last iteration) the validation loss, the
AP/IoBB evaluation of the validation and test sets through the
union-find mask decoder, and a checkpoint a fold
``<output>/checkpoints/<model_name>/<model_name>_<iter>_CV<f>.pt``.
``--cross_validation K`` trains K independent folds side by side
(``gssd_torch.parallel.folds``; fold f's augmentation seeded with
``seed + f``, its validation targets' with ``seed + 100 + f``, as in the
JAX trainer) and logs the means over the folds. ``--resume N`` continues
every fold from checkpoint N; ``--test True --checkpoint N`` evaluates
each fold's checkpoint N on the test set and prints their mean. The
loop, checkpoints and logs are ``gssd_torch.train.trainer``'s, and so
is the data parallelism (one process per card, capped by
``GSSD_DP_DEVICES``; the ``parallelism:`` line), the evaluation forward
split over a fold's ranks included (the pixel and link logits gathered
in row order on the device before the host decode).

Runs on the GPU (``--device cuda``, the default) and refuses to start
without one unless ``--device cpu`` is given. ``--num_workers > 1``
builds the batches in forked worker processes, a stream that
``--resume`` continues exactly. ``--test True --visualize True`` dumps
fold 0's checkpoint over the test set as the GSSD trainer does, the
decoded boxes packed into the Detect [C, K, 5] contract (class 1,
normalised). ``--profile_dir`` and ``--warmup_eval``, which the JAX
package's PixelLink trainer does not have, raise. The stem's wide-conv kernels run only when
``gssd_torch.ops.layers.USE_WIDE_CONV_KERNEL`` is set in-process, as
``USE_PALLAS_WIDE_CONV`` is in the JAX package.

Example (PixelLink++ on synthetic data):
  python -m gssd_torch.train_pixellink --reference_recipe pixellink++ \\
      --synthetic True --max_iter 100 --output runs/pixellink_pp
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from gssd_torch.config import OptimConfig, PixelLinkConfig
from gssd_torch.infer import str2bool
from gssd_torch.train.trainer import launch_trainer, prepare, run, visualize_set

# the JAX package's recipes (train_pixellink.py REFERENCE_RECIPES):
# 'pixellink' is the ungrouped baseline, 'pixellink++' adds grouped convs,
# channel fusion, spectral-norm self-attention and the attention-guided DCN
REFERENCE_RECIPES = {
    "pixellink": dict(
        vgg_groups=1, use_fuseconv=False,
        use_self_attention=False, use_self_attention_base=False,
        num_dcn_layers=0, groups_dcn=1, dcn_cat_sab=False,
        batch_size=16, lr=5e-4, max_iter=10001, val_every=500,
        stepvalues=[], use_normalize=True,
        use_07_metric=False, confidence_threshold=0.01,
        model_name="pixellink",
    ),
    "pixellink++": dict(
        vgg_groups=4, use_fuseconv=True,
        use_self_attention=True, use_self_attention_base=True,
        num_dcn_layers=1, groups_dcn=4, dcn_cat_sab=True,
        modify_dcn_lr=True,
        batch_size=16, lr=5e-4, max_iter=10001, val_every=500,
        stepvalues=[], use_normalize=True,
        use_07_metric=False, confidence_threshold=0.01,
        model_name="pixellink_plusplus",
    ),
}


def build_parser():
    p = argparse.ArgumentParser(description="gssd_torch PixelLink trainer")
    p.add_argument("--datapath", default="", type=str)
    p.add_argument("--synthetic", default=False, type=str2bool)
    p.add_argument("--load_data_to_ram", default=False, type=str2bool)
    p.add_argument("--num_workers", default=1, type=int)
    p.add_argument("--means", default=0.0, type=float)
    p.add_argument("--use_normalize", default=True, type=str2bool)
    p.add_argument("--p_only", default=False, type=str2bool)
    p.add_argument("--gt_pixel_jitter", default=0.01, type=float)
    p.add_argument("--expand_ratio", default=1.5, type=float)
    p.add_argument("--max_gt", default=16, type=int)
    p.add_argument("--ssd_dim", default=300, type=int)
    # PixelLink architecture
    p.add_argument("--version", default="4s", choices=["2s", "4s"])
    p.add_argument("--cascade_fuse", default=False, type=str2bool)
    p.add_argument("--batch_norm", default=True, type=str2bool)
    p.add_argument("--use_fuseconv", default=True, type=str2bool)
    p.add_argument("--use_self_attention", default=False, type=str2bool)
    p.add_argument("--use_self_attention_base", default=False, type=str2bool)
    p.add_argument("--num_dcn_layers", default=0, type=int)
    p.add_argument("--groups_dcn", default=1, type=int)
    p.add_argument("--dcn_cat_sab", default=False, type=str2bool)
    p.add_argument("--detach_sab", default=False, type=str2bool)
    p.add_argument("--max_pool_factor", default=1, type=int)
    p.add_argument("--remat_attention", default=True, type=str2bool,
                   help="recompute the attention blocks in the backward")
    p.add_argument("--vgg_groups", default=4, type=int)
    p.add_argument("--feature_scale", default=1, type=int)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--dcn_impl", default="hat", choices=["xla", "pallas", "fused", "hat"])
    p.add_argument("--pixel_weight", default=2.0, type=float)
    p.add_argument("--link_weight", default=1.0, type=float)
    p.add_argument("--neg_pos_ratio", default=3, type=int)
    # optimization / harness
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    # no LR decay by default: an empty list
    p.add_argument("--stepvalues", nargs="*", type=int, default=[])
    p.add_argument("--gamma", default=0.1, type=float)
    p.add_argument("--clip", default=None, type=float)
    p.add_argument("--modify_dcn_lr", default=False, type=str2bool)
    p.add_argument("--max_iter", default=10001, type=int)
    p.add_argument("--val_every", default=500, type=int)
    p.add_argument("--speedrun", default=1, type=int)
    p.add_argument("--cross_validation", default=1, type=int)
    p.add_argument("--num_test_subjects", default=10, type=int)
    p.add_argument("--resume", default=None, type=int,
                   help="iteration to resume from; --num_workers > 1 also resumes the "
                        "batch stream exactly")
    p.add_argument("--seed", default=1115, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--model_name", default="pixellink", type=str)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="refused: the JAX package's PixelLink trainer has no trace")
    p.add_argument("--test", default=False, type=str2bool)
    p.add_argument("--checkpoint", default=None, type=int)
    p.add_argument("--confidence_threshold", default=0.01, type=float)
    p.add_argument("--use_07_metric", default=False, type=str2bool)
    p.add_argument("--ap_list", default="0.5", type=str)
    p.add_argument("--iobb_list", default="0.5", type=str)
    p.add_argument("--eval_batch", default=16, type=int,
                   help="inference batch of the AP/IoBB evaluation")
    p.add_argument("--warmup_eval", default=False, type=str2bool,
                   help="refused: the JAX package's PixelLink trainer has no warm-up")
    p.add_argument("--visualize", default=False, type=str2bool)
    p.add_argument("--reference_recipe", default=None, choices=["pixellink", "pixellink++"],
                   help="preset the published training flags; explicit flags still override")
    p.add_argument("--device", default="cuda", type=str)
    return p


def parse_args(argv=None):
    """Two-pass parse: --reference_recipe installs its flag set as
    defaults, then anything typed explicitly still wins."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reference_recipe is not None:
        parser.set_defaults(**REFERENCE_RECIPES[args.reference_recipe])
        args = parser.parse_args(argv)
    return args


def pixellink_config(args) -> PixelLinkConfig:
    return PixelLinkConfig(
        version=args.version, pixel_weight=args.pixel_weight, link_weight=args.link_weight,
        neg_pos_ratio=args.neg_pos_ratio, vgg_groups=args.vgg_groups,
        feature_scale=args.feature_scale, use_fuseconv=args.use_fuseconv,
        use_self_attention=args.use_self_attention,
        use_self_attention_base=args.use_self_attention_base,
        num_dcn_layers=args.num_dcn_layers, groups_dcn=args.groups_dcn,
        dcn_cat_sab=args.dcn_cat_sab, detach_sab=args.detach_sab,
        max_pool_factor=args.max_pool_factor, remat_attention=args.remat_attention)


UNPORTED = ("profile_dir", "warmup_eval")


def main(argv=None, devices=None) -> Dict[str, Any]:
    """Train (or, with --test, evaluate each fold's checkpoint) over the
    usable devices or ``devices``, as ``gssd_torch.train.main`` does;
    returns what ``gssd_torch.train.trainer.run`` returns (the records'
    loss parts being pixel_loss and link_loss), or from several ranks
    what ``launch_trainer`` returns."""
    return launch_trainer(_train, parse_args(argv), devices, unported=UNPORTED)


def _train(rank, args) -> Dict[str, Any]:
    """One rank's run of ``main``."""
    setup = prepare(args, rank, unported=UNPORTED)

    from gssd_torch.data import SSDAugmentation, collate_pixellink
    from gssd_torch.eval import run_detection_eval
    from gssd_torch.models.pixellink import build_pixellink
    from gssd_torch.parallel.folds import FoldMember, fold_seed
    from gssd_torch.parallel.mesh import plan_infer_step
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.eval.pixellink_decode import mask_to_boxes
    from gssd_torch.train.steps import (make_pixellink_forward,
                                        make_pixellink_forward_with_aux, pixellink_eval_step,
                                        pixellink_train_step)

    plc = pixellink_config(args)
    optim_cfg = OptimConfig(lr=args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay, gamma=args.gamma,
                            stepvalues=tuple(args.stepvalues), clip=args.clip,
                            modify_dcn_lr=args.modify_dcn_lr)

    def augmentation(jitter, seed):
        return SSDAugmentation(pixeljitter=jitter, ratio=args.expand_ratio,
                               size=args.ssd_dim, mean=args.means,
                               use_normalize=args.use_normalize, p_only=args.p_only,
                               seed=seed, pixel_link_size=args.ssd_dim,
                               pixel_link_version=args.version)

    def make_fold(f):
        model = build_pixellink(plc, args.cascade_fuse, args.batch_norm, args.compute_dtype,
                                args.dcn_impl, device="cpu",
                                seed=fold_seed(args.seed, f)).to(setup.device)
        optimizer = make_optimizer(model, optim_cfg)
        # the logit maps gathered over the fold's ranks on the device, then
        # copied to the host for the decode
        split = plan_infer_step(make_pixellink_forward(model, setup.device, host=False), rank,
                                args.eval_batch)

        def forward(images):
            return tuple(t.cpu().numpy() for t in split(images))

        def evaluate(dataset, tag, iteration):
            res = run_detection_eval(
                forward, dataset, setup.base_tf, setup.ap_list, setup.iobb_list,
                args.confidence_threshold, args.use_07_metric, args.eval_batch,
                use_pixel_link=True, img_size=args.ssd_dim, pl_cfg=plc)
            setup.logger.log_scalars(tag, iteration, res, file="test")
            return res

        def visualize(dataset, out_dir):
            vfwd = make_pixellink_forward_with_aux(model, setup.device)

            def predict(img):
                pix, lnk, aux = vfwd(img)
                scores, boxes = mask_to_boxes(pix[0], lnk[0], args.ssd_dim, plc)
                det = np.zeros((2, max(len(scores), 1), 5), np.float32)
                if len(scores):
                    det[1, :, 0] = scores
                    det[1, :, 1:] = boxes / args.ssd_dim
                return det, aux

            def gt_scale(raw):
                sy, sx = args.ssd_dim / raw.shape[1], args.ssd_dim / raw.shape[2]
                return np.asarray([sx, sy, sx, sy], np.float32)

            return visualize_set(dataset, setup.base_tf, out_dir, predict, gt_scale,
                                 args.confidence_threshold, args.ssd_dim)

        # the validation loss needs the target maps too: the augmentation
        # without jitter, as in the JAX trainer
        return FoldMember(
            f, model, optimizer,
            lambda batch, step: pixellink_train_step(model, optimizer, batch, plc,
                                                     optim_cfg, step),
            lambda batch: pixellink_eval_step(model, batch, plc), evaluate,
            augmentation(args.gt_pixel_jitter, args.seed + f),
            augmentation(0.0, args.seed + 100 + f), visualize=visualize)

    return run(args, setup, make_fold, collate_pixellink,
               (("pixel", "pixel_loss"), ("link", "link_loss")), rank)


if __name__ == "__main__":
    main()
