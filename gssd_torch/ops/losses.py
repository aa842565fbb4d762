"""MultiBox loss with online hard negative mining, on the device.

Smooth-L1 over positive priors plus cross-entropy over positives and
the hardest ``neg_pos_ratio * num_pos`` negatives of each image (at most
P - 1), ranked by the double argsort. Both sorts are stable, as
``jnp.argsort`` is, so equal losses keep the order of their priors and
the same negatives are mined. Both terms are summed and divided by the
batch's total positives, clamped at 1.

Inside a data-parallel group (``parallel.collectives.data_group``) the
total positives are those of the fold's whole batch, summed over the
ranks, and each rank's loss is its share: its rows' sums over that
total. The shares add up to the loss of the whole batch. The negatives
are mined per image, so they stay local.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gssd_torch.config import LossConfig
from gssd_torch.ops.matcher import match_batch
from gssd_torch.parallel.collectives import all_reduce_


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def hard_negatives(ce: torch.Tensor, pos: torch.Tensor, neg_pos_ratio: int) -> torch.Tensor:
    """[B, P] bool mask of the ``neg_pos_ratio * num_pos`` (at most P - 1)
    negatives of highest loss ``ce`` per image; ties keep prior order."""
    P = ce.shape[1]
    mining = torch.where(pos, 0.0, ce)
    order = torch.argsort(-mining, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_neg = torch.clamp(neg_pos_ratio * pos.sum(dim=1), max=P - 1)
    return rank < num_neg[:, None]


def multibox_loss(
    loc_pred: torch.Tensor,
    conf_pred: torch.Tensor,
    priors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: LossConfig = LossConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """loc_pred [B, P, 4], conf_pred [B, P, C] logits, priors [P, 4],
    gt_boxes [B, G, 4] point form, gt_labels [B, G], gt_valid [B, G] ->
    (loss_l, loss_c, {"num_pos", "num_neg"})."""
    with torch.no_grad():
        loc_t, conf_t = match_batch(gt_boxes, gt_labels, gt_valid, priors,
                                    cfg.overlap_thresh, cfg.variance)
    pos = conf_t > 0
    num_pos = pos.sum(dim=1)
    n_total = all_reduce_(num_pos.sum())

    l1 = smooth_l1(loc_pred.float() - loc_t).sum(dim=-1)
    loss_l = (l1 * pos).sum()

    conf32 = conf_pred.float()
    lse = torch.logsumexp(conf32, dim=-1)
    true_logit = torch.gather(conf32, 2, conf_t[..., None])[..., 0]
    ce = lse - true_logit  # [B, P]

    neg = hard_negatives(ce.detach(), pos, cfg.neg_pos_ratio)

    loss_c = (ce * (pos | neg)).sum()
    n = torch.clamp(n_total, min=1).float()
    return loss_l / n, loss_c / n, {"num_pos": n_total, "num_neg": neg.sum()}
