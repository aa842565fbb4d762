"""Anchor matching, batched over images (no Python loop over the batch).

For each image:

1. overlaps = IoU(gt, priors)                          [G, P]
2. per-gt best prior, per-prior best gt (argmax each way; ties go to
   the first index)
3. force each valid gt's best prior to that gt (overlap := 2); on a
   conflict the last valid gt wins, like a sequential overwrite loop
4. priors whose best overlap is below the threshold -> background (0)

Variable-length gt lists are padded to ``max_gt`` with a validity mask;
padded rows never match or force.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gssd_torch.ops import boxes as B


def match_batch(
    truths: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    priors: torch.Tensor,
    threshold: float = 0.5,
    variances: Sequence[float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """truths [B, G, 4] point form, labels [B, G] int (0 = first
    foreground class), valid [B, G] bool, priors [P, 4] center form ->
    (loc_t [B, P, 4] encoded targets, conf_t [B, P] int64, 0 =
    background)."""
    G = truths.shape[1]
    P = priors.shape[0]
    pf = B.point_form(priors)
    overlaps = B.iou(truths, pf)  # [B, G, P]
    overlaps = torch.where(valid[:, :, None], overlaps, -1.0)

    best_prior_idx = torch.argmax(overlaps, dim=2)  # [B, G]
    best_truth_overlap, _ = torch.max(overlaps, dim=1)  # [B, P]
    best_truth_idx = torch.argmax(overlaps, dim=1)  # [B, P]

    prior_ids = torch.arange(P, device=truths.device)
    force = (prior_ids[None, None, :] == best_prior_idx[:, :, None]) & valid[:, :, None]
    gt_ids = torch.arange(G, device=truths.device)[None, :, None]
    forced_j = torch.where(force, gt_ids, -1).amax(dim=1)  # last valid j, or -1
    forced_any = forced_j >= 0
    best_truth_idx = torch.where(forced_any, forced_j, best_truth_idx)
    best_truth_overlap = torch.where(forced_any, 2.0, best_truth_overlap)

    matched = torch.gather(truths, 1, best_truth_idx[..., None].expand(-1, -1, 4))
    conf_t = torch.gather(labels.long(), 1, best_truth_idx) + 1
    conf_t = torch.where(best_truth_overlap < threshold, 0, conf_t)

    # background priors encode against themselves: padded gt rows are
    # zeros, whose log(wh) would be -inf and poison the masked loss
    matched = torch.where((conf_t > 0)[..., None], matched, pf)
    return B.encode(matched, priors, variances), conf_t


def match(truths, labels, valid, priors, threshold=0.5, variances=(0.1, 0.2)):
    """One image: truths [G, 4], labels [G], valid [G] -> (loc_t [P, 4],
    conf_t [P])."""
    loc_t, conf_t = match_batch(truths[None], labels[None], valid[None], priors,
                                threshold, variances)
    return loc_t[0], conf_t[0]
