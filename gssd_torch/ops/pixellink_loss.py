"""PixelLink loss: instance-balanced pixel cross entropy plus one link
cross entropy per neighbour (the port of ``gssd_tpu/ops/pixellink_loss.py``).

- pixel loss: a 2-way CE per pixel; positives weighted by the
  area-balanced map; the hard negatives are the ``neg_pos_ratio * area``
  pixels of ``neg_pixel_mask`` with the lowest background probability
  (10000 when the image has no positive), ranked by a double argsort
  with ``inf`` outside the mask. Both sorts are stable, so tied
  probabilities (saturated softmaxes tie often) rank by position, as
  they do in the JAX package. The positive and negative terms are each
  summed and divided by (area + negatives), then averaged over the batch.
- link loss: 8 independent 2-way CEs over the logit pairs [2j, 2j+1];
  positive and negative weights are the pixel weight map where the link
  target is 1 or 0, each normalised by its own sum per image.

Logits are NHWC as the model returns them: pixel [B, H, W, 2], link [B,
H, W, 16]; masks [B, H, W] and link masks [B, 8, H, W].

Every term is a per-image value; inside a data-parallel group
(``parallel.collectives.data_group``) each rank's term is its rows' sum
over the fold's whole batch (B times the ranks), its share of the batch
mean.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gssd_torch.parallel.collectives import group_size

NO_POSITIVE_BUDGET = 10000


def _batch_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean of the per-image ``v`` over the batch; in a group, this
    rank's share of the mean over the fold's batch."""
    n = group_size()
    return v.mean() if n == 1 else v.sum() / (v.shape[0] * n)


def _ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2-way cross entropy: logits [..., 2], target [...] int."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, target.long()[..., None])[..., 0]


def pixel_loss(logits: torch.Tensor, pixel_mask: torch.Tensor, neg_pixel_mask: torch.Tensor,
               pos_weight: torch.Tensor, neg_pos_ratio: int = 3
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (positive term, negative term), each a batch mean."""
    B = logits.shape[0]
    logits = logits.float()
    ce = _ce(logits, pixel_mask)
    p_bg = torch.softmax(logits, dim=-1)[..., 0]

    neg = neg_pixel_mask.reshape(B, -1) == 1
    area = pixel_mask.reshape(B, -1).sum(dim=1)
    budget = torch.where(area == 0, torch.full_like(area, NO_POSITIVE_BUDGET),
                         area * neg_pos_ratio)
    neg_area = torch.minimum(budget, neg.sum(dim=1).to(area.dtype))

    # rank negatives by ascending background probability ("most wrong" first)
    with torch.no_grad():
        score = torch.where(neg, p_bg.reshape(B, -1), torch.full_like(p_bg.reshape(B, -1),
                                                                      float("inf")))
        order = torch.sort(score, dim=1, stable=True).indices
        rank = torch.sort(order, dim=1, stable=True).indices
        neg_sel = (rank < neg_area[:, None]) & neg

    pos_term = (pos_weight.reshape(B, -1) * ce.reshape(B, -1)).sum(dim=1)
    neg_term = (neg_sel * ce.reshape(B, -1)).sum(dim=1)
    denom = torch.clamp(area + neg_area, min=1).float()
    return _batch_mean(pos_term / denom), _batch_mean(neg_term / denom)


def link_loss(logits: torch.Tensor, link_mask: torch.Tensor, pos_weight: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (positive term, negative term), each a batch mean."""
    B, H, W, _ = logits.shape
    logits = logits.float().reshape(B, H, W, 8, 2)
    target = link_mask.permute(0, 2, 3, 1)  # [B, H, W, 8]
    ce = _ce(logits, target)

    w = pos_weight[..., None].float()
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    pos_w = torch.where(target == 1, w, zero)
    neg_w = torch.where(target == 0, w, zero)
    sum_pos = pos_w.reshape(B, -1).sum(dim=1)
    sum_neg = neg_w.reshape(B, -1).sum(dim=1)
    pos = (pos_w * ce).reshape(B, -1).sum(dim=1)
    neg = (neg_w * ce).reshape(B, -1).sum(dim=1)
    pos = torch.where(sum_pos > 0, pos / torch.clamp(sum_pos, min=1e-12), zero)
    neg = torch.where(sum_neg > 0, neg / torch.clamp(sum_neg, min=1e-12), zero)
    return _batch_mean(pos), _batch_mean(neg)


def pixellink_loss(pixel_logits: torch.Tensor, link_logits: torch.Tensor,
                   targets: Dict[str, torch.Tensor], pixel_weight: float = 2.0,
                   link_weight: float = 1.0, neg_pos_ratio: int = 3
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pixel_weight * (pixel pos + neg) + link_weight * (link pos + neg)
    -> (total, {"pixel_loss", "link_loss"})."""
    pp, pn = pixel_loss(pixel_logits, targets["pixel_mask"], targets["neg_pixel_mask"],
                        targets["pixel_pos_weight"], neg_pos_ratio)
    lp, ln = link_loss(link_logits, targets["link_mask"], targets["pixel_pos_weight"])
    p, lk = pp + pn, lp + ln
    return pixel_weight * p + link_weight * lk, {"pixel_loss": p, "link_loss": lk}
