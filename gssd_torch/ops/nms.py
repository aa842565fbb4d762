"""Static-shape greedy NMS and the Detect (decode + NMS) head, batched
over images.

The kept set is the JAX package's (``gssd_tpu/ops/nms.py``):

1. scores <= conf_thresh are dropped and the top_k remaining
   candidates taken in descending score order,
2. one [K, K] IoU matrix per image,
3. a greedy sweep over score rank: a candidate survives iff no
   higher-ranked survivor overlaps it by more than ``overlap``,
4. survivors compacted to the front as [K, 5] rows of
   (score, x1, y1, x2, y2), zeros past the kept count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gssd_torch.config import DetectConfig
from gssd_torch.ops import boxes as B


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    overlap: float = 0.45,
    top_k: int = 200,
    conf_thresh: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over single-class candidates of a batch of images.

    Args:
      boxes: [N, P, 4] point-form boxes.
      scores: [N, P] scores.
      overlap: suppression IoU threshold (suppress if IoU > overlap).
      top_k: static number of candidates/outputs.
      conf_thresh: candidates must score strictly above this.

    Returns:
      (kept_scores [N, K], kept_boxes [N, K, 4], count [N]) — compacted
      to the front in descending-score order; zeros after ``count``.
    """
    n, p = scores.shape
    if p < top_k:  # pad the candidate list so that topk's k <= P
        boxes = torch.cat([boxes, boxes.new_zeros(n, top_k - p, 4)], dim=1)
        scores = torch.cat(
            [scores, scores.new_full((n, top_k - p), -float("inf"))], dim=1)
    masked = torch.where(scores > conf_thresh, scores,
                         scores.new_tensor(-float("inf")))
    top_scores, top_idx = masked.topk(top_k, dim=1)  # descending
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores > conf_thresh

    rank = torch.arange(top_k, device=scores.device)
    # suppress[n, i, j]: candidate i, if alive, kills candidate j
    suppress = (B.iou(top_boxes, top_boxes) > overlap) & (
        rank[:, None] != rank[None, :])
    alive = top_valid.clone()
    for i in range(top_k):
        alive &= ~(suppress[:, i] & alive[:, i:i + 1])

    # compact kept entries to the front, preserving score order
    key = torch.where(alive, rank, top_k + rank)
    perm = key.argsort(dim=1)
    kept_sorted = torch.gather(alive, 1, perm)
    out_scores = torch.where(kept_sorted, torch.gather(top_scores, 1, perm),
                             top_scores.new_zeros(()))
    out_boxes = torch.where(
        kept_sorted[..., None],
        torch.gather(top_boxes, 1, perm[..., None].expand(-1, -1, 4)),
        top_boxes.new_zeros(()))
    return out_scores, out_boxes, alive.sum(dim=1, dtype=torch.int32)


def detect(
    loc: torch.Tensor,
    conf: torch.Tensor,
    priors: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
) -> torch.Tensor:
    """Batched Detect head: ([B, P, 4], [B, P, C], [P, 4]) -> [B, C, K, 5].

    ``conf`` must already be softmaxed. Row 0 (background) is all zeros.
    """
    loc = loc.float()
    conf = conf.float()
    decoded = B.decode(loc, priors.to(loc), cfg.variance)  # [B, P, 4]
    per_class = [loc.new_zeros(loc.shape[0], cfg.top_k, 5)]
    for cl in range(1, cfg.num_classes):
        s, b, _ = nms(decoded, conf[..., cl], overlap=cfg.nms_thresh,
                      top_k=cfg.top_k, conf_thresh=cfg.conf_thresh)
        per_class.append(torch.cat([s[..., None], b], dim=-1))
    return torch.stack(per_class, dim=1)
