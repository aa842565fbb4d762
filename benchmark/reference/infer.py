"""The reference's serving outputs: per prior the class scores after the
softmax and the decoded box, from which Detect/NMS selects."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from benchmark.reference.boxes import decode, priors
from benchmark.reference.model import GSSD


def scores_boxes(model_cfg: Dict, w: Dict[str, torch.Tensor], images: torch.Tensor,
                 variance, quant: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, H, W, 12] -> (scores [B, C, P] after the softmax, boxes
    [B, P, 4] point form) in ``dtype``, eval mode (running statistics,
    stored spectral vectors)."""
    net = GSSD(model_cfg, {k: v.to(dtype) if v.is_floating_point() else v
                           for k, v in w.items()}, quant)
    pri = torch.as_tensor(priors(model_cfg["anchors"]), device=images.device).to(dtype)
    with torch.no_grad():
        loc, conf = net.forward(images, train=False)
        return torch.softmax(conf, dim=-1).transpose(1, 2), decode(loc, pri, variance)


def detect(scores: torch.Tensor, boxes: torch.Tensor, top_k: int, conf_thresh: float,
           nms_thresh: float) -> torch.Tensor:
    """Detect/NMS in plain loops: per image and class, the ``top_k`` best
    scores above ``conf_thresh``, kept greedily unless an already kept box
    overlaps by more than ``nms_thresh``; -> [B, C, top_k, 5] (score, box),
    zeros after the kept rows, class 0 (background) all zeros."""
    from benchmark.reference.boxes import iou

    B, C, _ = scores.shape
    out = scores.new_zeros(B, C, top_k, 5)
    for b in range(B):
        for c in range(1, C):
            s = scores[b, c]
            top_s, top_i = s.topk(min(top_k, s.numel()))
            keep = top_s > conf_thresh
            top_s, top_i = top_s[keep], top_i[keep]
            cand = boxes[b, top_i]
            over = (iou(cand, cand) > nms_thresh).cpu().numpy()
            kept = []
            for i in range(len(top_i)):
                if not over[kept, i].any():
                    kept.append(i)
            kept_t = torch.as_tensor(kept, dtype=torch.long, device=s.device)
            out[b, c, :len(kept), 0] = top_s[kept_t]
            out[b, c, :len(kept), 1:] = cand[kept_t]
    return out
