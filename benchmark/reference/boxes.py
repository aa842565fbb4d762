"""Priors, box coding, matching and the MultiBox loss with online hard
negative mining, in plain PyTorch (SSD, Liu et al. 2016, as GSSD++ trains
it): the reference's copy of the arithmetic, batched over images.

- Priors: SSD's v2 grid, per cell a min-size square, a sqrt(min*max)
  square and a w/h pair per aspect ratio, cells row-major, clipped to
  [0, 1], centre form.
- Matching: per-truth best prior forced to that truth (the last valid
  truth wins a conflict), then per-prior best truth; below the overlap
  threshold a prior is background.
- Loss: smooth-L1 over positives, cross-entropy over positives and the
  ``neg_pos_ratio * num_pos`` hardest negatives of each image (stable
  ranks, at most P - 1), both over the batch's positives (at least 1).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def priors(anchors: Dict) -> np.ndarray:
    """Centre-form prior table [P, 4] f32 from the configuration's
    ``anchors`` group."""
    out = []
    dim = anchors["min_dim"]
    for k, f in enumerate(anchors["feature_maps"]):
        f_k = dim / anchors["steps"][k]
        s = anchors["min_sizes"][k] / dim
        sp = math.sqrt(s * anchors["max_sizes"][k] / dim)
        wh = [(s, s), (sp, sp)]
        for ar in anchors["aspect_ratios"][k]:
            r = math.sqrt(ar)
            wh += [(s * r, s / r), (s / r, s * r)]
        for i in range(f):
            for j in range(f):
                for w, h in wh:
                    out.append(((j + 0.5) / f_k, (i + 0.5) / f_k, w, h))
    return np.clip(np.asarray(out, np.float64), 0.0, 1.0).astype(np.float32)


def point_form(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of point-form boxes [..., A, 4] x [..., B, 4]."""
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    wh = (hi - lo).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def encode(matched, pri, var: Sequence[float]):
    cxcy = ((matched[..., :2] + matched[..., 2:]) / 2 - pri[..., :2]) / (var[0] * pri[..., 2:])
    wh = torch.log((matched[..., 2:] - matched[..., :2]) / pri[..., 2:]) / var[1]
    return torch.cat([cxcy, wh], dim=-1)


def decode(loc, pri, var: Sequence[float]):
    cxy = pri[..., :2] + loc[..., :2] * var[0] * pri[..., 2:]
    wh = pri[..., 2:] * torch.exp(loc[..., 2:] * var[1])
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)


def match(truths, labels, valid, pri, threshold: float, var) -> Tuple[torch.Tensor, torch.Tensor]:
    """truths [B, G, 4] point form, labels [B, G], valid [B, G] ->
    (encoded targets [B, P, 4], classes [B, P], 0 = background)."""
    G, P = truths.shape[1], pri.shape[0]
    pf = point_form(pri)
    ov = torch.where(valid[:, :, None], iou(truths, pf), -1.0)
    best_prior = ov.argmax(dim=2)
    best_ov, best_truth = ov.max(dim=1)
    best_truth = ov.argmax(dim=1)
    force = (torch.arange(P, device=pri.device)[None, None] == best_prior[:, :, None]) \
        & valid[:, :, None]
    forced = torch.where(force, torch.arange(G, device=pri.device)[None, :, None], -1).amax(dim=1)
    best_truth = torch.where(forced >= 0, forced, best_truth)
    best_ov = torch.where(forced >= 0, 2.0, best_ov)
    matched = torch.gather(truths, 1, best_truth[..., None].expand(-1, -1, 4))
    conf = torch.gather(labels.long(), 1, best_truth) + 1
    conf = torch.where(best_ov < threshold, 0, conf)
    matched = torch.where((conf > 0)[..., None], matched, pf)
    return encode(matched, pri, var), conf


def multibox_loss(loc, conf, pri, boxes, labels, valid, loss_cfg: Dict):
    """-> (loss_l, loss_c) over the batch's positives."""
    with torch.no_grad():
        loc_t, conf_t = match(boxes, labels, valid, pri, loss_cfg["overlap_thresh"],
                              loss_cfg["variance"])
    pos = conf_t > 0
    l1 = (loc - loc_t).abs()
    l1 = torch.where(l1 < 1.0, 0.5 * l1 * l1, l1 - 0.5).sum(dim=-1)
    loss_l = (l1 * pos).sum()
    ce = torch.logsumexp(conf, dim=-1) - torch.gather(conf, 2, conf_t[..., None])[..., 0]
    mining = torch.where(pos, 0.0, ce.detach())
    order = torch.argsort(-mining, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    P = conf.shape[1]
    num_neg = torch.clamp(loss_cfg["neg_pos_ratio"] * pos.sum(dim=1), max=P - 1)
    neg = rank < num_neg[:, None]
    loss_c = (ce * (pos | neg)).sum()
    n = torch.clamp(pos.sum(), min=1).float()
    return loss_l / n, loss_c / n
