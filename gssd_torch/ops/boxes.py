"""Box math on torch tensors.

- "point form": (xmin, ymin, xmax, ymax), normalized to [0, 1].
- "center form": (cx, cy, w, h).
"""

from __future__ import annotations

from typing import Sequence

import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """Center form -> point form. boxes: [..., 4]."""
    cxy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """Point form -> center form. boxes: [..., 4]."""
    mins, maxs = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(maxs + mins) / 2, maxs - mins], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of point-form boxes. [..., 4] -> [...]."""
    wh = boxes[..., 2:] - boxes[..., :2]
    return wh[..., 0] * wh[..., 1]


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area of point-form boxes.

    box_a: [..., A, 4], box_b: [..., B, 4] -> [..., A, B].
    """
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (jaccard). [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    inter = intersect(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    return inter / union


def encode(
    matched: torch.Tensor,
    priors: torch.Tensor,
    variances: Sequence[float] = (0.1, 0.2),
) -> torch.Tensor:
    """Encode matched point-form boxes [..., P, 4] against center-form
    priors [P, 4] into regression targets [..., P, 4]."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(g_wh) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(
    loc: torch.Tensor,
    priors: torch.Tensor,
    variances: Sequence[float] = (0.1, 0.2),
) -> torch.Tensor:
    """Decode loc regression [..., P, 4] against center-form priors
    [P, 4] back to point-form boxes."""
    cxy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
