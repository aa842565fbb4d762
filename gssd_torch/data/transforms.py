"""Eval-path base transform: resize each phase to (size, size),
subtract the mean, optional portal-only phase repeat, optional min-max
normalisation to [0, 1]. Operates on [phase, H, W, 3] float 0..255.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

PORTAL_PHASE = 2  # phase order A/D/P/Pre; portal = index 2


def resize_phases(img: np.ndarray, size: int) -> np.ndarray:
    """[P, H, W, C] -> [P, size, size, C] per-phase bilinear resize with
    half-pixel centres and no antialiasing (OpenCV's INTER_LINEAR)."""
    p, h, w, c = img.shape
    if h == size and w == size:
        return img.astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return np.ascontiguousarray(y.permute(0, 2, 3, 1).numpy())


class BaseTransform:
    def __init__(
        self,
        size: int = 300,
        mean: float = 0.0,
        p_only: bool = False,
        use_normalize: bool = True,
    ):
        self.size = size
        self.mean = mean
        self.p_only = p_only
        self.use_normalize = use_normalize

    def __call__(
        self,
        img: np.ndarray,
        boxes: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
    ):
        x = resize_phases(img.astype(np.float32), self.size)
        x -= self.mean
        if self.p_only:
            x = np.repeat(x[PORTAL_PHASE:PORTAL_PHASE + 1], img.shape[0], 0)
        if self.use_normalize:
            lo, hi = x.min(), x.max()
            if hi == lo:
                raise ValueError("all-constant image cannot be normalized")
            x = (x - lo) / (hi - lo)
        return x, boxes, labels
