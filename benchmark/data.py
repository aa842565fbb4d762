"""Synthetic multiphase CT slices made from the seed, on the card.

The layout of the ``ml_ready`` set that the GSSD++ recipe trains on
(``gssd_torch/data/synthetic.py``'s arithmetic): per slice 4 phases x 3
adjacent slices in [0, 1], a base level with noise, a body oval and 1 to
``max_lesions`` bright elliptic lesions that drift a few pixels and change
gain from phase to phase (unregistered phases), with the lesions' boxes
in pixels and class 0. Channels are phase-major (phase * 3 + slice).

The per-slice scalars come from ``numpy.random.default_rng(seed)``, the
noise from a ``torch.Generator`` on the card in one call; everything is
made in a few large calls on the device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def lesion_slices(n: int, size: int, seed: int, device, max_lesions: int = 2
                  ) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """-> (ct [n, size, size, 12] f32 in [0, 1] on ``device``, per-slice
    boxes [k, 5] f32: x1, y1, x2, y2 in pixels, class 0)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    S = size
    ct = torch.randn((n, S, S, 12), generator=gen, device=device).mul_(0.02)
    ct += torch.as_tensor(rng.uniform(0.25, 0.45, n), dtype=torch.float32,
                          device=device)[:, None, None, None]
    yy = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(S, dtype=torch.float32, device=device)[None, :]
    body = (((yy - S / 2) / (S * 0.45)) ** 2 + ((xx - S / 2) / (S * 0.38)) ** 2) < 1.0
    ct += 0.15 * body[None, :, :, None]
    boxes = []
    for i in range(n):
        rows = []
        for _ in range(int(rng.integers(1, max_lesions + 1))):
            cy, cx = rng.uniform(0.3 * S, 0.7 * S, 2)
            ry, rx = rng.uniform(0.03 * S, 0.10 * S, 2)
            for p in range(4):
                dy, dx = rng.uniform(-3, 3, 2)
                gain = rng.uniform(0.25, 0.45)
                ell = (((yy - cy - dy) / ry) ** 2 + ((xx - cx - dx) / rx) ** 2) < 1.0
                ct[i, :, :, 3 * p:3 * p + 3] += gain * ell[:, :, None]
            rows.append([cx - rx, cy - ry, cx + rx, cy + ry, 0.0])
        boxes.append(np.asarray(rows, np.float32))
    return ct.clamp_(0.0, 1.0), boxes


def to_uint8(ct: torch.Tensor) -> torch.Tensor:
    """0..255 levels as the ``device_cached`` path stores a slice (f32
    ct * 255 truncated)."""
    return (ct * 255.0).to(torch.uint8)


def base_transform(ct: torch.Tensor) -> torch.Tensor:
    """The serving path's transform at the native size: each slice's
    0..255 values min-max normalised to [0, 1] over all its phases."""
    x = ct * 255.0
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo)


class SliceSet:
    """The interface of ``LesionDataset`` that the device cache reads:
    ``len`` and ``raw_item(i)`` -> ([4, H, W, 3] f32 0..255, boxes [k, 5])."""

    def __init__(self, raw: np.ndarray, boxes: List[np.ndarray]):
        self.raw = raw  # [n, S, S, 12] uint8
        self.boxes = boxes

    def __len__(self) -> int:
        return len(self.boxes)

    def raw_item(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        S = self.raw.shape[1]
        img = self.raw[i].reshape(S, S, 4, 3).transpose(2, 0, 1, 3).astype(np.float32)
        return img, self.boxes[i].copy()
