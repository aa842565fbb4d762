"""PixelLink target maps, host-side numpy (the port of
``gssd_tpu/data/pixellink_targets.py``, without OpenCV).

- each gt box is rasterised at 1/factor resolution (factor 2 for '2s',
  4 for '4s'): the integer rectangle, inclusive of its right and bottom
  edges and clipped to the map, which is what ``cv2.fillPoly`` fills for
  it;
- pixels covered by more than one box leave the positive mask and every
  instance; ``neg_pixel_mask`` marks pixels covered by none;
- area-balanced positive weights: each surviving instance carries the
  total weight total_pos_area / num_instances, spread evenly over its
  pixels;
- links: for each of the 8 neighbour directions of ``NEIGHBOR_SHIFTS``
  (dy, dx), a positive pixel links to its neighbour (clipped at the
  border) when the neighbour belongs to the same instance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# (dy, dx) of link j: clockwise from bottom-right
NEIGHBOR_SHIFTS = [
    (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1)
]


def _fill_rect(hw: int, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """[hw, hw] uint8 mask of the inclusive integer rectangle, clipped."""
    m = np.zeros((hw, hw), np.uint8)
    xa, xb = sorted((x0, x1))
    ya, yb = sorted((y0, y1))
    m[max(ya, 0):max(min(yb, hw - 1) + 1, 0), max(xa, 0):max(min(xb, hw - 1) + 1, 0)] = 1
    return m


def make_pixel_link_targets(
    boxes_norm: np.ndarray, size: int, version: str = "4s"
) -> Dict[str, np.ndarray]:
    """boxes_norm: [n, 4] normalised point-form boxes; size: the model's
    input size (300). Returns pixel_mask [S, S] int32, neg_pixel_mask
    uint8, pixel_pos_weight f32 and link_mask [8, S, S] int32 at S =
    size // factor."""
    factor = 2 if version == "2s" else 4
    hw = size // factor
    pixel_weight = np.zeros((hw, hw), np.float32)
    link_mask = np.zeros((8, hw, hw), np.uint8)

    # truncation, then integer division by the factor
    px = (np.asarray(boxes_norm) * size).astype(np.int64) // factor
    instance_masks = [_fill_rect(hw, int(b[0]), int(b[1]), int(b[2]), int(b[3])) for b in px]
    cover = np.zeros((hw, hw), np.int32)
    for m in instance_masks:
        cover += m
    neg_pixel_mask = (cover == 0).astype(np.uint8)
    pixel_mask = (cover == 1).astype(np.uint8)  # overlaps removed

    survivors = [m * pixel_mask for m in instance_masks]
    areas = [int(m.sum()) for m in survivors]
    real = [i for i, a in enumerate(areas) if a > 0]
    if real:
        avg_per_box = int(pixel_mask.sum()) / len(real)
        for i in real:
            m = survivors[i]
            pixel_weight += m.astype(np.float32) * (avg_per_box / areas[i])
            ys, xs = np.nonzero(m)
            for j, (dy, dx) in enumerate(NEIGHBOR_SHIFTS):
                ny = np.clip(ys + dy, 0, hw - 1)
                nx = np.clip(xs + dx, 0, hw - 1)
                shifted = np.zeros_like(m)
                shifted[ny, nx] = 1
                link_mask[j] |= m & shifted
    return {
        "pixel_mask": pixel_mask.astype(np.int32),
        "neg_pixel_mask": neg_pixel_mask,
        "pixel_pos_weight": pixel_weight,
        "link_mask": link_mask.astype(np.int32),
    }
