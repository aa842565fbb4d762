"""Fuzzy segmentation mask -> bounding boxes + 3-slice training samples;
the port of ``gssd_tpu/preprocessing/mask2bbox.py``.

Reference: lib/mask2bbox.py convert (:13-190) — Gaussian blur (11x11) +
5x5 open/close morphology to denoise hand-drawn masks, connected
components -> per-lesion [x1, y1, x2, y2, class] boxes, then for every
annotated slice a [4, 3, H, W] cutout of the 3 adjacent axial slices
across the 4 phases. Connected components use cv2 (the reference used
skimage.measure.label/regionprops; cv2.connectedComponentsWithStats is
the same 8-connectivity labeling without the skimage dependency).
``cv2`` is imported inside ``mask_slice_to_boxes``, so that importing the
port (and the builders that import this module) loads no OpenCV.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

LESION_CLASS = 0.0


def mask_slice_to_boxes(
    mask_slice: np.ndarray, smooth: bool = True
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """One [H, W] binary mask slice -> ([n, 5] boxes, smoothed mask).

    Returns (None, None) when nothing survives smoothing.
    """
    import cv2

    if mask_slice.max() != 1 or np.count_nonzero(mask_slice == 1) < 1:
        return None, None
    m = mask_slice.astype(np.uint8)
    if smooth:
        m = cv2.GaussianBlur(m, (11, 11), 0)
        kernel = np.ones((5, 5), np.uint8)
        m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel)
        m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(m, connectivity=8)
    boxes = []
    for i in range(1, n):
        x, y, w, h, area = stats[i]
        if area <= 0:
            continue
        # regionprops bbox convention: half-open [min, max) extents
        boxes.append([x, y, x + w, y + h, LESION_CLASS])
    if not boxes:
        return None, None
    return np.asarray(boxes, np.float32), m


def volume_to_samples(
    phases: np.ndarray, mask: np.ndarray
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Build per-slice training samples from one subject's volumes.

    Args:
      phases: [4, H, W, Z] windowed+normalized phase volumes.
      mask: [H, W, Z] binary lesion mask aligned to the annotated phase.

    Returns list of (ct [4, 3, H, W], boxes [n, 5], smoothed mask [H, W])
    for every interior slice with a surviving lesion (mask2bbox.py
    cutout loop :176-184).
    """
    phases = np.asarray(phases)
    Z = mask.shape[2]
    out = []
    for z in range(1, Z - 1):
        boxes, smoothed = mask_slice_to_boxes(mask[:, :, z])
        if boxes is None:
            continue
        cut = np.transpose(phases[:, :, :, z - 1:z + 2], (0, 3, 1, 2))
        if cut.shape[1] != 3:
            continue
        out.append((cut.astype(np.float32), boxes, smoothed))
    return out
