"""CT Hounsfield-unit windowing: the port of
``gssd_tpu/preprocessing/windowing.py``.

Reference: lib/data_checker_year1_extended_1904.py apply_window
(:169-211) with its pathological-range fixups for known scanner quirks,
window_and_normalize (:307-316, W=400 / L=50 then min-max to [0, 1]),
and the 3Dircadb variant's clip to [-100, 400]
(lib/extract_3dircadb.py:77-101).
"""

from __future__ import annotations

import numpy as np


def apply_window(
    img: np.ndarray, window_width: float = 400.0, window_level: float = 50.0
) -> np.ndarray:
    """Radiology windowing with the reference's HU-range fixups."""
    img = np.asarray(img).copy()
    lo, hi = float(img.min()), float(img.max())
    if lo == -3024 and hi == 1166:
        # known scanner artifact range
        img = np.clip(img, -1024, 1166)
    elif lo in (-2000, -2048):
        # out-of-FOV padding encoded as -2000/-2048
        img[img == -2000] = 0
        img[img == -2048] = 0
    elif lo < -2000:
        print("WARNING: HU value range of this subject is extremely "
              "unusual. double-check the correctness of windowing.")
        img[img < 0] = 0

    if img.mean() > 0:
        # intensity-coded (not HU) volume: shift to HU-ish range
        img = img - 1024

    img[img > 1200] = 0

    upper = window_level + window_width / 2.0
    lower = window_level - window_width / 2.0
    return np.clip(img, lower, upper)


def normalize01(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi == lo:
        raise ValueError("constant image cannot be min-max normalized")
    return (img - lo) / (hi - lo)


def window_and_normalize(
    phases, window_width: float = 400.0, window_level: float = 50.0
):
    """Window + normalize each phase volume (list or [P, ...] array)."""
    return [
        normalize01(apply_window(p, window_width, window_level)
                    .astype(np.float32))
        for p in phases
    ]


def ircadb_window(img_slc: np.ndarray) -> np.ndarray:
    """3Dircadb preprocessing: zero >1200HU, clip [-100, 400], min-max."""
    img_slc = img_slc.astype(np.float32).copy()
    img_slc[img_slc > 1200] = 0
    img_slc = np.clip(img_slc, -100, 400)
    return normalize01(img_slc)
