"""Synthetic ml_ready fixture generator.

Emits the exact on-disk contract of the reference's offline
preprocessing (data_checker_year1_extended_1904.py:415-427): per slice
``{subject}_{i}_ct.npy`` [4, 3, 512, 512] float32 in [0, 1],
``..._bbox.npy`` [n, 5] pixel boxes + class 0, ``..._mask.npy`` /
``..._phase.npy``, and a ``metadata.txt`` of ``relpath|subject`` lines.
Lesions are bright ellipses with slight per-phase intensity/position
drift (mimicking the unregistered 4-phase acquisitions the models must
align), so synthetic training is actually learnable end to end.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def make_synthetic_dataset(
    out_dir: str,
    num_subjects: int = 12,
    slices_per_subject: int = 3,
    image_size: int = 512,
    max_lesions: int = 2,
    seed: int = 1234,
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    S = image_size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    for s in range(num_subjects):
        subject = f"synth{s:03d}"
        for i in range(slices_per_subject):
            base = rng.uniform(0.25, 0.45)
            ct = np.full((4, 3, S, S), base, np.float32)
            ct += rng.normal(0, 0.02, ct.shape).astype(np.float32)
            # body oval to give min-max normalize some structure
            body = (((yy - S / 2) / (S * 0.45)) ** 2
                    + ((xx - S / 2) / (S * 0.38)) ** 2) < 1.0
            ct += 0.15 * body
            mask = np.zeros((S, S), np.uint8)
            n_lesions = int(rng.integers(1, max_lesions + 1))
            boxes = []
            for _ in range(n_lesions):
                cy = rng.uniform(0.3 * S, 0.7 * S)
                cx = rng.uniform(0.3 * S, 0.7 * S)
                ry = rng.uniform(0.03 * S, 0.10 * S)
                rx = rng.uniform(0.03 * S, 0.10 * S)
                for p in range(4):
                    # per-phase drift: the "unregistered phases"
                    dy = rng.uniform(-3, 3)
                    dx = rng.uniform(-3, 3)
                    ell = (((yy - cy - dy) / ry) ** 2
                           + ((xx - cx - dx) / rx) ** 2) < 1.0
                    gain = rng.uniform(0.25, 0.45)
                    for z in range(3):
                        ct[p, z][ell] += gain
                ell0 = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
                mask |= ell0.astype(np.uint8)
                boxes.append([cx - rx, cy - ry, cx + rx, cy + ry, 0.0])
            ct = np.clip(ct, 0.0, 1.0)
            rel = f"{subject}_{i}"
            np.save(os.path.join(out_dir, rel + "_ct.npy"), ct)
            np.save(
                os.path.join(out_dir, rel + "_bbox.npy"),
                np.asarray(boxes, np.float32),
            )
            np.save(os.path.join(out_dir, rel + "_mask.npy"), mask)
            np.save(
                os.path.join(out_dir, rel + "_phase.npy"),
                np.arange(4, dtype=np.int64),
            )
            lines.append(f"{rel}|{subject}")
    with open(os.path.join(out_dir, "metadata.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
