"""Offline dataset builder: volumes -> ml_ready npy directory; the port
of ``gssd_tpu/preprocessing/builder.py``.

The reference's dataset_creation_loop
(lib/data_checker_year1_extended_1904.py:387-428) writes per-slice
npy quadruplets {subject}_{i}_{ct,mask,bbox,phase}.npy plus a
metadata.txt of ``relpath|subject`` lines, optionally fanned out over a
multiprocessing pool (:459-475). This module does the same from
already-loaded volumes (DICOM ingestion lives in dicom_io;
3Dircadb h5 parity in ircadb.py).
"""

from __future__ import annotations

import os
from multiprocessing import Pool
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from gssd_torch.preprocessing.mask2bbox import volume_to_samples
from gssd_torch.preprocessing.windowing import window_and_normalize


def build_subject(
    out_dir: str,
    subject: str,
    phases: np.ndarray,
    mask: np.ndarray,
    window: bool = True,
) -> List[str]:
    """One subject: [4, H, W, Z] raw HU phases + [H, W, Z] mask ->
    written slice files; returns metadata lines."""
    if window:
        phases = np.stack(window_and_normalize(list(phases)))
    samples = volume_to_samples(phases, mask)
    lines = []
    for i, (ct, boxes, smoothed) in enumerate(samples):
        rel = f"{subject}_{i}"
        np.save(os.path.join(out_dir, rel + "_ct.npy"), ct)
        np.save(os.path.join(out_dir, rel + "_bbox.npy"), boxes)
        np.save(os.path.join(out_dir, rel + "_mask.npy"), smoothed)
        np.save(os.path.join(out_dir, rel + "_phase.npy"),
                np.arange(4, dtype=np.int64))
        lines.append(f"{rel}|{subject}")
    return lines


def _worker(args):
    return build_subject(*args)


def build_dataset(
    out_dir: str,
    subjects: Dict[str, Tuple[np.ndarray, np.ndarray]],
    window: bool = True,
    num_workers: int = 1,
) -> List[str]:
    """subjects: name -> (phases [4, H, W, Z] HU, mask [H, W, Z])."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(out_dir, name, p, m, window) for name, (p, m) in
            sorted(subjects.items())]
    if num_workers > 1:
        with Pool(num_workers) as pool:
            per_subject = pool.map(_worker, jobs)
    else:
        per_subject = [_worker(j) for j in jobs]
    lines = [l for ls in per_subject for l in ls]
    with open(os.path.join(out_dir, "metadata.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
