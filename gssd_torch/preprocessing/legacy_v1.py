"""SNUH v1 legacy h5 dataset writer (ROI-annotation era): the port of
``gssd_tpu/preprocessing/legacy_v1.py``.

Port of the reference lib/roi_dataset_generator.py (:10-52 HU
preprocessing, :56-166 subject walk + 3-slice stacking + P-only x4
phase replication, :205-211 h5 dump). Emits the h5 layout consumed by
the v1 readers (groups 'ct' -> [n, 4, 3, H, W] per subject,
'coordinate' -> [n, 4, 3, 5] boxes in [x1, y1, x2, y2, label] form —
the contract documented at DEPRECATED/train_lesion_multiphase.py:128
and read back by data/legacy_h5.H5LesionDataset).

Differences from the reference, by design:
- readers are injectable (pydicom/pickle by default) so the pipeline is
  testable on synthetic fixtures, same pattern as preprocessing/snuh.py;
- no debug png dump / global script state; pure functions + one CLI.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# subjects whose raw values are already offset (reference :28-33)
PRE_OFFSET_SUBJECTS = ("A391", "A452")


def normalize_image(img: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] (reference :49-52)."""
    lo, hi = float(np.min(img)), float(np.max(img))
    return (img - lo) / (hi - lo)


def preprocess_slice_for_detection(
    img: np.ndarray, subject: str
) -> np.ndarray:
    """v1 HU preprocessing (reference :10-46): subtract the 1024 raw
    offset (except the two pre-offset subjects), zero implausible
    values > 1200 HU, clip to the liver window [-100, 400], min-max
    normalize. Raises if the raw value range looks wrong (reference
    exits on max < 1700)."""
    img = img.astype(np.float32)
    if subject not in PRE_OFFSET_SUBJECTS:
        if float(np.amax(img)) < 1700:
            raise ValueError(
                f"subject {subject}: raw value range looks already "
                "offset (max < 1700); expected 0..2048 raw values")
        img = img - 1024.0
    img[img > 1200] = 0
    img = np.clip(img, -100, 400)
    return normalize_image(img)


def _default_read_dicom(path: str) -> np.ndarray:
    import pydicom

    return pydicom.dcmread(path).pixel_array


def _default_read_coords(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f), np.float32)


def _matched_slices(ct_dir: str, roi_dir: str) -> List[Tuple[str, str]]:
    """Intersection of slice stems that have both a .DCM image and a
    .txt coordinate pickle (reference :85-97)."""
    stems_ct = {os.path.splitext(n)[0]: n for n in os.listdir(ct_dir)}
    stems_roi = {os.path.splitext(n)[0]: n for n in os.listdir(roi_dir)}
    return [(stems_ct[s], stems_roi[s])
            for s in sorted(set(stems_ct) & set(stems_roi))]


def generate_v1_subject(
    ct_phase_dir: str,
    roi_phase_dir: str,
    subject: str,
    read_dicom: Callable[[str], np.ndarray] = _default_read_dicom,
    read_coords: Callable[[str], np.ndarray] = _default_read_coords,
) -> Tuple[np.ndarray, np.ndarray]:
    """One subject, one phase: load matched (slice, coords) pairs,
    preprocess, stack 3 consecutive slices per sample and replicate x4
    phases (reference :100-140, USE_P_ONLY branch).

    Returns (ct [n, 4, 3, H, W] float32, coords [n, 4, 3, 5] float32).
    """
    slices, coords = [], []
    for ct_name, roi_name in _matched_slices(ct_phase_dir, roi_phase_dir):
        img = read_dicom(os.path.join(ct_phase_dir, ct_name))
        slices.append(preprocess_slice_for_detection(img, subject))
        c = np.asarray(read_coords(os.path.join(roi_phase_dir, roi_name)),
                       np.float32).reshape(-1)
        if c.size == 4:  # no label column in the pickle -> class 0
            c = np.concatenate([c, [0.0]]).astype(np.float32)
        elif c.size != 5:
            # the v1 h5 layout holds exactly one box per slice
            # ([sample, phase, channel, 5]); a multi-box pickle would
            # crash the reference generator (ragged np.array) — fail
            # loudly rather than silently truncate
            raise ValueError(
                f"{subject}/{roi_name}: expected one [4] or [5] box "
                f"per slice, got {c.size} values")
        coords.append(c)
    if len(slices) < 3:
        return (np.zeros((0, 4, 3) + (slices[0].shape if slices else
                                      (512, 512)), np.float32),
                np.zeros((0, 4, 3, 5), np.float32))
    vol = np.stack(slices)          # [z, H, W]
    box = np.stack(coords)          # [z, 5]
    n = vol.shape[0] - 2
    ct = np.stack([vol[i:i + 3] for i in range(n)])       # [n, 3, H, W]
    cr = np.stack([box[i:i + 3] for i in range(n)])       # [n, 3, 5]
    # P-only x4 phase replication (reference :123-126)
    ct4 = np.repeat(ct[:, None], 4, axis=1)               # [n, 4, 3, H, W]
    cr4 = np.repeat(cr[:, None], 4, axis=1)               # [n, 4, 3, 5]
    return ct4.astype(np.float32), cr4.astype(np.float32)


def generate_v1_dataset(
    ct_path: str,
    roi_coordinate_path: str,
    phase: str = "P",
    read_dicom: Callable[[str], np.ndarray] = _default_read_dicom,
    read_coords: Callable[[str], np.ndarray] = _default_read_coords,
    log=print,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Walk subjects under roi_coordinate_path (reference :62: the ROI
    tree drives discovery), returning {subject: (ct, coords)}. Subjects
    with missing CT dirs or <3 annotated slices are skipped with a
    warning (reference behavior is a hard crash; skip-and-warn matches
    the repo's preprocessing convention, snuh.py)."""
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for subject in sorted(os.listdir(roi_coordinate_path)):
        roi_dir = os.path.join(roi_coordinate_path, subject, phase)
        ct_dir = os.path.join(ct_path, subject, phase)
        if not (os.path.isdir(roi_dir) and os.path.isdir(ct_dir)):
            log(f"skip {subject}: missing {phase} dir")
            continue
        try:
            ct, cr = generate_v1_subject(ct_dir, roi_dir, subject,
                                         read_dicom, read_coords)
        except ValueError as e:
            log(f"skip {subject}: {e}")
            continue
        if ct.shape[0] == 0:
            log(f"skip {subject}: fewer than 3 annotated slices")
            continue
        out[subject] = (ct, cr)
        log(f"{subject}: {ct.shape[0]} samples")
    return out


def write_v1_h5(
    path: str, per_subject: Dict[str, Tuple[np.ndarray, np.ndarray]]
) -> None:
    """Dump the reference h5 layout (:205-211): groups 'ct' and
    'coordinate' with ct_{i}/coordinate_{i} datasets, one per subject
    in sorted order."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        g_ct = f.create_group("ct")
        g_cr = f.create_group("coordinate")
        for i, subject in enumerate(sorted(per_subject)):
            ct, cr = per_subject[subject]
            g_ct.create_dataset(f"ct_{i}", data=ct,
                                compression="gzip", compression_opts=1)
            g_cr.create_dataset(f"coordinate_{i}", data=cr)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="SNUH v1 legacy h5 dataset generator "
                    "(lib/roi_dataset_generator.py port)")
    ap.add_argument("--ct_path", required=True)
    ap.add_argument("--roi_coordinate_path", required=True)
    ap.add_argument("--output", required=True, help="output .h5 path")
    ap.add_argument("--phase", default="P")
    args = ap.parse_args(argv)
    data = generate_v1_dataset(args.ct_path, args.roi_coordinate_path,
                               args.phase)
    write_v1_h5(args.output, data)
    total = sum(ct.shape[0] for ct, _ in data.values())
    print(f"wrote {args.output}: {len(data)} subjects, {total} samples")


if __name__ == "__main__":
    main()
