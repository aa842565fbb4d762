"""Dataset-hygiene tools: drop-structure fixer + aligned-set cleaner; the
port of ``gssd_tpu/preprocessing/hygiene.py``.

Rebuilds the reference's one-off data-hygiene scripts:

- ``fix_drop_structure``: lib/data_structure_preserver.py — normalize
  phase folder names in a raw drop (``V`` -> ``P``, ``LA`` -> ``A``,
  renaming the contained slice files' prefixes too, :27-64 and the roi
  twin :72-104), skipping subjects that hold BOTH ``P`` and ``V``
  (:33-36), and reporting ct-vs-roi subject-set mismatches (:106-110).
- ``clean_aligned_set``: lib/clean_npy.py — post-registration ml_ready
  cleanup: clip warped CT to [0, 1], re-binarize the warped mask at
  0.5 (:65-68), re-derive bboxes from the warped mask via connected
  components (:12-33; the repo's mask2bbox with smoothing off matches
  regionprops' half-open bbox convention), and warn when the lesion
  count changed during warping (:70-72). The reference appends the
  class label twice (clean_npy.py:25-27, a 6-column artifact); this
  port emits the 5-column ``[x1, y1, x2, y2, label]`` ml_ready
  contract that data/dataset.py consumes.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gssd_torch.preprocessing.mask2bbox import LESION_CLASS, mask_slice_to_boxes

PHASES = ("A", "D", "P", "Pre")
RENAMES = {"V": "P", "LA": "A"}


def _fix_phase_folders(subject_dir: str) -> List[str]:
    """Rename mis-labeled phase subfolders (and their slice files'
    prefixes) under one subject. Returns fix messages."""
    msgs = []
    subfolders = [
        f for f in os.listdir(subject_dir)
        if os.path.isdir(os.path.join(subject_dir, f))
    ]
    # the 1904 drop has subjects with BOTH 'P' and 'V': renaming would
    # collide, so skip-and-warn (reference :33-36)
    for bad, good in RENAMES.items():
        if bad in subfolders and good in subfolders:
            msgs.append(
                f"ERROR: has both '{good}' and '{bad}' subfolders, "
                "skipping without fixing")
            return msgs
    for bad, good in RENAMES.items():
        src = os.path.join(subject_dir, bad)
        if not os.path.isdir(src):
            continue
        for image in sorted(glob.glob(os.path.join(src, "*"))):
            # reference keeps the filename's trailing 8 chars
            # (e.g. '0012.DCM') and swaps the phase prefix (:46-50)
            suffix = image[-8:]
            os.rename(image, os.path.join(src, f"{good}_{suffix}"))
        os.rename(src, os.path.join(subject_dir, good))
        msgs.append(f"renamed phase '{bad}' -> '{good}'")
    return msgs


def fix_drop_structure(
    ct_path: str, roi_image_path: Optional[str] = None
) -> Dict[str, List[str]]:
    """Normalize phase folder names across a raw drop; when
    ``roi_image_path`` is given, fix it the same way and report
    subject-set mismatches (reference :72-110). Returns
    {subject_or_'*': [messages]} with only non-clean entries."""
    report: Dict[str, List[str]] = {}
    ct_subjects = []
    for subject in sorted(glob.glob(os.path.join(ct_path, "*"))):
        if not os.path.isdir(subject):
            continue
        name = os.path.basename(subject)
        ct_subjects.append(name)
        msgs = _fix_phase_folders(subject)
        if msgs:
            report[name] = msgs
    if roi_image_path is not None:
        roi_subjects = []
        for subject in sorted(glob.glob(os.path.join(roi_image_path, "*"))):
            if not os.path.isdir(subject):
                continue
            name = os.path.basename(subject)
            roi_subjects.append(name)
            msgs = _fix_phase_folders(subject)
            if msgs:
                report.setdefault(name, []).extend(
                    f"roi_image: {m}" for m in msgs)
        if sorted(ct_subjects) != sorted(roi_subjects):
            diff = set(ct_subjects).symmetric_difference(roi_subjects)
            report["*"] = [
                f"ct vs roi_image subject mismatch: {sorted(diff)}"]
    return report


def clean_sample(
    ct: np.ndarray, mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One aligned sample -> (clipped ct, binarized mask, boxes|None).

    boxes is ``[n, 5]`` float32 or None when the warped mask carries no
    lesion (the reference emits ``[None]`` there, clean_npy.py:31-33).
    """
    ct = np.clip(np.asarray(ct, np.float32), 0.0, 1.0)
    mask = (np.asarray(mask, np.float32) > 0.5).astype(np.uint8)
    boxes, _ = mask_slice_to_boxes(mask, smooth=False)
    return ct, mask, boxes


def clean_aligned_set(
    metadata_path: str,
    src_path: str,
    out_path: str,
    orig_path: Optional[str] = None,
) -> List[str]:
    """Walk the ml_ready metadata, clean every aligned sample present
    under ``src_path`` into ``out_path``, and return warnings for
    samples whose lesion count changed vs the pre-alignment bboxes
    under ``orig_path`` (defaults to the metadata's directory)."""
    orig_path = orig_path or os.path.dirname(metadata_path)
    relpaths = []
    with open(metadata_path) as f:
        for line in f:
            line = line.strip()
            if line:
                relpaths.append(line.split("|")[0])
    os.makedirs(out_path, exist_ok=True)
    warnings = []
    for rel in relpaths:
        src_ct = os.path.join(src_path, rel + "_ct.npy")
        if not os.path.isfile(src_ct):
            continue  # aligned variant absent for this sample (:55-62)
        ct = np.load(src_ct)
        mask = np.load(os.path.join(src_path, rel + "_mask.npy"))
        ct, mask, boxes = clean_sample(ct, mask)
        if boxes is None:
            boxes = np.zeros((0, 5), np.float32)
        sub = os.path.dirname(rel)
        if sub:
            os.makedirs(os.path.join(out_path, sub), exist_ok=True)
        orig_bbox_file = os.path.join(orig_path, rel + "_bbox.npy")
        if os.path.isfile(orig_bbox_file):
            n_orig = np.load(orig_bbox_file).shape[0]
            if boxes.shape[0] != n_orig:
                warnings.append(
                    f"{rel}: lesion count {n_orig} -> {boxes.shape[0]}")
        np.save(os.path.join(out_path, rel + "_ct.npy"), ct)
        np.save(os.path.join(out_path, rel + "_mask.npy"), mask)
        np.save(os.path.join(out_path, rel + "_bbox.npy"), boxes)
    return warnings


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Dataset hygiene tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("fix-structure")
    ps.add_argument("--ct_path", required=True)
    ps.add_argument("--roi_image_path", default=None)
    pc = sub.add_parser("clean-aligned")
    pc.add_argument("--metadata", required=True)
    pc.add_argument("--src", required=True)
    pc.add_argument("--out", required=True)
    pc.add_argument("--orig", default=None)
    args = p.parse_args(argv)
    if args.cmd == "fix-structure":
        report = fix_drop_structure(args.ct_path, args.roi_image_path)
        for subject, msgs in sorted(report.items()):
            for m in msgs:
                print(f"{subject}\t{m}")
        print(f"{len(report)} subjects needed fixes")
    else:
        warnings = clean_aligned_set(
            args.metadata, args.src, args.out, args.orig)
        for w in warnings:
            print(w)
        print(f"done ({len(warnings)} lesion-count changes)")


if __name__ == "__main__":
    main()
