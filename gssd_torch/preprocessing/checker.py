"""Raw-drop QA checkers: structural sanity reports for incoming data; the
port of ``gssd_tpu/preprocessing/checker.py``.

Rebuilds the reference's dataset-QA scripts as one testable module:

- ``check_year1_extended``: lib/data_checker_year1_extended.py — walk
  the 1809 ``image_mask_pair_list.txt`` lookup (:63-71), read the
  4-phase DICOM series + every ``<mask>_<phase>*`` raw mask per subject
  (:73-131), and report phase z-consistency (:148-152), mask
  z-consistency (:157-158), binary/overlapping-lesion merge status
  (:161-170), with the reference's skip-and-warn on missing pairs
  (:113-116).
- ``check_year2``: lib/data_opener_year2.py — per-subject pre-CT/CT
  pair with shape-equality assert (:117-119), HU-range report and the
  min==0 windowing warning (:33-36), mask slice-count-vs-dicom check
  (:66-69), and the non-binary-label 10/20 force-to-zero fixup
  (:139-151).
- ``contact_sheet`` / ``contact_sheet_year2``: the jpg sanity printouts
  (checker :154-193, opener :168-209) as pure-numpy sheet builders so
  the rendering is testable; writing jpgs is an optional CLI flag.

Instead of the reference's print-stream-plus-crash QA, each checker
returns one report dict per subject (machine-readable findings list),
and readers are injectable so tests run without pydicom/raw assets.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gssd_torch.preprocessing.dicom_io import read_dicom_series, read_raw_mask
from gssd_torch.preprocessing.windowing import apply_window

PHASES = ("A", "D", "P", "Pre")


def load_pair_list(path: str) -> List[Tuple[str, str, str]]:
    """``image_name  mask_name  phase_name`` rows (reference
    data_checker_year1_extended.py:63-71)."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                pairs.append((parts[0], parts[1], parts[2]))
    return pairs


def _normalize_slice(s: np.ndarray) -> np.ndarray:
    lo, hi = float(s.min()), float(s.max())
    if hi == lo:
        return np.zeros_like(s, dtype=np.float64)
    return (s - lo) / (hi - lo) * 255.0


def contact_sheet(phases: Sequence[np.ndarray], mask: np.ndarray,
                  i_slice: int) -> np.ndarray:
    """[H, 5W] sheet: 4 normalized phase slices + the mask (reference
    checker printout :175-193). Out-of-range slices render as noise,
    as the reference does for unaligned volumes (:179-181)."""
    H, W = phases[0].shape[:2]
    sheet = np.zeros((H, W * 5))
    rng = np.random.default_rng(i_slice)
    for i, ph in enumerate(phases):
        if i_slice < ph.shape[2]:
            sl = _normalize_slice(ph[:, :, i_slice])
        else:
            sl = rng.integers(0, 255, size=(H, W)).astype(np.float64)
        sheet[:, W * i:W * (i + 1)] = sl
    if i_slice < mask.shape[2]:
        sheet[:, W * 4:] = mask[:, :, i_slice] * 255.0
    else:
        sheet[:, W * 4:] = rng.integers(0, 2, size=(H, W)) * 255.0
    return sheet


def contact_sheet_year2(prect: Sequence[np.ndarray],
                        ct: Sequence[np.ndarray],
                        mask: np.ndarray, i_slice: int) -> np.ndarray:
    """[2H, 5W] sheet: pre-CT phases over CT phases, mask bottom-right
    (reference opener :168-209)."""
    H, W = ct[0].shape[:2]
    top = contact_sheet(prect, np.zeros((H, W, 0)), i_slice)
    bot = contact_sheet(ct, mask, i_slice)
    sheet = np.zeros((H * 2, W * 5))
    sheet[:H] = top
    sheet[H:] = bot
    # the reference leaves the top-right cell empty (mask only on the
    # CT row, opener :207-208)
    sheet[:H, W * 4:] = 0.0
    return sheet


def check_year1_extended(
    datapath: str,
    pair_list: Sequence[Tuple[str, str, str]],
    series_reader: Optional[Callable[[str, str], np.ndarray]] = None,
    mask_reader: Optional[Callable[[str], np.ndarray]] = None,
) -> List[Dict]:
    """One report dict per subject pair. Keys: ``subject``, ``mask_base``,
    ``found`` (bool), ``phase_z`` [4], ``mask_names``, ``mask_z``,
    ``findings`` (list of warning strings — empty means clean)."""
    sread = series_reader or (
        lambda d, pat: read_dicom_series(d, pat + "*"))
    mread = mask_reader or read_raw_mask
    dicom_dir = os.path.join(datapath, "dicom_image")
    mask_dir = os.path.join(datapath, "segmentation_mask")
    reports = []
    for dicom_name, mask_name, phase_name in pair_list:
        rep: Dict = {
            "subject": dicom_name,
            "mask_base": f"{mask_name}_{phase_name}",
            "found": True,
            "findings": [],
        }
        try:
            vols = [
                sread(os.path.join(dicom_dir, dicom_name, ph), ph + "_")
                for ph in PHASES
            ]
            mask_files = sorted(
                m for m in os.listdir(mask_dir)
                if m.startswith(rep["mask_base"])
            )
            if not mask_files:
                raise FileNotFoundError(rep["mask_base"])
            masks = [mread(os.path.join(mask_dir, m)) for m in mask_files]
        except (FileNotFoundError, ValueError, OSError) as e:
            # the reference skips-and-warns missing pairs (:113-116)
            rep["found"] = False
            rep["findings"].append(f"missing data: {e}")
            reports.append(rep)
            continue
        rep["mask_names"] = mask_files
        rep["phase_z"] = [int(v.shape[2]) for v in vols]
        rep["mask_z"] = [int(m.shape[2]) for m in masks]
        if len(set(rep["phase_z"])) != 1:
            rep["findings"].append(
                "4-phase has non-matching number of slices")  # :148-152
        if len(set(rep["mask_z"])) != 1:
            rep["findings"].append("multi-lesion masks disagree on z")
        for m, name in zip(masks, mask_files):
            if not np.array_equal(m, m.astype(bool)):
                rep["findings"].append(f"mask {name} is not binary")
        if len(masks) > 1:
            merged = np.sum(masks, axis=0)
            if not np.array_equal(merged, merged.astype(bool)):
                rep["findings"].append(
                    "overlapping lesions (merge will binarize)")  # :164-170
        reports.append(rep)
    return reports


def check_year2(
    datapath: str,
    series_reader: Optional[Callable[[str, str], np.ndarray]] = None,
    mask_reader: Optional[Callable[[str], np.ndarray]] = None,
    window: Tuple[float, float] = (400.0, 50.0),
    mask_suffix: str = "_D.raw",
) -> List[Dict]:
    """One report dict per subject directory. Each subject holds
    ``pre-CT/<phase>`` and ``CT/<phase>`` series plus a
    ``<subject><mask_suffix>`` raw mask (the reference's 1810-drop
    hard-wire, opener :130-134)."""
    sread = series_reader or (
        lambda d, pat: read_dicom_series(d, pat + "*"))
    mread = mask_reader or read_raw_mask
    reports = []
    for subject in sorted(os.listdir(datapath)):
        subj_dir = os.path.join(datapath, subject)
        if not os.path.isdir(subj_dir):
            continue
        rep: Dict = {"subject": subject, "found": True, "findings": []}
        try:
            before = [
                sread(os.path.join(subj_dir, "pre-CT", ph), ph + "_")
                for ph in PHASES
            ]
            after = [
                sread(os.path.join(subj_dir, "CT", ph), ph + "_")
                for ph in PHASES
            ]
            mask = mread(
                os.path.join(subj_dir, subject + mask_suffix))
        except (FileNotFoundError, ValueError, OSError) as e:
            rep["found"] = False
            rep["findings"].append(f"missing data: {e}")
            reports.append(rep)
            continue
        shapes_b = {v.shape for v in before}
        shapes_a = {v.shape for v in after}
        rep["hu_range"] = [
            float(min(v.min() for v in before + after)),
            float(max(v.max() for v in before + after)),
        ]
        if shapes_b != shapes_a or len(shapes_b) != 1:
            rep["findings"].append(
                "pre-CT vs CT phase shapes differ")  # opener :117-119
        if rep["hu_range"][0] == 0:
            rep["findings"].append(
                "minimum CT HU of 0 — windowing will shift by -1024"
            )  # opener :33-36
        if mask.shape[2] != after[0].shape[2]:
            rep["findings"].append(
                f"mask slices {mask.shape[2]} != CT slices "
                f"{after[0].shape[2]}")  # opener :66-69
        uniq = set(np.unique(mask).tolist())
        if not uniq <= {0, 1}:
            # the reference forces the known stray labels to zero
            # (opener :139-151)
            fixable = uniq <= {0, 1, 10, 20}
            rep["findings"].append(
                "non-binary mask labels "
                + ("(10/20 fixup applies)" if fixable else
                   f"{sorted(uniq)} (NOT fixable)"))
        rep["windowed_range"] = [
            float(apply_window(after[0], *window).min()),
            float(apply_window(after[0], *window).max()),
        ]
        reports.append(rep)
    return reports


def _save_sheets(reports, datapath, out_dir, year2, sread, mread):
    from PIL import Image

    for rep in reports:
        if not rep["found"]:
            continue
        subject = rep["subject"]
        os.makedirs(os.path.join(out_dir, subject), exist_ok=True)
        if year2:
            subj_dir = os.path.join(datapath, subject)
            prect = [sread(os.path.join(subj_dir, "pre-CT", ph), ph + "_")
                     for ph in PHASES]
            ct = [sread(os.path.join(subj_dir, "CT", ph), ph + "_")
                  for ph in PHASES]
            mask = mread(os.path.join(subj_dir, subject + "_D.raw"))
            z = max(max(v.shape[2] for v in prect + ct), mask.shape[2])
            for i in range(z):
                sheet = contact_sheet_year2(prect, ct, mask, i)
                Image.fromarray(sheet.astype(np.uint8)).save(
                    os.path.join(out_dir, subject, f"{i}.jpg"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Raw-drop QA checker")
    p.add_argument("--datapath", required=True)
    p.add_argument("--flavor", choices=["year1_extended", "year2"],
                   required=True)
    p.add_argument("--pair_list", default=None,
                   help="lookup table path (year1_extended)")
    p.add_argument("--save_sheets", default=None,
                   help="directory for contact-sheet jpgs (year2)")
    args = p.parse_args(argv)
    if args.flavor == "year1_extended":
        pairs = load_pair_list(
            args.pair_list
            or os.path.join(args.datapath, "image_mask_pair_list.txt"))
        reports = check_year1_extended(args.datapath, pairs)
    else:
        reports = check_year2(args.datapath)
        if args.save_sheets:
            _save_sheets(
                reports, args.datapath, args.save_sheets, True,
                lambda d, pat: read_dicom_series(d, pat + "*"),
                read_raw_mask)
    clean = sum(1 for r in reports if r["found"] and not r["findings"])
    for r in reports:
        status = "ok" if not r["findings"] else "; ".join(r["findings"])
        print(f"{r['subject']}\t{status}")
    print(f"{clean}/{len(reports)} subjects clean")


if __name__ == "__main__":
    main()
