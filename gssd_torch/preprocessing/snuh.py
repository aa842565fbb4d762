"""SNUH clinical-data ingestion: raw drop -> ml_ready, one command; the
port of ``gssd_tpu/preprocessing/snuh.py``.

Rebuilds the reference's year1-extended 1904 script
(lib/data_checker_year1_extended_1904.py):

- xlsx -> per-subject delta/pivot metadata (:16-67) and the merge with
  the 1809 image/mask lookup table (:70-102);
- subject-level walker over ``dicom_image/<subject>/<phase>/`` with
  ``<phase>_*`` DICOM series per phase (:214-248);
- multi-lesion raw-mask matching by ``<mask_id>_<phase>`` prefix
  (:249-258), delta-based z-alignment of every mask to the pivot phase
  (:259-268), and the sum+binarize lesion merge (:293-303);
- HU window W=400/L=50 + min-max normalize (:275, 307-316) and the
  per-slice 3-slice-cutout ml_ready emit via mask2bbox
  (dataset_creation_loop :387-428), fanned out over a process pool
  (:459-475).

Layout expected under ``datapath`` (the reference's on-disk contract):

    dicom_image/<subject>/<A|D|P|Pre>/<phase>_*.dcm
    segmentation_mask/<mask_id>_<phase>[lesion#].raw
    metadata.txt   (ID  Delta_A  Delta_D  Delta_P  Delta_Pre
                    Mask_Phase  Mask_ID — tab separated, one header row)

Run:  python -m gssd_torch.preprocessing.snuh --datapath <raw_drop> \
          --output <ml_ready_dir> [--img_size 512] [--workers 8]

The DICOM series reader is injectable (``series_reader``) so the
walker / alignment / merge logic is testable without pydicom.
"""

from __future__ import annotations

import argparse
import os
import re
from multiprocessing import Pool
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gssd_torch.preprocessing.dicom_io import (
    natsort_key,
    read_dicom_series,
    read_raw_mask,
)
from gssd_torch.preprocessing.mask2bbox import volume_to_samples
from gssd_torch.preprocessing.windowing import window_and_normalize

PHASES = ("A", "D", "P", "Pre")
PHASE_TOKEN = {"A": 0, "D": 1, "P": 2, "Pre": 3}


# ---------------------------------------------------------------------------
# metadata: xlsx -> txt -> merged final metadata
# ---------------------------------------------------------------------------

def extract_metadata_from_excel(xlsx_path: str, out_path: str) -> None:
    """metadata_preprocessed xlsx -> tab-separated delta/pivot table
    (reference :16-67). Columns: Index_New, A, D, P, Pre, MEDIP; the
    first data row is a units/header remnant and is dropped; NaN and
    string-typed deltas are normalized to ints."""
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover
        raise ImportError("pandas (with an xlsx engine) is required for "
                          "excel metadata extraction") from e

    df = pd.read_excel(xlsx_path)
    ids = df["Index_New"].tolist()[1:]
    deltas = {c: df[c].tolist()[1:] for c in ("A", "D", "P", "Pre")}
    pivot = df["MEDIP"].tolist()[1:]
    for col in deltas.values():
        for i, v in enumerate(col):
            if isinstance(v, str):
                v = int(v)
            if v != v:  # NaN
                v = 0
            col[i] = int(v)
    with open(out_path, "w") as f:
        f.write("ID\tA\tD\tP\tPre\tMEDIP\n")
        for i, sid in enumerate(ids):
            f.write(f"{sid}\t{deltas['A'][i]}\t{deltas['D'][i]}\t"
                    f"{deltas['P'][i]}\t{deltas['Pre'][i]}\t{pivot[i]}\n")


def merge_mask_metadata(
    lookup_path: str, metadata_path: str, out_path: str
) -> None:
    """Join the 1809 image/mask lookup (``<id> <mask_id> <phase>``
    lines) onto the delta table, asserting the annotation phase agrees
    (reference :70-102). Output adds the Mask_ID column."""
    with open(lookup_path) as f:
        lookup = dict()
        for line in f:
            parts = line.split()
            if parts:
                lookup[parts[0]] = (parts[1], parts[2])
    with open(metadata_path) as f:
        rows = [line.split() for line in f.readlines()[1:] if line.strip()]
    for row in rows:
        mask_id, mask_phase = lookup[row[0]]
        assert mask_phase == row[5], (
            f"mask phase for {row[0]}: lookup says {mask_phase}, "
            f"metadata says {row[5]} — 1809/1904 mismatch")
        row.append(mask_id)
    with open(out_path, "w") as f:
        f.write("ID\tDelta_A\tDelta_D\tDelta_P\tDelta_Pre\t"
                "Mask_Phase\tMask_ID\n")
        for row in rows:
            f.write("\t".join(row) + "\n")


def load_metadata(path: str) -> List[List[str]]:
    """Final metadata rows: [id, dA, dD, dP, dPre, phase, mask_id]
    (reference load_metadata :158-166)."""
    with open(path) as f:
        return [line.split() for line in f.readlines()[1:] if line.strip()]


# ---------------------------------------------------------------------------
# subject loading: DICOM walk + mask matching + delta alignment + merge
# ---------------------------------------------------------------------------

def load_subject(
    datapath: str,
    row: Sequence[str],
    img_size: int = 512,
    series_reader: Optional[Callable[[str, str], np.ndarray]] = None,
) -> Optional[Tuple[np.ndarray, List[np.ndarray], np.ndarray, Tuple[str, str]]]:
    """Load one subject's 4-phase volumes + delta-aligned merged mask.

    Returns (phases [4, H, W, Z] windowed+normalized f32, per-lesion
    mask list, merged mask [H, W, Z] uint8, (subject, mask_base)) or
    None when the dicom dir / masks are missing (skip-and-warn, :238-240,
    :282-284).
    """
    read = series_reader or read_dicom_series
    subject, d_a, d_d, d_p, d_pre, phase_name, mask_name = row[:7]
    deltas = dict(zip(PHASES, (int(d_a), int(d_d), int(d_p), int(d_pre))))

    subj_dir = os.path.join(datapath, "dicom_image", subject)
    if not os.path.isdir(subj_dir):
        print(f"WARNING: {subject} not found under dicom_image. skipping...")
        return None

    vols = []
    for phase in PHASES:
        vols.append(np.asarray(
            read(os.path.join(subj_dir, phase), phase + "_*")))

    # mask matching: usually <mask_id>_<phase>.raw, multi-lesion cases
    # are <mask_id>_<phase>1.raw, <mask_id>_<phase>2.raw, ...
    mask_base = f"{mask_name}_{phase_name}"
    mask_dir = os.path.join(datapath, "segmentation_mask")
    pivot_vol = vols[PHASES.index(phase_name)]
    z_pivot = pivot_vol.shape[2]
    delta = deltas[phase_name]
    if delta < 0:
        raise ValueError(
            f"{subject}: negative z-delta {delta} for phase "
            f"{phase_name} — a negative Python slice would silently "
            "select the wrong window; fix the xlsx metadata")
    # match <mask_base>.raw and <mask_base><digits>.raw only; a bare
    # startswith would also let phase 'P' absorb 'Pre' masks
    mask_re = re.compile(re.escape(mask_base) + r"\d*\.")
    mask_list, found = [], []
    for fname in sorted(os.listdir(mask_dir), key=natsort_key):
        if mask_re.match(fname):
            # raw masks share the CT in-plane resolution (512x512 for
            # the clinical drop; taken from the volume so synthetic
            # fixtures can be smaller)
            raw = read_raw_mask(os.path.join(mask_dir, fname),
                                pivot_vol.shape[0], pivot_vol.shape[1])
            cut = raw[:, :, delta:delta + z_pivot]
            assert cut.shape[2] == z_pivot, (
                f"{subject}/{fname}: mask z {raw.shape[2]} - delta "
                f"{delta} does not cover pivot z {z_pivot}")
            mask_list.append(cut)
            found.append(fname)
    if not mask_list:
        print(f"WARNING: dicom & masks pair: {subject} {mask_base}* "
              "NOT FOUND. skipped loading.")
        return None
    print(f"found dicom & masks pair: {subject} {found}")

    phases = [np.asarray(v, np.float32) for v in vols]
    phases = window_and_normalize(phases)

    if img_size != 512:
        import cv2

        phases = [cv2.resize(p, (img_size, img_size),
                             interpolation=cv2.INTER_CUBIC) for p in phases]
        mask_list = [cv2.resize(m, (img_size, img_size),
                                interpolation=cv2.INTER_NEAREST)
                     for m in mask_list]

    merged = np.sum(np.stack(mask_list), axis=0)
    merged[merged > 1] = 1
    assert np.array_equal(merged, merged.astype(bool)), "mask not binary"
    return (np.stack(phases), mask_list, merged.astype(np.uint8),
            (subject, mask_base))


# ---------------------------------------------------------------------------
# ml_ready emit
# ---------------------------------------------------------------------------

def build_subject_snuh(
    out_dir: str,
    datapath: str,
    row: Sequence[str],
    img_size: int = 512,
    series_reader=None,
) -> List[str]:
    """One subject raw -> per-slice npy quadruplets + metadata lines
    (dataset_creation_loop :387-428)."""
    loaded = load_subject(datapath, row, img_size, series_reader)
    if loaded is None:
        return []
    phases, _, merged, (subject, _) = loaded
    token = PHASE_TOKEN[row[5]]
    sub_dir = os.path.join(out_dir, subject)
    os.makedirs(sub_dir, exist_ok=True)
    lines = []
    for i, (ct, boxes, smoothed) in enumerate(volume_to_samples(
            phases, merged)):
        rel = f"{subject}_{i}"
        np.save(os.path.join(sub_dir, rel + "_ct.npy"), ct)
        np.save(os.path.join(sub_dir, rel + "_bbox.npy"), boxes)
        np.save(os.path.join(sub_dir, rel + "_mask.npy"), smoothed)
        np.save(os.path.join(sub_dir, rel + "_phase.npy"),
                np.int64(token))
        lines.append(f"{os.path.join(subject, rel)}|{subject}")
    return lines


def _worker(args):
    return build_subject_snuh(*args)


def build_snuh_dataset(
    datapath: str,
    out_dir: str,
    metadata_path: Optional[str] = None,
    img_size: int = 512,
    num_workers: int = 1,
    series_reader=None,
) -> List[str]:
    """Full raw drop -> ml_ready (the reference __main__, :432-475)."""
    metadata_path = metadata_path or os.path.join(datapath, "metadata.txt")
    rows = load_metadata(metadata_path)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(out_dir, datapath, row, img_size, series_reader)
            for row in rows]
    if num_workers > 1 and series_reader is None:
        with Pool(num_workers) as pool:
            per_subject = pool.map(_worker, jobs)
    else:
        per_subject = [_worker(j) for j in jobs]
    lines = [l for ls in per_subject for l in ls]
    with open(os.path.join(out_dir, "metadata.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} slices from {len(rows)} subjects to "
          f"{out_dir}")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(
        description="SNUH raw drop -> ml_ready npy dataset")
    p.add_argument("--datapath", required=True,
                   help="dir with dicom_image/, segmentation_mask/, "
                        "metadata.txt")
    p.add_argument("--output", required=True, help="ml_ready output dir")
    p.add_argument("--metadata", default=None,
                   help="final metadata txt (default "
                        "<datapath>/metadata.txt)")
    p.add_argument("--xlsx", default=None,
                   help="optional: extract metadata from this xlsx first")
    p.add_argument("--lookup", default=None,
                   help="optional: 1809 image/mask lookup txt to merge")
    p.add_argument("--img_size", default=512, type=int)
    p.add_argument("--workers", default=1, type=int)
    args = p.parse_args(argv)

    metadata = args.metadata or os.path.join(args.datapath, "metadata.txt")
    if args.xlsx is not None:
        tmp = metadata + ".deltas"
        extract_metadata_from_excel(args.xlsx, tmp)
        if args.lookup is not None:
            merge_mask_metadata(args.lookup, tmp, metadata)
        else:
            metadata = tmp
    build_snuh_dataset(args.datapath, args.output, metadata,
                       args.img_size, args.workers)


if __name__ == "__main__":
    main()
