"""3Dircadb public-data ingestion: the port of
``gssd_tpu/preprocessing/ircadb.py``.

Reference: lib/extract_3dircadb.py — read the PATIENT_DICOM series and
MASKS_DICOM tumor/liver masks, window ([-100, 400] clip after zeroing
>1200HU), 3-slice stacking, replicate the single phase x4 (the public
set is single-phase), and dump an h5 of ct/label groups (:112-135).
Here the same pipeline can emit either the legacy h5 layout or the
ml_ready npy contract the training stack consumes.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from gssd_torch.preprocessing.dicom_io import read_dicom_series
from gssd_torch.preprocessing.mask2bbox import volume_to_samples
from gssd_torch.preprocessing.windowing import ircadb_window


def read_liver_lesion_masks(masks_dir: str) -> np.ndarray:
    """Merge tumor* masks (and livertumor*) into one binary volume."""
    mask_dirs = sorted(
        d for d in glob.glob(os.path.join(masks_dir, "*"))
        if os.path.isdir(d) and "tumor" in os.path.basename(d).lower()
    )
    merged = None
    for d in mask_dirs:
        vol = read_dicom_series(d)
        binary = (vol > 0).astype(np.uint8)
        merged = binary if merged is None else (merged | binary)
    if merged is None:
        raise ValueError(f"no tumor masks under {masks_dir}")
    return merged


def extract_patient(patient_dir: str) -> tuple:
    """One 3Dircadb patient dir -> (phases [4, H, W, Z], mask [H, W, Z])."""
    img = read_dicom_series(os.path.join(patient_dir, "PATIENT_DICOM"))
    mask = read_liver_lesion_masks(os.path.join(patient_dir, "MASKS_DICOM"))
    img = img.astype(np.float32)
    for z in range(img.shape[2]):
        img[:, :, z] = ircadb_window(img[:, :, z])
    phases = np.stack([img] * 4)  # single-phase set replicated x4
    return phases, mask


def extract_to_ml_ready(patient_dirs: List[str], out_dir: str) -> List[str]:
    from gssd_torch.preprocessing.builder import build_dataset

    subjects = {}
    for d in patient_dirs:
        name = os.path.basename(os.path.normpath(d)).replace(".", "_")
        subjects[name] = extract_patient(d)
    return build_dataset(out_dir, subjects, window=False)


def extract_to_h5(patient_dir: str, h5_path: str) -> None:
    """Legacy h5 dump parity (extract_3dircadb.py:112-135)."""
    import h5py

    phases, mask = extract_patient(patient_dir)
    img = np.transpose(phases[0], (2, 0, 1))
    lbl = np.transpose(mask, (2, 0, 1))
    img3 = np.stack([img[i - 1:i + 2] for i in range(1, img.shape[0] - 1)])
    lbl3 = np.stack([lbl[i - 1:i + 2] for i in range(1, lbl.shape[0] - 1)])
    img4 = np.stack([img3] * 4)
    lbl4 = np.stack([lbl3] * 4)
    with h5py.File(h5_path, "w") as f:
        f.create_group("ct").create_dataset("ct_0", data=img4)
        f.create_group("label").create_dataset("coordinate_0", data=lbl4)
