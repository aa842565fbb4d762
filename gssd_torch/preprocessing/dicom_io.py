"""DICOM / raw-mask readers (gated on pydicom availability): the port of
``gssd_tpu/preprocessing/dicom_io.py``.

Reference: lib/data_checker_year1_extended_1904.py read_dicom_series
(:105-128) and the raw uint8 mask reader (:131-155);
lib/extract_3dircadb.py readers (:12-74).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np


def natsort_key(name: str):
    """Natural sort key ('P_2' < 'P_10'); the reference natsorts DICOM
    slice filenames (data_checker...1904.py:113)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _require_pydicom():
    try:
        import pydicom  # noqa: F401

        return pydicom
    except ImportError as e:
        raise ImportError(
            "pydicom is required for DICOM ingestion; install it or use "
            "pre-extracted npy/h5 inputs"
        ) from e


def read_dicom_series(directory: str, filepattern: str = "*") -> np.ndarray:
    """Read a z-sorted DICOM series -> [H, W, Z] int16 HU array."""
    pydicom = _require_pydicom()
    if not os.path.isdir(directory):
        raise ValueError(f"not a directory: {directory}")
    files = sorted(glob.glob(os.path.join(directory, filepattern)),
                   key=natsort_key)
    files = [f for f in files if os.path.isfile(f)]
    slices = [pydicom.dcmread(f) for f in files]
    slices = [s for s in slices if hasattr(s, "pixel_array")]
    slices.sort(key=lambda s: float(getattr(s, "InstanceNumber", 0)))
    vol = np.stack([s.pixel_array for s in slices], axis=-1).astype(np.int16)
    # apply rescale slope/intercept when present (HU conversion)
    s0 = slices[0]
    slope = float(getattr(s0, "RescaleSlope", 1.0))
    intercept = float(getattr(s0, "RescaleIntercept", 0.0))
    if slope != 1.0 or intercept != 0.0:
        vol = (vol.astype(np.float32) * slope + intercept).astype(np.int16)
    return vol


def read_raw_mask(
    path: str, height: int = 512, width: int = 512
) -> np.ndarray:
    """uint8 .raw segmentation mask -> [H, W, Z] binary array
    (reference raw-mask reader, data_checker...1904.py:131-155)."""
    raw = np.fromfile(path, dtype=np.uint8)
    z = raw.size // (height * width)
    if z * height * width != raw.size:
        raise ValueError(f"raw size {raw.size} not divisible by "
                         f"{height}x{width}")
    vol = raw.reshape(z, height, width).transpose(1, 2, 0)
    uniq = np.unique(vol)
    if not np.all(np.isin(uniq, [0, 1, 255])):
        raise ValueError(f"mask is not binary: values {uniq[:10]}")
    return (vol > 0).astype(np.uint8)
