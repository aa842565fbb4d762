"""NIfTI / VTK volume-and-mesh openers (gated on optional deps): the port
of ``gssd_tpu/preprocessing/volume_io.py``.

Rebuilds the reference's two exploratory opener scripts as reusable,
testable functions:

- reference lib/nii_opener.py:1-27 — load a .nii label volume with
  nibabel, undo the storage orientation (data arrives rotated 90° right
  and upside-down relative to the DICOM slices: rot90-left + flipud),
  and optionally dump per-slice JPGs as a sanity check.
- reference lib/vtk_opener.py:1-31 — read a .vtk polydata file and
  return its mesh node coordinates as an (N, 3) float array.

Neither nibabel nor vtk is a dependency of the port, so both loaders gate
their imports and raise a clear ImportError naming the missing
dependency; everything after the parse (orientation fix, slice dump)
is pure numpy and unit-tested against synthetic volumes.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "canonicalize_nii_orientation",
    "load_nii_volume",
    "dump_volume_slices",
    "load_vtk_mesh_points",
]


def canonicalize_nii_orientation(data: np.ndarray) -> np.ndarray:
    """Undo the nii storage orientation (nii_opener.py:10-17).

    The SNUH label volumes come back from ``nib.load(...).get_fdata()``
    rotated 90° to the right and upside-down relative to the original
    DICOM pixel grid; restore with a left rot90 then a vertical flip.
    Operates on the leading two (in-plane) axes of an (H, W[, Z]) array.
    """
    return np.flipud(np.rot90(data))


def load_nii_volume(path: str) -> np.ndarray:
    """Load a .nii/.nii.gz volume in DICOM orientation (H, W, Z).

    Requires nibabel (optional); raises ImportError naming it.
    """
    try:
        import nibabel as nib
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "load_nii_volume requires the optional dependency 'nibabel' "
            "(pip install nibabel)") from e
    return canonicalize_nii_orientation(np.asarray(nib.load(path).get_fdata()))


def dump_volume_slices(data: np.ndarray, outdir: str,
                       prefix: str = "label_") -> list[str]:
    """Write each z-slice of (H, W, Z) as a JPG (nii_opener.py:20-27).

    Slices are min-max scaled to uint8 per volume so label masks and CT
    windows both render. Returns the written paths.
    """
    os.makedirs(outdir, exist_ok=True)
    from PIL import Image

    lo, hi = float(data.min()), float(data.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    paths = []
    for z in range(data.shape[2]):
        img = ((data[:, :, z] - lo) * scale).astype(np.uint8)
        p = os.path.join(outdir, f"{prefix}{z}.jpg")
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def load_vtk_mesh_points(path: str) -> np.ndarray:
    """Read polydata node coordinates from a .vtk file -> (N, 3) f32.

    The reference (vtk_opener.py:11-23) goes through vtkPolyDataReader
    with all scalars/vectors enabled and converts the points array via
    vtk_to_numpy; this does the same when vtk is installed. Requires
    the optional 'vtk' package; raises ImportError naming it.
    """
    try:
        import vtk
        from vtk.util.numpy_support import vtk_to_numpy
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "load_vtk_mesh_points requires the optional dependency 'vtk' "
            "(pip install vtk)") from e
    reader = vtk.vtkPolyDataReader()
    reader.SetFileName(path)
    reader.ReadAllScalarsOn()
    reader.ReadAllVectorsOn()
    reader.Update()
    points = reader.GetOutput().GetPoints()
    return np.asarray(vtk_to_numpy(points.GetData()), dtype=np.float32)
