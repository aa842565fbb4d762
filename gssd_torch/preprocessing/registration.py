"""Multi-phase rigid + b-spline registration (SimpleITK, gated): the port
of ``gssd_tpu/preprocessing/registration.py``.

Reference: lib/register_multiphase.py (:29-52) — per-slice Elastix
affine + bspline registration of every phase onto the portal phase
(index 2), and lib/non_rigid.py (:54-66) — the same plus Transformix
warping of the lesion mask along the annotated phase. Produces the
``_registration`` dataset variant. SimpleITK is an optional
dependency; the functions raise a clear ImportError when it is absent.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

PORTAL_IDX = 2


def _require_sitk():
    try:
        import SimpleITK as sitk  # noqa: F401

        return sitk
    except ImportError as e:
        raise ImportError(
            "SimpleITK (with Elastix) is required for multi-phase "
            "registration; the rest of the pipeline works on "
            "unregistered phases (that is the GSSD++ design point)"
        ) from e


def register_slice_to_portal(
    phases: np.ndarray, use_bspline: bool = True
) -> np.ndarray:
    """[4, H, W] one slice across phases -> phases registered onto the
    portal phase with affine (+ optional b-spline) Elastix stages."""
    sitk = _require_sitk()
    fixed = sitk.GetImageFromArray(phases[PORTAL_IDX].astype(np.float32))
    out = phases.copy()
    for p in range(phases.shape[0]):
        if p == PORTAL_IDX:
            continue
        moving = sitk.GetImageFromArray(phases[p].astype(np.float32))
        elastix = sitk.ElastixImageFilter()
        elastix.SetFixedImage(fixed)
        elastix.SetMovingImage(moving)
        maps = [sitk.GetDefaultParameterMap("affine")]
        if use_bspline:
            maps.append(sitk.GetDefaultParameterMap("bspline"))
        elastix.SetParameterMap(maps)
        elastix.LogToConsoleOff()
        elastix.Execute()
        out[p] = sitk.GetArrayFromImage(elastix.GetResultImage())
    return out


def register_volume_to_portal(
    phases: np.ndarray, mask: Optional[np.ndarray] = None,
    annotated_phase: int = PORTAL_IDX, use_bspline: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Per-slice registration of [4, H, W, Z] volumes; optionally warps
    the mask along the annotated phase's transform (non_rigid.py)."""
    sitk = _require_sitk()
    out = phases.copy()
    out_mask = None if mask is None else mask.copy()
    for z in range(phases.shape[3]):
        fixed = sitk.GetImageFromArray(
            phases[PORTAL_IDX, :, :, z].astype(np.float32))
        for p in range(phases.shape[0]):
            if p == PORTAL_IDX:
                continue
            moving = sitk.GetImageFromArray(
                phases[p, :, :, z].astype(np.float32))
            elastix = sitk.ElastixImageFilter()
            elastix.SetFixedImage(fixed)
            elastix.SetMovingImage(moving)
            maps = [sitk.GetDefaultParameterMap("affine")]
            if use_bspline:
                maps.append(sitk.GetDefaultParameterMap("bspline"))
            elastix.SetParameterMap(maps)
            elastix.LogToConsoleOff()
            elastix.Execute()
            out[p, :, :, z] = sitk.GetArrayFromImage(
                elastix.GetResultImage())
            if mask is not None and p == annotated_phase:
                tx = sitk.TransformixImageFilter()
                tx.SetTransformParameterMap(
                    elastix.GetTransformParameterMap())
                tx.SetMovingImage(sitk.GetImageFromArray(
                    mask[:, :, z].astype(np.float32)))
                tx.Execute()
                out_mask[:, :, z] = (
                    sitk.GetArrayFromImage(tx.GetResultImage()) > 0.5
                ).astype(mask.dtype)
    return out, out_mask
