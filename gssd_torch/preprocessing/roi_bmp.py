"""Annotated-bmp ROI extraction: colored box-line pixels -> bbox files;
the port of ``gssd_tpu/preprocessing/roi_bmp.py``.

Rebuilds the reference's MICCAI-era annotation ingestion
(lib/roi_extractor_rgb.py and lib/roi_extractor_1904.py — byte-identical
scripts; lib/roi_extractor.py is the channel-sum variant the reference
itself marks "obsolete code, use rgb version" at :9):

- a 512x512x3 bmp carries an axis-aligned rectangle drawn in pure
  yellow (255,255,0) or pure red (255,0,0) (roi_extractor_rgb.py:26-27);
- the box is recovered from the row-major first/last matching pixel
  (:62-77) — exact for rectangle outlines because the first match is
  the left end of the top edge and the last is the right end of the
  bottom edge;
- yellow is checked before red, which is how the reference resolves
  the red-box-with-yellow-arrow subject (A258, :56-58);
- output is ``[x_min, y_min, x_max, y_max, 0]`` (class label 0,
  incremented inside the SSD model, :5-8) pickled per slice to
  ``<phase>_<suffix>.txt`` with the filename's ``[-8:-4]`` suffix
  convention (:87-91).

The per-file image reader is injectable so the tree walker is testable
without bmp assets on disk.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

RGB_YELLOW = (255, 255, 0)
RGB_RED = (255, 0, 0)
LESION_CLASS_LABEL = 0
# reference skip list: subjects excluded from the walk (:33-34) and the
# subject allowed to carry both colors (red bbox + yellow arrow, :56-58)
SKIP_SUBJECTS = ("A196", "A200")
BOTH_COLORS_OK = ("A258",)


def _first_last_box(idx: Tuple[np.ndarray, np.ndarray]) -> List[int]:
    """[x_min, y_min, x_max, y_max] from np.where's row-major match
    order (reference roi_extractor_rgb.py:62-77)."""
    ys, xs = idx
    return [int(xs[0]), int(ys[0]), int(xs[-1]), int(ys[-1])]


def extract_roi_box(
    image: np.ndarray,
    allow_both_colors: bool = False,
    yellow: Sequence[int] = RGB_YELLOW,
    red: Sequence[int] = RGB_RED,
) -> List[int]:
    """One bmp [H, W, 3] uint8 -> [x_min, y_min, x_max, y_max, label].

    Yellow is preferred over red (reference :62-71); exactly one color
    must be present unless ``allow_both_colors`` (the A258 exemption,
    :56-60). Degenerate (zero-area) boxes raise, as the reference's
    ``assert x_delta > 0 and y_delta > 0`` does (:79).
    """
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"expected [H, W, 3] rgb image, got {img.shape}")
    img = img[..., :3]
    idx_yellow = np.where(np.all(img == np.asarray(yellow), axis=-1))
    idx_red = np.where(np.all(img == np.asarray(red), axis=-1))
    n_yellow, n_red = len(idx_yellow[0]), len(idx_red[0])
    if not allow_both_colors:
        if n_yellow and n_red:
            raise ValueError("both yellow and red ROI pixels present")
        if not n_yellow and not n_red:
            raise ValueError("no ROI pixels found")
    if n_yellow:
        box = _first_last_box(idx_yellow)
    elif n_red:
        box = _first_last_box(idx_red)
    else:
        raise ValueError("no ROI pixels found")
    if not (box[2] > box[0] and box[3] > box[1]):
        raise ValueError(f"degenerate ROI box {box}")
    return box + [LESION_CLASS_LABEL]


def _read_bmp(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def extract_roi_tree(
    roi_image_path: str,
    roi_coordinate_path: str,
    skip_subjects: Sequence[str] = SKIP_SUBJECTS,
    both_colors_ok: Sequence[str] = BOTH_COLORS_OK,
    image_reader: Optional[Callable[[str], np.ndarray]] = None,
) -> int:
    """Walk ``<roi_image_path>/<subject>/<phase>/<slice>.bmp`` and write
    one pickled coordinate file per slice under the mirrored
    ``roi_coordinate_path`` tree (reference :31-91). Returns the number
    of slices written."""
    reader = image_reader or _read_bmp
    written = 0
    for subject in sorted(glob.glob(os.path.join(roi_image_path, "*"))):
        name = os.path.basename(os.path.normpath(subject))
        if name in skip_subjects:
            continue
        out_subject = os.path.join(roi_coordinate_path, name)
        os.makedirs(out_subject, exist_ok=True)
        for phase in sorted(glob.glob(os.path.join(subject, "*"))):
            phase_name = os.path.basename(os.path.normpath(phase))
            out_phase = os.path.join(out_subject, phase_name)
            os.makedirs(out_phase, exist_ok=True)
            for slice_path in sorted(glob.glob(os.path.join(phase, "*"))):
                coord = extract_roi_box(
                    reader(slice_path),
                    allow_both_colors=name in both_colors_ok,
                )
                # the reference names outputs by the slice filename's
                # [-8:-4] characters (e.g. '0012' of 'P_0012.bmp', :87)
                suffix = slice_path[-8:-4]
                out_file = os.path.join(
                    out_phase, f"{phase_name}_{suffix}.txt")
                with open(out_file, "wb") as f:
                    pickle.dump(coord, f)
                written += 1
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Extract bbox coordinates from ROI-annotated bmps")
    p.add_argument("--roi_image_path", required=True)
    p.add_argument("--roi_coordinate_path", required=True)
    args = p.parse_args(argv)
    n = extract_roi_tree(args.roi_image_path, args.roi_coordinate_path)
    print(f"wrote {n} coordinate files to {args.roi_coordinate_path}")


if __name__ == "__main__":
    main()
