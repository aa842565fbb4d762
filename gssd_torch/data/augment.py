"""Training augmentation (host-side numpy, 4D-aware).

The JAX package's SSDAugmentation, op for op and in the same order, with
the same draws from one seeded ``np.random.default_rng``, on [phase, H,
W, 3] float 0..255 arrays whose geometry is shared across phases:

  float cast -> absolute coords -> PixelJitter -> photometric
  (brightness + contrast only; colour ops are off for CT) -> Expand
  (mean-padded canvas up to ``ratio``) -> RandomSampleCrop
  (IoU-constrained) -> RandomMirror -> percent coords -> subtract mean
  -> [portal only] -> [min-max normalise] -> resize to the model size.

PixelJitter truncates the jitter toward zero and keeps the unjittered
boxes if any box would invert. The resize is the port's torch
``resize_phases`` (bilinear, half-pixel centres, no antialiasing).

With ``pixel_link_size`` set (PixelLink training), the third item is
the dict of ``make_pixel_link_targets`` at that size and
``pixel_link_version``, with the labels under "labels".
"""

from __future__ import annotations

import numpy as np

from typing import Optional

from gssd_torch.data.pixellink_targets import make_pixel_link_targets
from gssd_torch.data.transforms import PORTAL_PHASE, resize_phases


def _crop_overlap(boxes: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """IoU of each box against one crop rect (both pixel point-form)."""
    ix1 = np.maximum(boxes[:, 0], rect[0])
    iy1 = np.maximum(boxes[:, 1], rect[1])
    ix2 = np.minimum(boxes[:, 2], rect[2])
    iy2 = np.minimum(boxes[:, 3], rect[3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
    return inter / (area_b + area_r - inter)


class SSDAugmentation:
    SAMPLE_OPTIONS = (None, (0.1, None), (0.3, None), (0.7, None),
                      (0.9, None), (None, None))

    def __init__(
        self,
        pixeljitter: float = 0.01,
        ratio: float = 1.5,
        size: int = 300,
        mean: float = 0.0,
        use_normalize: bool = True,
        p_only: bool = False,
        seed: int = 1111,
        pixel_link_size: Optional[int] = None,
        pixel_link_version: str = "4s",
    ):
        self.pixeljitter = pixeljitter
        self.ratio = ratio
        self.size = size
        self.mean = mean
        self.use_normalize = use_normalize
        self.p_only = p_only
        self.rng = np.random.default_rng(seed)
        self.pixel_link_size = pixel_link_size
        self.pixel_link_version = pixel_link_version

    # ---- individual ops ----------------------------------------------

    def pixel_jitter(self, img, boxes):
        p, h, w, _ = img.shape
        noise = self.rng.uniform(-self.pixeljitter, self.pixeljitter,
                                 boxes.shape)
        noise *= np.array([w, h, w, h])
        noise = np.trunc(noise).astype(np.float32)
        jittered = boxes + noise
        ok = (jittered[:, 0] < jittered[:, 2]).all() and (
            jittered[:, 1] < jittered[:, 3]
        ).all()
        return jittered if ok else boxes

    def photometric(self, img):
        img = img.copy()
        if self.rng.random() < 0.5:
            img += self.rng.uniform(-32, 32)
        if self.rng.random() < 0.5:
            img *= self.rng.uniform(0.5, 1.5)
        return img

    def expand(self, img, boxes):
        p, h, w, d = img.shape
        ratio = self.rng.uniform(1.0, self.ratio)
        left = int(self.rng.uniform(0, w * ratio - w))
        top = int(self.rng.uniform(0, h * ratio - h))
        canvas = np.full((p, int(h * ratio), int(w * ratio), d), self.mean,
                         img.dtype)
        canvas[:, top:top + h, left:left + w] = img
        boxes = boxes.copy()
        boxes[:, 0::2] += left
        boxes[:, 1::2] += top
        return canvas, boxes

    def sample_crop(self, img, boxes, labels, max_modes: int = 200):
        p, h, w, _ = img.shape
        for _ in range(max_modes):
            mode = self.SAMPLE_OPTIONS[
                int(self.rng.integers(len(self.SAMPLE_OPTIONS)))
            ]
            if mode is None:
                return img, boxes, labels
            min_iou = mode[0] if mode[0] is not None else -np.inf
            max_iou = mode[1] if mode[1] is not None else np.inf
            for _ in range(50):
                cw = self.rng.uniform(0.3 * w, w)
                ch = self.rng.uniform(0.3 * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = self.rng.uniform(0, w - cw)
                top = self.rng.uniform(0, h - ch)
                rect = np.array(
                    [int(left), int(top), int(left + cw), int(top + ch)]
                )
                ov = _crop_overlap(boxes, rect)
                # retry only when both constraints fail (ssd.pytorch
                # semantics, augmentations.py:330-333)
                if ov.min() < min_iou and max_iou < ov.max():
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = (
                    (rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                    & (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1])
                )
                if not keep.any():
                    continue
                cropped = img[:, rect[1]:rect[3], rect[0]:rect[2]]
                nb = boxes[keep].copy()
                nb[:, :2] = np.maximum(nb[:, :2], rect[:2]) - rect[:2]
                nb[:, 2:] = np.minimum(nb[:, 2:], rect[2:]) - rect[:2]
                return cropped, nb, labels[keep]
        return img, boxes, labels

    def mirror(self, img, boxes):
        if self.rng.random() < 0.5:
            w = img.shape[2]
            img = img[:, :, ::-1]
            boxes = boxes.copy()
            boxes[:, 0::2] = w - boxes[:, 2::-2]
        return img, boxes

    # ---- the composed pipeline ---------------------------------------

    def __call__(self, img: np.ndarray, boxes: np.ndarray, labels: np.ndarray):
        img = img.astype(np.float32)
        p, h, w, _ = img.shape
        boxes = boxes.astype(np.float32).copy()
        boxes[:, 0::2] *= w
        boxes[:, 1::2] *= h

        boxes = self.pixel_jitter(img, boxes)
        img = self.photometric(img)
        img, boxes = self.expand(img, boxes)
        img, boxes, labels = self.sample_crop(img, boxes, labels)
        img, boxes = self.mirror(img, boxes)

        p, h, w, _ = img.shape
        boxes = boxes.copy()
        boxes[:, 0::2] /= w
        boxes[:, 1::2] /= h
        img = img - self.mean
        if self.p_only:
            img = np.repeat(img[PORTAL_PHASE:PORTAL_PHASE + 1], p, axis=0)
        if self.use_normalize:
            lo, hi = img.min(), img.max()
            assert hi != lo, "all-constant image in Normalize"
            img = (img - lo) / (hi - lo)
        img = resize_phases(np.ascontiguousarray(img), self.size)
        if self.pixel_link_size is not None:
            targets = make_pixel_link_targets(boxes, self.pixel_link_size,
                                              self.pixel_link_version)
            targets["labels"] = labels
            return img, boxes.astype(np.float32), targets
        return img, boxes.astype(np.float32), labels
