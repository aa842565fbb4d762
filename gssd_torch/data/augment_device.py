"""Training augmentation on the card: host geometry, device pixels.

The JAX package's DeviceAugmentation, draw for draw:

- **Host** (numpy, box arithmetic only): per item the photometric
  scalars, the Expand canvas placement, the IoU-constrained
  RandomSampleCrop rectangle and the mirror flag, drawn in the order of
  the host pipeline (``data/augment.py``) from its samplers, and folded
  into one affine map output pixel -> source pixel, with the boxes
  transformed and filtered to match.
- **Device** (``warp``): the uint8 batch to f32, brightness and
  contrast, a separable bilinear warp as two batched products with
  per-item hat matrices (``hat_matrices``, built on the device from the
  affine scalars), the Expand canvas' mean fill where the hat mass falls
  outside the image, the mean subtracted and the per-item min-max
  normalise.

The op order (jitter -> photometric -> expand -> crop -> mirror ->
normalise -> resize) is the host pipeline's; the pixels differ from it
only by the interpolation order (one warp in place of pad, crop and
resize). The products are plain library products in f32: keep
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default), as a
TF32 warp reads ~1e-4..1e-3 off in [0, 1] images.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gssd_torch.data.augment import SSDAugmentation, _crop_overlap


@dataclass
class GeomParams:
    """Per-item affine: src = scale * dst + offset (y, x), the x flip
    applied to dst before it."""

    scale: np.ndarray  # [B, 2] (y, x)
    offset: np.ndarray  # [B, 2]
    flip: np.ndarray  # [B] bool
    brightness: np.ndarray  # [B]
    contrast: np.ndarray  # [B]

    def take(self, rows) -> "GeomParams":
        """The items ``rows`` (a slice or index array) of the batch."""
        return GeomParams(*(np.asarray(a)[rows] for a in (
            self.scale, self.offset, self.flip, self.brightness, self.contrast)))

    def to(self, device) -> Tuple[torch.Tensor, ...]:
        """(scale, offset, flip, brightness, contrast) as tensors on ``device``."""
        return tuple(torch.from_numpy(np.asarray(a)).to(device, non_blocking=True)
                     for a in (self.scale, self.offset, self.flip, self.brightness,
                               self.contrast))


def hat_matrices(scale: torch.Tensor, offset: torch.Tensor, flip: torch.Tensor,
                 size: int, src_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separable hat matrices [B, size, src_size] (f32, on scale's
    device) of the warp dst -> src: output pixel centres dst + 0.5, the
    x flip as size - dst, mapped by the affine, then - 0.5; each row
    holds max(0, 1 - |src - grid|), which vanishes outside the image."""
    dev = scale.device
    dst = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    grid = torch.arange(src_size, dtype=torch.float32, device=dev)
    sy = dst[None] * scale[:, 0:1] + offset[:, 0:1] - 0.5
    mat_y = torch.clamp(1.0 - (sy[:, :, None] - grid).abs(), min=0.0)
    dxp = torch.where(flip[:, None], size - dst[None], dst[None])
    sx = dxp * scale[:, 1:2] + offset[:, 1:2] - 0.5
    mat_x = torch.clamp(1.0 - (sx[:, :, None] - grid).abs(), min=0.0)
    return mat_y, mat_x


def warp(images: torch.Tensor, mat_y: torch.Tensor, mat_x: torch.Tensor,
         brightness: torch.Tensor, contrast: torch.Tensor, mean: float = 0.0,
         use_normalize: bool = True, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S, S, C] source batch (uint8 or float, 0..255) -> [B, O, O, C]
    augmented batch in ``dtype``, on the inputs' device; mat_y, mat_x
    [B, O, S] from ``hat_matrices``. float64 gives the reference the card's
    f32 warp is held to."""
    x = images.to(dtype, copy=True)
    x.add_(brightness.to(dtype)[:, None, None, None])
    x.mul_(contrast.to(dtype)[:, None, None, None])
    mat_y, mat_x = mat_y.to(dtype), mat_x.to(dtype)
    x = torch.einsum("bos,bswc->bowc", mat_y, x)
    x = torch.einsum("bot,bwtc->bwoc", mat_x, x)
    # hat mass lost outside the source image is the Expand canvas' mean
    # fill (the photometric change applies to the image only)
    mass = mat_y.sum(-1)[:, :, None] * mat_x.sum(-1)[:, None, :]
    x = x + (1.0 - mass)[..., None] * mean
    x = x - mean
    if use_normalize:
        lo = x.amin(dim=(1, 2, 3), keepdim=True)
        hi = x.amax(dim=(1, 2, 3), keepdim=True)
        x = (x - lo) / torch.clamp(hi - lo, min=1e-6)
    return x


class DeviceAugmentation:
    """Host geometry sampler plus the device warp.

        aug = DeviceAugmentation(size=300, src_size=512, seed=..., device="cuda")
        batch = aug(raw_images, boxes_list, labels_list)

    ``raw_images`` [B, S, S, 12] (uint8 0..255, host or device) and each
    item's normalised boxes and labels (``collate_raw``) -> the step's
    batch dict, every leaf a tensor on ``device``: ``image`` [B, size,
    size, 12] f32, ``boxes`` [B, max_gt, 4], ``labels`` [B, max_gt] int32,
    ``valid`` [B, max_gt] bool."""

    def __init__(self, size: int = 300, src_size: int = 512, pixeljitter: float = 0.01,
                 ratio: float = 1.5, mean: float = 0.0, use_normalize: bool = True,
                 seed: int = 1111, max_gt: int = 16, device="cuda"):
        self.size = size
        self.src_size = src_size
        self.mean = mean
        self.use_normalize = use_normalize
        self.max_gt = max_gt
        self.device = torch.device(device)
        # the host pipeline's samplers, for the same semantics
        self._host = SSDAugmentation(pixeljitter=pixeljitter, ratio=ratio, size=size,
                                     mean=mean, use_normalize=use_normalize, seed=seed)

    @property
    def rng(self) -> np.random.Generator:
        """THE generator: geometry draws from it and the jitter noise from
        the host sampler's, which is the same object, so reseeding it per
        batch (``DeviceCacheLoader``) reseeds both. Two generators broke
        the stream's exact resume where the jitter is non-zero (sources
        of 128 pixels and more)."""
        return self._host.rng

    @rng.setter
    def rng(self, value: np.random.Generator) -> None:
        self._host.rng = value

    # ---- host side -----------------------------------------------------

    def sample_geometry(self, boxes_norm: np.ndarray, labels: np.ndarray):
        """One item: normalised [n, 4] boxes -> (scale, offset, flip,
        brightness, contrast, out_boxes, out_labels), the host pipeline's
        ops applied to the box coordinates."""
        S = self.src_size
        rng = self.rng
        boxes = boxes_norm * S  # to source pixels
        # pixel_jitter reads only the image's shape: a zero-copy stub
        boxes = self._host.pixel_jitter(np.broadcast_to(np.float32(0.0), (1, S, S, 1)),
                                        boxes.astype(np.float32))

        brightness = rng.uniform(-32, 32) if rng.random() < 0.5 else 0.0
        contrast = rng.uniform(0.5, 1.5) if rng.random() < 0.5 else 1.0

        # Expand: a virtual canvas of ratio r, the image at (left, top)
        r = rng.uniform(1.0, self._host.ratio)
        canvas = int(S * r)
        left = int(rng.uniform(0, canvas - S))
        top = int(rng.uniform(0, canvas - S))
        cboxes = boxes.copy()
        cboxes[:, 0::2] += left
        cboxes[:, 1::2] += top

        rect, kept = self._sample_crop_rect(canvas, cboxes)
        kb = cboxes[kept].copy()
        kl = labels[kept]
        kb[:, :2] = np.maximum(kb[:, :2], rect[:2]) - rect[:2]
        kb[:, 2:] = np.minimum(kb[:, 2:], rect[2:]) - rect[:2]
        cw, ch = rect[2] - rect[0], rect[3] - rect[1]

        flip = rng.random() < 0.5
        if flip:
            kb = kb.copy()
            kb[:, 0::2] = cw - kb[:, 2::-2]

        # src_canvas = scale * dst + offset, then to image coordinates
        scale = np.array([ch / self.size, cw / self.size], np.float32)
        offset = np.array([rect[1] - top, rect[0] - left], np.float32)
        out_boxes = kb / np.array([cw, ch, cw, ch], np.float32)
        return scale, offset, flip, brightness, contrast, out_boxes.astype(np.float32), kl

    def _sample_crop_rect(self, canvas: int, boxes: np.ndarray, max_modes: int = 200):
        """RandomSampleCrop's rectangle on the canvas (the host sampler's
        option menu and constraints) -> (rect, kept boxes mask)."""
        rng = self.rng
        full = np.array([0, 0, canvas, canvas])
        options = SSDAugmentation.SAMPLE_OPTIONS
        for _ in range(max_modes):
            mode = options[int(rng.integers(len(options)))]
            if mode is None:
                return full, np.ones(len(boxes), bool)
            min_iou = mode[0] if mode[0] is not None else -np.inf
            max_iou = mode[1] if mode[1] is not None else np.inf
            for _ in range(50):
                cw = rng.uniform(0.3 * canvas, canvas)
                ch = rng.uniform(0.3 * canvas, canvas)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = rng.uniform(0, canvas - cw)
                top = rng.uniform(0, canvas - ch)
                rect = np.array([int(left), int(top), int(left + cw), int(top + ch)])
                ov = _crop_overlap(boxes, rect)
                if ov.min() < min_iou and max_iou < ov.max():
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                        & (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
                if not keep.any():
                    continue
                return rect, keep
        return full, np.ones(len(boxes), bool)

    def sample_batch(self, boxes_list: Sequence[np.ndarray], labels_list: Sequence[np.ndarray]
                     ) -> Tuple[GeomParams, Dict[str, np.ndarray]]:
        """Each item's geometry in turn -> (GeomParams, {"boxes", "labels",
        "valid"} padded to max_gt)."""
        B = len(boxes_list)
        scales = np.zeros((B, 2), np.float32)
        offsets = np.zeros((B, 2), np.float32)
        flips = np.zeros(B, bool)
        bright = np.zeros(B, np.float32)
        contr = np.ones(B, np.float32)
        out_b = np.zeros((B, self.max_gt, 4), np.float32)
        out_l = np.zeros((B, self.max_gt), np.int32)
        out_v = np.zeros((B, self.max_gt), bool)
        for b in range(B):
            (scales[b], offsets[b], flips[b], bright[b], contr[b], kb, kl
             ) = self.sample_geometry(boxes_list[b], labels_list[b])
            n = min(len(kb), self.max_gt)
            out_b[b, :n] = kb[:n]
            out_l[b, :n] = kl[:n]
            out_v[b, :n] = True
        return (GeomParams(scales, offsets, flips, bright, contr),
                {"boxes": out_b, "labels": out_l, "valid": out_v})

    def interp_matrices(self, geom: GeomParams) -> Tuple[np.ndarray, np.ndarray]:
        """``hat_matrices`` built on the host in numpy, item by item: the
        reference the device-built matrices are held to."""
        B = len(geom.flip)
        S, O = self.src_size, self.size
        dst = np.arange(O, dtype=np.float32) + 0.5
        grid = np.arange(S, dtype=np.float32)
        mat_y = np.zeros((B, O, S), np.float32)
        mat_x = np.zeros((B, O, S), np.float32)
        for b in range(B):
            sy = dst * geom.scale[b, 0] + geom.offset[b, 0] - 0.5
            mat_y[b] = np.maximum(0, 1 - np.abs(sy[:, None] - grid[None]))
            dx = O - dst if geom.flip[b] else dst
            sx = dx * geom.scale[b, 1] + geom.offset[b, 1] - 0.5
            mat_x[b] = np.maximum(0, 1 - np.abs(sx[:, None] - grid[None]))
        return mat_y, mat_x

    # ---- device side ---------------------------------------------------

    def warp_batch(self, raw: torch.Tensor, geom: GeomParams) -> torch.Tensor:
        """The device half: ``raw`` [B, S, S, C] on the device, warped by
        ``geom`` -> [B, size, size, C] f32."""
        scale, offset, flip, bright, contr = geom.to(self.device)
        mat_y, mat_x = hat_matrices(scale, offset, flip, self.size, self.src_size)
        return warp(raw, mat_y, mat_x, bright, contr, self.mean, self.use_normalize)

    def __call__(self, raw_images, boxes_list: List[np.ndarray],
                 labels_list: List[np.ndarray], rows: Optional[slice] = None
                 ) -> Dict[str, torch.Tensor]:
        """The augmented batch. With ``rows`` (a data-parallel rank's), the
        geometry of the whole batch (``boxes_list``, ``labels_list``) is
        drawn, as every rank draws it, and ``raw_images`` holds only those
        rows, the ones warped and returned."""
        geom, targets = self.sample_batch(boxes_list, labels_list)
        if rows is not None:
            geom = geom.take(rows)
            targets = {k: v[rows] for k, v in targets.items()}
        raw = torch.as_tensor(raw_images).to(self.device, non_blocking=True)
        out = {"image": self.warp_batch(raw, geom)}
        out.update({k: torch.from_numpy(v).to(self.device, non_blocking=True)
                    for k, v in targets.items()})
        return out
