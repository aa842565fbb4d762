"""The training batch in plain NumPy and PyTorch: which slices, which
augmentation draws, and the warped, normalised images.

The reference works the batch out again from the raw uint8 slices and
their boxes, as the GSSD++ recipe's ``device_cached`` input path defines
it:

- Batch j takes positions j*B .. (j+1)*B - 1 of the stream of epoch
  permutations, epoch e's permutation drawn from
  ``default_rng((seed << 24) ^ e)``.
- Batch j's draws come from ``default_rng((seed << 20) ^ j)``, item by
  item: the box jitter, brightness and contrast, the Expand canvas
  (ratio up to ``expand_ratio``) and placement, SSD's IoU-constrained
  random crop, the mirror.
- Each item's draws fold into one affine map output pixel -> source pixel;
  the image is warped by it as a separable bilinear resample (the hat
  weights max(0, 1 - |src - grid|)), brightness and contrast applied
  first, the canvas' mean fill where the weights fall outside the image,
  then the mean subtracted and the item min-max normalised to [0, 1].

The reference warps in float64 (the program's float32 warp lies within
about 1e-5 of it in [0, 1] images).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

SAMPLE_OPTIONS = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None), (None, None))


def batch_indices(seed: int, n: int, j: int, batch: int) -> List[int]:
    out = []
    for t in range(j * batch, (j + 1) * batch):
        e, pos = divmod(t, n)
        out.append(int(np.random.default_rng((seed << 24) ^ e).permutation(n)[pos]))
    return out


def _crop_overlap(boxes, rect):
    ix1 = np.maximum(boxes[:, 0], rect[0])
    iy1 = np.maximum(boxes[:, 1], rect[1])
    ix2 = np.minimum(boxes[:, 2], rect[2])
    iy2 = np.minimum(boxes[:, 3], rect[3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
    return inter / (area_b + area_r - inter)


def _crop_rect(rng, canvas: int, boxes):
    full = np.array([0, 0, canvas, canvas])
    for _ in range(200):
        mode = SAMPLE_OPTIONS[int(rng.integers(len(SAMPLE_OPTIONS)))]
        if mode is None:
            return full, np.ones(len(boxes), bool)
        lo = mode[0] if mode[0] is not None else -np.inf
        hi = mode[1] if mode[1] is not None else np.inf
        for _ in range(50):
            cw = rng.uniform(0.3 * canvas, canvas)
            ch = rng.uniform(0.3 * canvas, canvas)
            if ch / cw < 0.5 or ch / cw > 2:
                continue
            left = rng.uniform(0, canvas - cw)
            top = rng.uniform(0, canvas - ch)
            rect = np.array([int(left), int(top), int(left + cw), int(top + ch)])
            ov = _crop_overlap(boxes, rect)
            if ov.min() < lo and hi < ov.max():
                continue
            c = (boxes[:, :2] + boxes[:, 2:]) / 2
            keep = (rect[0] < c[:, 0]) & (rect[1] < c[:, 1]) & (rect[2] > c[:, 0]) \
                & (rect[3] > c[:, 1])
            if keep.any():
                return rect, keep
    return full, np.ones(len(boxes), bool)


def _item(rng, boxes_norm, labels, S: int, size: int, jitter: float, ratio: float):
    """One item's draws -> (scale, offset, flip, brightness, contrast,
    boxes in [0, 1] of the output, labels)."""
    boxes = (boxes_norm * S).astype(np.float32)
    noise = rng.uniform(-jitter, jitter, boxes.shape) * np.array([S, S, S, S])
    jittered = boxes + np.trunc(noise).astype(np.float32)
    if (jittered[:, 0] < jittered[:, 2]).all() and (jittered[:, 1] < jittered[:, 3]).all():
        boxes = jittered
    bright = rng.uniform(-32, 32) if rng.random() < 0.5 else 0.0
    contr = rng.uniform(0.5, 1.5) if rng.random() < 0.5 else 1.0
    r = rng.uniform(1.0, ratio)
    canvas = int(S * r)
    left = int(rng.uniform(0, canvas - S))
    top = int(rng.uniform(0, canvas - S))
    cb = boxes.copy()
    cb[:, 0::2] += left
    cb[:, 1::2] += top
    rect, kept = _crop_rect(rng, canvas, cb)
    kb, kl = cb[kept].copy(), labels[kept]
    kb[:, :2] = np.maximum(kb[:, :2], rect[:2]) - rect[:2]
    kb[:, 2:] = np.minimum(kb[:, 2:], rect[2:]) - rect[:2]
    cw, ch = rect[2] - rect[0], rect[3] - rect[1]
    flip = rng.random() < 0.5
    if flip:
        kb = kb.copy()
        kb[:, 0::2] = cw - kb[:, 2::-2]
    scale = np.array([ch / size, cw / size], np.float32)
    offset = np.array([rect[1] - top, rect[0] - left], np.float32)
    return (scale, offset, flip, bright, contr,
            (kb / np.array([cw, ch, cw, ch], np.float32)).astype(np.float32), kl)


def warp(raw: torch.Tensor, scale, offset, flip, bright, contr, size: int, mean: float,
         dtype: torch.dtype = torch.float64):
    """raw [B, S, S, C] uint8 -> [B, size, size, C] in [0, 1], in ``dtype``
    (the affine scalars as drawn, in float32)."""
    dev, S = raw.device, raw.shape[1]
    scale = torch.as_tensor(scale, device=dev).to(dtype)
    offset = torch.as_tensor(offset, device=dev).to(dtype)
    flip = torch.as_tensor(flip, device=dev)
    dst = torch.arange(size, dtype=dtype, device=dev) + 0.5
    grid = torch.arange(S, dtype=dtype, device=dev)
    sy = dst[None] * scale[:, 0:1] + offset[:, 0:1] - 0.5
    my = torch.clamp(1.0 - (sy[:, :, None] - grid).abs(), min=0.0)
    dx = torch.where(flip[:, None], size - dst[None], dst[None])
    sx = dx * scale[:, 1:2] + offset[:, 1:2] - 0.5
    mx = torch.clamp(1.0 - (sx[:, :, None] - grid).abs(), min=0.0)
    x = (raw.to(dtype) + torch.as_tensor(bright, device=dev).to(dtype)[:, None, None, None]) \
        * torch.as_tensor(contr, device=dev).to(dtype)[:, None, None, None]
    x = torch.einsum("bos,bswc->bowc", my, x)
    x = torch.einsum("bot,bwtc->bwoc", mx, x)
    mass = my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]
    x = x + (1.0 - mass)[..., None] * mean - mean
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-6)


def make_batch(raw: torch.Tensor, bboxes: Sequence[np.ndarray], seed: int, j: int,
               batch: int, aug: Dict) -> Dict[str, torch.Tensor]:
    """Training batch j: raw [N, S, S, C] uint8 slices on the reference's
    device and per-slice boxes [n, 5] (x1, y1, x2, y2 in pixels, class) ->
    {"image", "boxes", "labels", "valid"} padded to ``aug["max_gt"]``."""
    boxes, labels = [], []
    for bb in bboxes:
        b = bb[:, :4].astype(np.float32)
        b[:, 0::2] /= raw.shape[2]
        b[:, 1::2] /= raw.shape[1]
        boxes.append(b)
        labels.append(bb[:, 4].astype(np.int32))
    idx = batch_indices(seed, len(boxes), j, batch)
    rng = np.random.default_rng((seed << 20) ^ j)
    S, G = raw.shape[1], aug["max_gt"]
    sc, of, fl, br, co = (np.zeros((batch, 2), np.float32), np.zeros((batch, 2), np.float32),
                          np.zeros(batch, bool), np.zeros(batch, np.float32),
                          np.ones(batch, np.float32))
    ob, ol, ov = (np.zeros((batch, G, 4), np.float32), np.zeros((batch, G), np.int32),
                  np.zeros((batch, G), bool))
    for b, i in enumerate(idx):
        sc[b], of[b], fl[b], br[b], co[b], kb, kl = _item(
            rng, boxes[i], labels[i], S, aug["size"], aug["pixel_jitter"], aug["expand_ratio"])
        n = min(len(kb), G)
        ob[b, :n], ol[b, :n], ov[b, :n] = kb[:n], kl[:n], True
    dev = raw.device
    image = warp(raw.index_select(0, torch.as_tensor(idx, device=dev)), sc, of, fl, br, co,
                 aug["size"], aug["mean"])
    return {"image": image, "boxes": torch.as_tensor(ob, device=dev),
            "labels": torch.as_tensor(ol, device=dev), "valid": torch.as_tensor(ov, device=dev)}
