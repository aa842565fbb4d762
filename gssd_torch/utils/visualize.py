"""The ``--visualize`` dumps: the port of ``gssd_tpu/utils/visualize.py``.

- ``dump_eval_visuals`` writes, for one evaluation image, its input, its
  ground truth, the first DCN layer's offsets and the first map of each
  attention list as ``.npy`` arrays, plus a detection overlay and an
  offset overlay as JPEGs;
- ``offsets_to_image_coords`` and ``draw_offsets`` map each output
  pixel's 9 sampling positions (grid plus learned offset) back to image
  pixels and draw them over the portal phase;
- ``input_grid_with_boxes`` draws a training batch's portal slices with
  their boxes, the panel the trainer logs every 100 iterations
  (``MetricsLogger.log_image``).

Drawing and JPEG writing are OpenCV's, as in the JAX package. ``cv2`` is
imported inside the functions that draw, so that importing the port
loads no OpenCV.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _to_canvas(image: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 3] float 0..1 -> contiguous [H, W, 3] uint8."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.ascontiguousarray((img * 255).clip(0, 255).astype(np.uint8))


def draw_boxes(image: np.ndarray, boxes: np.ndarray, color=(0, 255, 0),
               scores: Optional[np.ndarray] = None) -> np.ndarray:
    """image: [H, W] or [H, W, 3] float 0..1; boxes [n, 4] pixel
    coordinates -> [H, W, 3] uint8 with the boxes (and scores) drawn."""
    import cv2

    img = _to_canvas(image)
    for i, b in enumerate(np.asarray(boxes).astype(int)):
        cv2.rectangle(img, (b[0], b[1]), (b[2], b[3]), color, 2)
        if scores is not None:
            cv2.putText(img, f"{scores[i]:.2f}", (b[0], max(b[1] - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    return img


def offsets_to_image_coords(offsets: np.ndarray, image_size: int,
                            stride: Optional[float] = None, padding: int = 1,
                            dilation: int = 1) -> np.ndarray:
    """DCN offsets [Ho, Wo, G, K, 2] (dy, dx) -> absolute sampling
    positions in image pixels [Ho, Wo, G, K, 2] (y, x)."""
    Ho, Wo, G, K, _ = offsets.shape
    kw = int(round(K ** 0.5))
    stride = stride if stride is not None else image_size / Ho
    u = np.arange(K) // kw
    v = np.arange(K) % kw
    base_y = (np.arange(Ho)[:, None, None, None] - padding + u[None, None, None, :] * dilation)
    base_x = (np.arange(Wo)[None, :, None, None] - padding + v[None, None, None, :] * dilation)
    py = (base_y + offsets[..., 0]) * stride + stride / 2
    px = (base_x + offsets[..., 1]) * stride + stride / 2
    return np.stack([py, px], axis=-1)


def draw_offsets(image: np.ndarray, offsets: np.ndarray, image_size: int, group: int = 0,
                 step: int = 4, color=(0, 0, 255)) -> np.ndarray:
    """The sampling positions of every ``step``-th output pixel of one
    deformable group, dotted over the image."""
    import cv2

    pos = offsets_to_image_coords(offsets, image_size)
    img = _to_canvas(image)
    Ho, Wo = offsets.shape[:2]
    for i in range(0, Ho, step):
        for j in range(0, Wo, step):
            for k in range(offsets.shape[3]):
                y, x = pos[i, j, group, k]
                if 0 <= y < image_size and 0 <= x < image_size:
                    cv2.circle(img, (int(x), int(y)), 1, color, -1)
    return img


def dump_eval_visuals(out_dir: str, index: int, image: np.ndarray, gt_boxes: np.ndarray,
                      detections: np.ndarray, offsets: Optional[List[np.ndarray]] = None,
                      attn: Optional[List[np.ndarray]] = None,
                      attn_base: Optional[List[np.ndarray]] = None,
                      conf_threshold: float = 0.2, image_size: int = 300) -> None:
    """Write the ``--visualize`` files of one evaluation image into
    ``out_dir``: ``<index:05d>_x.npy`` (the [H, W, 12] network input),
    ``_annotation.npy`` (gt boxes in input pixels), ``_offsets.npy``,
    ``_attention.npy`` and ``_attention_base.npy`` (the first map of each
    list given), ``_detection.jpg`` (gt green, detections above
    ``conf_threshold`` red with their scores, over the portal phase's
    centre slice, channel 7) and, with offsets, ``_offsets.jpg``.
    detections: [C, K, 5] Detect output, normalised coordinates."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    pre = os.path.join(out_dir, f"{index:05d}")
    np.save(pre + "_x.npy", image)
    np.save(pre + "_annotation.npy", gt_boxes)
    for name, maps in (("offsets", offsets), ("attention", attn), ("attention_base", attn_base)):
        if maps:
            np.save(f"{pre}_{name}.npy", np.asarray(maps[0]))

    portal = image[:, :, 7]
    rows = detections[1]
    keep = rows[:, 0] > conf_threshold
    det_boxes = rows[keep][:, 1:] * image_size
    canvas = draw_boxes(portal, gt_boxes[:, :4], color=(0, 255, 0))
    canvas = draw_boxes(canvas.astype(np.float32) / 255, det_boxes, color=(0, 0, 255),
                        scores=rows[keep][:, 0])
    cv2.imwrite(pre + "_detection.jpg", canvas)
    if offsets:
        cv2.imwrite(pre + "_offsets.jpg", draw_offsets(portal, np.asarray(offsets[0]),
                                                       image_size))


def dump_names(index: int, offsets: bool, attn: bool, attn_base: bool) -> List[str]:
    """The file names ``dump_eval_visuals`` writes for image ``index``
    with those aux lists non-empty."""
    pre = f"{index:05d}"
    names = [f"{pre}_x.npy", f"{pre}_annotation.npy", f"{pre}_detection.jpg"]
    if offsets:
        names += [f"{pre}_offsets.npy", f"{pre}_offsets.jpg"]
    if attn:
        names.append(f"{pre}_attention.npy")
    if attn_base:
        names.append(f"{pre}_attention_base.npy")
    return names


def input_grid_with_boxes(images: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
                          max_n: int = 4) -> np.ndarray:
    """A [B, H, W, 12] batch -> [H, W * n, 3] f32 panel in [0, 1] of the
    first n <= max_n portal slices (channel 7) with their valid boxes
    ([B, G, 4] normalised) drawn."""
    n = min(max_n, images.shape[0])
    H, W = images.shape[1:3]
    panel = np.zeros((H, W * n, 3), np.float32)
    for i in range(n):
        b = boxes[i][valid[i]] * [W, H, W, H]
        panel[:, i * W:(i + 1) * W] = draw_boxes(images[i, :, :, 7], b).astype(np.float32) / 255
    return panel
