"""PixelLink decode: logit maps -> boxes, host-side numpy without OpenCV
(the port of ``gssd_tpu/eval/pixellink_decode.py``).

1. pixel foreground softmax > ``pixel_conf_threshold``; per-neighbour
   link foreground softmax > ``link_conf_threshold``, gated by the pixel
   mask;
2. union-find over the positive pixels (``link_components``, the JAX
   package's ``_components_numpy``): p joins neighbour j when link_j(p)
   is on and the neighbour is positive;
3. the label map is upscaled to the image size by nearest neighbour and
   the score map bilinearly, with OpenCV's conventions (``cv2.resize``
   INTER_NEAREST: source index floor(d * src / dst); INTER_LINEAR:
   half-pixel centres, edge rows repeated);
4. per component: the minimum-area rectangle of its outer contour
   (``cv2.minAreaRect(cv2.findContours(..., RETR_CCOMP)[0][0])``), the
   side and area filters, its corner points (``cv2.boxPoints``) truncated
   to integers and clipped to the image, their axis-aligned extent, and
   the mean upscaled score over the component.

Step 4 without OpenCV: an upscaled component is one 8-connected piece
(nearest-neighbour upscaling keeps diagonal contacts), so the first
contour OpenCV returns for it is its outer border, whose convex hull is
the hull of the component's pixels: the hull of each row's first and
last pixel. ``min_area_rect`` is OpenCV's rotating calipers over that
hull, in f32, with OpenCV's order of hull vertices (clockwise in y-up
coordinates from the component's first pixel in raster order) and its
rule for equal areas (the last one found wins). Its f32 rounding is not
OpenCV's bit for bit: the centre can differ in the last bits and, among
rectangles of equal area, another one can be chosen, so a truncated
corner, and with it a box edge, can move by a pixel (ROADMAP.md, Queue
C; ``tests/test_torch_pixellink.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from gssd_torch.config import PixelLinkConfig

# decoder neighbour offsets (dy, dx) for j = 0..7: the incoming-link
# convention of the training targets' NEIGHBOR_SHIFTS
DECODE_NEIGHBORS = [
    (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)
]

_F = np.float32


def link_components(pixel: np.ndarray, link: np.ndarray) -> np.ndarray:
    """Union-find labelling; pixel [H, W] uint8, link [8, H, W] uint8 ->
    labels [H, W] int32 (0 background, components numbered 1.. in raster
    order of their first pixel)."""
    h, w = pixel.shape
    parent = np.arange(h * w, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    ys, xs = np.nonzero(pixel)
    for y, x in zip(ys, xs):
        p = y * w + x
        for j, (dy, dx) in enumerate(DECODE_NEIGHBORS):
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and pixel[ny, nx] and link[j, y, x]:
                ra, rb = find(p), find(ny * w + nx)
                if ra != rb:
                    parent[rb] = ra
    labels = np.zeros((h, w), np.int32)
    id_of = {}
    for y, x in zip(ys, xs):
        root = find(y * w + x)
        if root not in id_of:
            id_of[root] = len(id_of) + 1
        labels[y, x] = id_of[root]
    return labels


def resize_nearest(a: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(a, (size, size), interpolation=INTER_NEAREST)``."""
    h, w = a.shape
    ys = np.minimum(np.floor(np.arange(size) * (1.0 / (size / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(size) * (1.0 / (size / w))).astype(np.int64), w - 1)
    return a[ys[:, None], xs[None, :]]


def _linear_taps(n: int, size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR source taps for one axis: (i0, i1, frac f32)."""
    scale = 1.0 / (size / n)
    f = ((np.arange(size) + 0.5) * scale - 0.5).astype(_F)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(_F)).astype(_F)
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= n - 1
    f[high], i0[high] = 0, n - 1
    return i0, np.minimum(i0 + 1, n - 1), f


def resize_linear(a: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(a, (size, size), interpolation=INTER_LINEAR)`` of an
    f32 map: rows first, then columns, in f32."""
    a = np.asarray(a, _F)
    h, w = a.shape
    x0, x1, fx = _linear_taps(w, size)
    y0, y1, fy = _linear_taps(h, size)
    rows = a[:, x0] * (_F(1) - fx) + a[:, x1] * fx
    return (rows[y0] * (_F(1) - fy)[:, None] + rows[y1] * fy[:, None]).astype(_F)


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull [k, 2] f32 of integer points [n, 2] (x, y) without
    collinear vertices, in OpenCV's minAreaRect order: from the first
    point in raster order (least y, then least x), clockwise in y-up
    coordinates (down the left side first, on the image)."""
    p = sorted(set(map(tuple, pts.tolist())))
    if len(p) <= 2:
        return np.asarray(p, _F).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    ring = lower[:-1] + upper[:-1]  # counter-clockwise in y-up coordinates
    ring = ring[::-1]
    start = min(range(len(ring)), key=lambda i: (ring[i][1], ring[i][0]))
    return np.asarray(ring[start:] + ring[:start], _F)


def min_area_rect(hull: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``cv2.minAreaRect`` of a hull from ``_hull``: ((cx, cy), (w, h),
    angle in degrees), by OpenCV's rotating calipers in f32."""
    n = len(hull)
    if n == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0
    if n == 2:
        cx = float((hull[0, 0] + hull[1, 0]) * _F(0.5))
        cy = float((hull[0, 1] + hull[1, 1]) * _F(0.5))
        dx = float(hull[1, 0]) - float(hull[0, 0])
        dy = float(hull[1, 1]) - float(hull[0, 1])
        ang = float(_F(math.atan2(dy, dx)))
        return (cx, cy), (float(_F(math.sqrt(dx * dx + dy * dy))), 0.0), \
            float(_F(ang * 180 / math.pi))
    pts = [(_F(x), _F(y)) for x, y in hull]
    vect, inv_len = [], []
    left = bottom = right = top = 0
    left_x = right_x = pts[0][0]
    top_y = bottom_y = pts[0][1]
    for i in range(n):
        px, py = pts[i]
        if px < left_x:
            left_x, left = px, i
        if px > right_x:
            right_x, right = px, i
        if py > top_y:
            top_y, top = py, i
        if py < bottom_y:
            bottom_y, bottom = py, i
        qx, qy = pts[(i + 1) % n]
        dx, dy = float(qx) - float(px), float(qy) - float(py)
        vect.append((_F(dx), _F(dy)))
        inv_len.append(_F(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = _F(0)
    ax, ay = float(vect[n - 1][0]), float(vect[n - 1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        conv = ax * by - ay * bx
        if conv != 0:
            orientation = _F(1) if conv > 0 else _F(-1)
            break
        ax, ay = bx, by
    base_a, base_b = orientation, _F(0)
    seq = [bottom, right, top, left]
    minarea = _F(np.finfo(_F).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
              -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
              -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
              base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1])
        maxcos = dp[0] * inv_len[seq[0]]
        main = 0
        for i in range(1, 4):
            c = dp[i] * inv_len[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        pi = seq[main]
        lead_x = vect[pi][0] * inv_len[pi]
        lead_y = vect[pi][1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = pts[seq[1]][0] - pts[seq[3]][0]
        dy = pts[seq[1]][1] - pts[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx = pts[seq[2]][0] - pts[seq[0]][0]
        dy = pts[seq[2]][1] - pts[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[i_left][0] + pts[i_left][1] * b1
    c2 = a2 * pts[i_bottom][0] + pts[i_bottom][1] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    o1 = (a1 * width, b1 * width)
    o2 = (a2 * height, b2 * height)
    cx = px + (o1[0] + o2[0]) * _F(0.5)
    cy = py + (o1[1] + o2[1]) * _F(0.5)
    w = _F(math.sqrt(float(o1[0]) ** 2 + float(o1[1]) ** 2))
    h = _F(math.sqrt(float(o2[0]) ** 2 + float(o2[1]) ** 2))
    ang = _F(math.atan2(float(o1[1]), float(o1[0])))
    return (float(cx), float(cy)), (float(w), float(h)), float(_F(float(ang) * 180 / math.pi))


def box_points(center, size, angle) -> np.ndarray:
    """``cv2.boxPoints``: the 4 corners [4, 2] f32 of a rotated rect."""
    cx, cy = _F(center[0]), _F(center[1])
    w, h = _F(size[0]), _F(size[1])
    rad = angle * math.pi / 180.0
    b = _F(math.cos(rad)) * _F(0.5)
    a = _F(math.sin(rad)) * _F(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (_F(2) * cx - p0[0], _F(2) * cy - p0[1])
    p3 = (_F(2) * cx - p1[0], _F(2) * cy - p1[1])
    return np.asarray([p0, p1, p2, p3], _F)


def _components_of(labels_up: np.ndarray):
    """Yield (label, ys, xs) of every component of an upscaled label
    map, pixels in raster order."""
    ys, xs = np.nonzero(labels_up)
    lab = labels_up[ys, xs]
    order = np.argsort(lab, kind="stable")
    ys, xs, lab = ys[order], xs[order], lab[order]
    cuts = np.flatnonzero(np.diff(lab)) + 1
    for cy, cx, cl in zip(np.split(ys, cuts), np.split(xs, cuts), np.split(lab, cuts)):
        if len(cl):
            yield int(cl[0]), cy, cx


def _row_extremes(ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """The first and last pixel of every row of a component (raster
    order) as [k, 2] (x, y) points."""
    starts = np.flatnonzero(np.r_[True, np.diff(ys) != 0])
    ends = np.r_[starts[1:], len(ys)] - 1
    first = np.stack([xs[starts], ys[starts]], 1)
    last = np.stack([xs[ends], ys[ends]], 1)
    return np.concatenate([first, last])


def mask_to_boxes(
    pixel_logits: np.ndarray,
    link_logits: np.ndarray,
    img_size: int = 300,
    cfg: PixelLinkConfig = PixelLinkConfig(),
    pixel_thres: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One image: pixel_logits [H, W, 2], link_logits [H, W, 16] ->
    (scores [n], boxes [n, 4] pixel coordinates in img_size space)."""
    p = pixel_logits - pixel_logits.max(-1, keepdims=True)
    e = np.exp(p)
    prob = e / e.sum(-1, keepdims=True)
    score_map = prob[..., 1]
    thresh = cfg.pixel_conf_threshold if pixel_thres is None else pixel_thres
    pixel_mask = (score_map > thresh).astype(np.uint8)

    H, W = pixel_mask.shape
    link = np.zeros((8, H, W), np.uint8)
    for j in range(8):
        pair = link_logits[..., 2 * j:2 * j + 2]
        pair = pair - pair.max(-1, keepdims=True)
        ep = np.exp(pair)
        fg = ep[..., 1] / ep.sum(-1)
        link[j] = ((fg > cfg.link_conf_threshold) & (pixel_mask == 1))

    labels = link_components(pixel_mask, link)
    labels_up = resize_nearest(labels, img_size)
    score_up = resize_linear(score_map, img_size)

    boxes: List[List[float]] = []
    scores: List[float] = []
    for _, ys, xs in _components_of(labels_up):
        (cx, cy), (w, h), theta = min_area_rect(_hull(_row_extremes(ys, xs)))
        if min(w, h) < cfg.min_height:
            continue
        if w * h < cfg.min_area:
            continue
        pts = box_points((cx, cy), (w, h), theta).astype(np.int64)
        pts[:, 0] = np.clip(pts[:, 0], 0, img_size - 1)
        pts[:, 1] = np.clip(pts[:, 1], 0, img_size - 1)
        boxes.append([float(pts[:, 0].min()), float(pts[:, 1].min()),
                      float(pts[:, 0].max()), float(pts[:, 1].max())])
        scores.append(float(score_up[ys, xs].mean()))
    if not boxes:
        return np.zeros((0,)), np.zeros((0, 4))
    return np.asarray(scores), np.asarray(boxes)
