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
   half-pixel centres, edge rows repeated, rounded as the IPP path of
   x86 OpenCV builds rounds it);
4. per component: the minimum-area rectangle of its outer contour
   (``cv2.minAreaRect(cv2.findContours(..., RETR_CCOMP)[0][0])``), the
   side and area filters, its corner points (``cv2.boxPoints``) truncated
   to integers and clipped to the image, their axis-aligned extent, and
   the mean upscaled score over the component.

Step 4 without OpenCV: an upscaled component is one 8-connected piece
(nearest-neighbour upscaling keeps diagonal contacts), so the first
contour OpenCV returns for it is its outer border, whose convex hull is
the hull of the component's pixels: the hull of each row's first and
last pixel. ``_hull`` lists those vertices in the order the border
visits them; ``min_area_rect`` is OpenCV 5.0's ``minAreaRect`` bit for
bit (its ``convexHull``, the rotating calipers in f32 and the double
epilogue), so for every component whose border visits each hull vertex
once, as it does at any upscaling factor of 2 or more, the rectangle
is OpenCV's (``tests/test_torch_decode_rect.py`` holds it against cv2
on random contours).

The union-find and step 4 run in the port's C++ host library
(``gssd_torch/native/pixellink_cc.cpp``, built with g++ at first use),
the counterpart of the C++ of the JAX package's native library and of
OpenCV. It gives the numpy functions' bits: the same labels, boxes,
scores and order of components. The numpy functions are the plain
versions, run with ``impl="numpy"``; ``impl="native"`` (the default)
raises where the library cannot be built. The two resizes stay numpy.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import numpy as np

from gssd_torch.config import PixelLinkConfig
from gssd_torch.native.build import NATIVE, check_impl, ptr

# decoder neighbour offsets (dy, dx) for j = 0..7: the incoming-link
# convention of the training targets' NEIGHBOR_SHIFTS
DECODE_NEIGHBORS = [
    (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)
]

_F = np.float32


def link_components(pixel: np.ndarray, link: np.ndarray, impl: str = "native") -> np.ndarray:
    """Union-find labelling; pixel [H, W] uint8, link [8, H, W] uint8 ->
    labels [H, W] int32 (0 background, components numbered 1.. in raster
    order of their first pixel)."""
    check_impl(impl)
    if impl == "native":
        pixel = np.ascontiguousarray(pixel, np.uint8)
        link = np.ascontiguousarray(link, np.uint8)
        h, w = pixel.shape
        labels = np.empty((h, w), np.int32)
        NATIVE["pixellink_components"](ptr(pixel, ctypes.c_uint8), ptr(link, ctypes.c_uint8),
                                       h, w, ptr(labels, ctypes.c_int32))
        return labels
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
    """INTER_LINEAR source taps for one axis: (i0, i1, frac), the
    fraction taken in double and rounded once to f32."""
    f = (np.arange(size) + 0.5) * (n / size) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    low = i0 < 0
    f[low], i0[low] = 0, 0
    high = i0 >= n - 1
    f[high], i0[high] = 0, n - 1
    return i0, np.minimum(i0 + 1, n - 1), f.astype(_F)


def _fma_f32(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """x * y + z of f32 arrays with one rounding to f32, as a fused
    multiply-add: the product is exact in f64, the sum's f64 rounding
    error is recovered (two-sum) and decides the f32 rounding where the
    f64 sum falls on a tie between two f32 values."""
    p = x.astype(np.float64) * y.astype(np.float64)
    zd = z.astype(np.float64)
    s = p + zd
    bp = s - zd
    err = (p - bp) + (zd - (s - bp))
    r = s.astype(_F)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(_F))
    tie = (s != r) & ((r.astype(np.float64) + other.astype(np.float64)) * 0.5 == s) & (err != 0)
    toward = (other > r) == (err > 0)
    return np.where(tie & toward, other, r)


def resize_linear(a: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(a, (size, size), interpolation=INTER_LINEAR)`` of an
    f32 map as x86 OpenCV builds compute it (through IPP): rows first,
    then columns, each pass ``s0 + (s1 - s0) * frac`` as one f32
    fused multiply-add."""
    a = np.asarray(a, _F)
    h, w = a.shape
    x0, x1, fx = _linear_taps(w, size)
    y0, y1, fy = _linear_taps(h, size)

    def lerp(s0, s1, f):
        return _fma_f32(s1 - s0, np.broadcast_to(f, s0.shape), s0)

    rows = lerp(a[:, x0], a[:, x1], fx[None, :])
    return lerp(rows[y0], rows[y1], fy[:, None])


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull [k, 2] f32 of integer points [n, 2] (x, y) without
    collinear vertices, in the order in which the outer contour of
    their component visits them: from the first point in raster order
    (least y, then least x), down the left side first on the image,
    as ``cv2.findContours`` traces an outer border."""
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


def _sign(v) -> int:
    return (v > 0) - (v < 0)


def _sklansky(p, start: int, end: int, stack: List[int], nsign: int, sign2: int) -> int:
    """OpenCV's ``Sklansky_``: one quarter of the hull of the sorted
    points ``p`` from index ``start`` to ``end``, into ``stack``;
    returns the number of hull points."""
    incr = 1 if end > start else -1
    pprev, pcur = start, start + incr
    pnext = pcur + incr
    if start == end or p[start] == p[end]:
        stack[0] = start
        return 1
    stack[0:3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        by = p[pnext][1] - p[pcur][1]
        if _sign(by) != nsign:
            ax = p[pcur][0] - p[pprev][0]
            bx = p[pnext][0] - p[pcur][0]
            ay = p[pcur][1] - p[pprev][1]
            if _sign(ay * bx - ax * by) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return size - 1


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points, clockwise=False)`` of integer points
    [n, 2] (x, y): OpenCV's Sklansky scan over the points sorted by (x,
    y, input index), then its cyclic shift that makes the hull's input
    indices ascend or descend where they can. The order of the input
    points decides where the hull starts."""
    data = [tuple(q) for q in np.asarray(points).reshape(-1, 2).tolist()]
    total = len(data)
    ptr = sorted(range(total), key=lambda i: (data[i][0], data[i][1], i))
    p = [data[i] for i in ptr]
    miny = maxy = 0
    for i in range(1, total):
        if p[miny][1] > p[i][1]:
            miny = i
        if p[maxy][1] < p[i][1]:
            maxy = i
    if p[0] == p[-1]:
        return np.asarray([data[0]], _F)
    # upper half (clockwise=False takes the right-hand scan first)
    tl, tr = [0] * (total + 2), [0] * (total + 2)
    ntl = _sklansky(p, 0, maxy, tl, -1, 1)
    ntr = _sklansky(p, total - 1, maxy, tr, -1, -1)
    tl, tr, ntl, ntr = tr, tl, ntr, ntl
    idx = [ptr[tl[i]] for i in range(ntl - 1)] + [ptr[tr[i]] for i in range(ntr - 1, 0, -1)]
    stop = tr[1] if ntr > 2 else (tl[ntl - 2] if ntl > 2 else -1)
    # lower half
    bl, br = [0] * (total + 2), [0] * (total + 2)
    nbl = _sklansky(p, 0, miny, bl, 1, -1)
    nbr = _sklansky(p, total - 1, miny, br, 1, 1)
    if stop >= 0:
        check = bl[1] if nbl > 2 else (br[2] if nbl + nbr > 3 else -1)
        if check == stop or (check >= 0 and p[check] == p[stop]):
            # all points on one line: the lower half mirrors the upper
            nbl, nbr = min(nbl, 2), min(nbr, 2)
    idx += [ptr[bl[i]] for i in range(nbl - 1)] + [ptr[br[i]] for i in range(nbr - 1, 0, -1)]
    n = len(idx)
    if n >= 3:
        lo = hi = lt = 0
        for i in range(1, n):
            lt += idx[i - 1] < idx[i]
            if 1 < lt <= i - 2:
                break
            if idx[i] < idx[lo]:
                lo = i
            if idx[i] > idx[hi]:
                hi = i
        if abs(hi - lo) in (1, n - 1) and (lt <= 1 or lt >= n - 2):
            ascending = (hi + 1) % n == lo
            i0 = lo if ascending else hi
            shifted = idx[i0:] + idx[:i0]
            if i0 > 0 and all((a < b) == ascending for a, b in zip(shifted, shifted[1:])):
                idx = shifted
    return np.asarray([data[i] for i in idx], _F).reshape(-1, 2)


def _normalized(size: Tuple[float, float], degrees: float):
    """OpenCV 5's rectangle convention: the angle in [-90, 0), turned by
    steps of 90 degrees in double, each step swapping width and height."""
    w, h = size
    while degrees >= 0:
        degrees, w, h = degrees - 90, h, w
    while degrees < -90:
        degrees, w, h = degrees + 90, h, w
    return (float(w), float(h)), float(_F(degrees))


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``cv2.minAreaRect`` (OpenCV 5.0) of integer points [n, 2] (x,
    y), bit for bit: ((cx, cy), (w, h), angle in degrees). The hull is
    ``convex_hull``'s; the rotating calipers run in f32 as OpenCV's do,
    choosing the next edge by the sign of a cross product; centre, size
    and the angle's double epilogue are OpenCV's."""
    hull = convex_hull(points)
    n = len(hull)
    if n == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), *_normalized((0.0, 0.0), 0.0)
    if n == 2:
        cx = float((hull[0, 0] + hull[1, 0]) * _F(0.5))
        cy = float((hull[0, 1] + hull[1, 1]) * _F(0.5))
        dx = float(hull[1, 0]) - float(hull[0, 0])
        dy = float(hull[1, 1]) - float(hull[0, 1])
        size = (float(_F(math.sqrt(dx * dx + dy * dy))), 0.0)
        return (cx, cy), *_normalized(size, math.atan2(dy, dx) * 180 / math.pi)
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
        dx, dy = float(qx - px), float(qy - py)
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
        # each caliper's edge turned into the frame of the first one;
        # the edge that is furthest clockwise leads
        rot = (vect[seq[0]],
               (vect[seq[1]][1], -vect[seq[1]][0]),
               (-vect[seq[2]][0], -vect[seq[2]][1]),
               (-vect[seq[3]][1], vect[seq[3]][0]))
        main = 0
        for i in range(1, 4):
            if rot[i][1] * rot[main][0] - rot[i][0] * rot[main][1] < 0:
                main = i
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
    degrees = math.atan2(float(o1[1]), float(o1[0])) * 180 / math.pi
    return (float(cx), float(cy)), *_normalized((float(w), float(h)), degrees)


def box_points(center, size, angle) -> np.ndarray:
    """``cv2.boxPoints`` (OpenCV 5.0): the 4 corners [4, 2] f32 of a
    rotated rect, each one centre +- the two half sides in f32."""
    cx, cy = _F(center[0]), _F(center[1])
    w, h = _F(size[0]), _F(size[1])
    rad = float(_F(angle)) * math.pi / 180.0
    b = _F(math.cos(rad)) * _F(0.5)
    a = _F(math.sin(rad)) * _F(0.5)
    return np.asarray([(cx - a * h - b * w, cy + b * h - a * w),
                       (cx + a * h - b * w, cy - b * h - a * w),
                       (cx + a * h + b * w, cy - b * h + a * w),
                       (cx - a * h + b * w, cy + b * h + a * w)], _F)


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


def _component_boxes_native(labels_up: np.ndarray, score_up: np.ndarray, img_size: int,
                            cfg: PixelLinkConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The per-component loop of ``mask_to_boxes`` in C++ -> (scores [n],
    boxes [n, 4])."""
    labels_up = np.ascontiguousarray(labels_up, np.int32)
    score_up = np.ascontiguousarray(score_up, _F)
    n_labels = int(labels_up.max(initial=0))
    boxes = np.empty((n_labels, 4))
    scores = np.empty(n_labels)
    k = NATIVE["pixellink_boxes"](ptr(labels_up, ctypes.c_int32), ptr(score_up, ctypes.c_float),
                                  img_size, n_labels, float(cfg.min_height),
                                  float(cfg.min_area), ptr(boxes, ctypes.c_double),
                                  ptr(scores, ctypes.c_double))
    if k == 0:
        return np.zeros((0,)), np.zeros((0, 4))
    return scores[:k].copy(), boxes[:k].copy()


def mask_to_boxes(
    pixel_logits: np.ndarray,
    link_logits: np.ndarray,
    img_size: int = 300,
    cfg: PixelLinkConfig = PixelLinkConfig(),
    pixel_thres: Optional[float] = None,
    impl: str = "native",
) -> Tuple[np.ndarray, np.ndarray]:
    """One image: pixel_logits [H, W, 2], link_logits [H, W, 16] ->
    (scores [n], boxes [n, 4] pixel coordinates in img_size space);
    ``impl`` "native" (C++) or "numpy" (the plain version), the same
    bits."""
    check_impl(impl)
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

    labels = link_components(pixel_mask, link, impl)
    labels_up = resize_nearest(labels, img_size)
    score_up = resize_linear(score_map, img_size)
    if impl == "native":
        return _component_boxes_native(labels_up, score_up, img_size, cfg)

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
