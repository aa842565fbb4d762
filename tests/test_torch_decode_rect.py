"""The PixelLink decode's OpenCV steps against OpenCV, bit for bit: the
rotated rectangle and the bilinear upscaling of the score map.

``gssd_torch.eval.pixellink_decode`` reimplements ``cv2.convexHull``
(clockwise=False), ``cv2.minAreaRect`` and ``cv2.boxPoints`` without
OpenCV. Here cv2 is the oracle: every contour of seeded random masks
(outer borders and holes), seeded collinear point sets (1- and 2-point
hulls) and point clouds go through both, and the results must be equal,
with no tolerance. The decode's own route (the hull of each row's first
and last pixel, listed in the border's order) is held against
``minAreaRect(findContours(...)[0])`` on upscaled components.
``resize_linear`` is held against ``cv2.resize`` (INTER_LINEAR) as x86
OpenCV builds run it, through IPP. Skips where cv2 does not import.
"""

import numpy as np
import pytest

from gssd_torch.eval.pixellink_decode import (_hull, _row_extremes, box_points, convex_hull,
                                              min_area_rect, resize_linear)


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


def _mask_contours(cv2, rng, count, size=12, density=0.5):
    out = []
    while len(out) < count:
        m = (rng.random((size, size)) < density).astype(np.uint8)
        cs, _ = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
        out += list(cs)
    return out[:count]


def _collinear_sets(rng, count):
    out = []
    for _ in range(count):
        p0, d = rng.integers(-5, 15, 2), rng.integers(-4, 5, 2)
        t = rng.integers(0, 4, int(rng.integers(1, 6)))
        out.append((p0[None] + t[:, None] * d[None]).astype(np.int32).reshape(-1, 1, 2))
    return out


def _clouds(rng, count):
    return [rng.integers(0, 30, (int(rng.integers(1, 40)), 1, 2)).astype(np.int32)
            for _ in range(count)]


SOURCES = {"mask_contours": lambda cv2, rng: _mask_contours(cv2, rng, 2000),
           "collinear": lambda cv2, rng: _collinear_sets(rng, 400),
           "clouds": lambda cv2, rng: _clouds(rng, 400)}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_convex_hull_matches_opencv(cv2, source):
    rng = np.random.default_rng(21)
    for c in SOURCES[source](cv2, rng):
        want = cv2.convexHull(c, clockwise=False).reshape(-1, 2).astype(np.float32)
        np.testing.assert_array_equal(convex_hull(c.reshape(-1, 2)), want)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_min_area_rect_and_box_points_match_opencv(cv2, source):
    rng = np.random.default_rng(22)
    hull_sizes = set()
    for c in SOURCES[source](cv2, rng):
        pts = c.reshape(-1, 2)
        hull_sizes.add(min(len(convex_hull(pts)), 3))
        want = cv2.minAreaRect(c)
        got = min_area_rect(pts)
        assert got == (tuple(want[0]), tuple(want[1]), want[2]), (pts.tolist(), want, got)
        np.testing.assert_array_equal(box_points(*got), cv2.boxPoints(want))
    if source == "collinear":
        assert hull_sizes == {1, 2}
    else:
        assert 3 in hull_sizes


@pytest.mark.parametrize("grid", [24, 48])
def test_decode_route_matches_opencv_on_upscaled_components(cv2, grid):
    """The decode never traces a contour: it takes the hull of each row's
    first and last pixel in the border's order. Upscaled 4x (the 4s
    model) or 2x (2s), that gives OpenCV's rectangle for every
    component."""
    rng = np.random.default_rng(23)
    n = 0
    for _ in range(60 if grid == 24 else 15):
        lab = (rng.random((grid, grid)) < 0.45).astype(np.uint8)
        up = cv2.resize(lab, (96, 96), interpolation=cv2.INTER_NEAREST)
        count, comps = cv2.connectedComponents(up, connectivity=8)
        for i in range(1, count):
            m = (comps == i).astype(np.uint8)
            contour = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)[0][0]
            want = cv2.minAreaRect(contour)
            ys, xs = np.nonzero(m)
            got = min_area_rect(_hull(_row_extremes(ys, xs)))
            assert got == (tuple(want[0]), tuple(want[1]), want[2])
            n += 1
    assert n > 300


@pytest.mark.parametrize("src,size", [(75, 300), (150, 300), (24, 96), (7, 30)])
def test_resize_linear_matches_opencv(cv2, src, size):
    if not cv2.ipp.useIPP():
        pytest.skip("this OpenCV build runs resize without IPP")
    rng = np.random.default_rng(24)
    for a in (rng.random((src, src)),
              1 / (1 + np.exp(-rng.normal(0, 30, (src, src))))):  # probabilities near 0 and 1
        a = a.astype(np.float32)
        want = cv2.resize(a, (size, size), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_linear(a, size), want)
