// PixelLink decode on the host: the union-find that groups positive
// pixels into components, and each component's geometry (the hull of
// its pixels, OpenCV 5.0's minimum-area rectangle and box points, the
// side and area filters, the mean score).
//
// The plain versions are the numpy functions of
// gssd_torch/eval/pixellink_decode.py; every function here gives their
// bits. Each operation keeps its numpy type: `float` where numpy works
// in float32, `double` where it works in float64 or on Python floats.
// Built with -ffp-contract=off, so that no product is fused into a sum.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// decoder neighbour offsets (dy, dx), j = 0..7 (DECODE_NEIGHBORS)
const int DY[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
const int DX[8] = {-1, 0, 1, 1, 1, 0, -1, -1};

struct DSU {
  std::vector<int32_t> parent;
  std::vector<int8_t> rank_;
  explicit DSU(size_t n) : parent(n), rank_(n, 0) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t a) {
    int32_t root = a;
    while (parent[root] != root) root = parent[root];
    while (parent[a] != root) {
      int32_t next = parent[a];
      parent[a] = root;
      a = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) ++rank_[a];
  }
};

struct Pt {
  double x, y;
  bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
};

int sign(double v) { return (v > 0) - (v < 0); }

// _hull: the convex hull of integer points without collinear vertices
// (Andrew's monotone chain), in the order the outer contour visits it:
// from the least (y, x), down the left side first on the image.
std::vector<Pt> border_hull(std::vector<Pt> p) {
  std::sort(p.begin(), p.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  p.erase(std::unique(p.begin(), p.end()), p.end());
  if (p.size() <= 2) return p;
  auto cross = [](const Pt& o, const Pt& a, const Pt& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
  };
  std::vector<Pt> lower, upper;
  for (const Pt& q : p) {
    while (lower.size() >= 2 && cross(lower[lower.size() - 2], lower.back(), q) <= 0)
      lower.pop_back();
    lower.push_back(q);
  }
  for (auto it = p.rbegin(); it != p.rend(); ++it) {
    while (upper.size() >= 2 && cross(upper[upper.size() - 2], upper.back(), *it) <= 0)
      upper.pop_back();
    upper.push_back(*it);
  }
  std::vector<Pt> ring(lower.begin(), lower.end() - 1);
  ring.insert(ring.end(), upper.begin(), upper.end() - 1);
  std::reverse(ring.begin(), ring.end());
  size_t start = 0;
  for (size_t i = 1; i < ring.size(); ++i) {
    if (ring[i].y < ring[start].y || (ring[i].y == ring[start].y && ring[i].x < ring[start].x))
      start = i;
  }
  std::rotate(ring.begin(), ring.begin() + start, ring.end());
  return ring;
}

// OpenCV's Sklansky_ (_sklansky): one quarter of the hull of the sorted
// points p from start to end into stack; returns its point count.
int sklansky(const std::vector<Pt>& p, int start, int end, std::vector<int>& stack, int nsign,
             int sign2) {
  const int incr = end > start ? 1 : -1;
  int pprev = start, pcur = start + incr, pnext = pcur + incr;
  if (start == end || p[start] == p[end]) {
    stack[0] = start;
    return 1;
  }
  stack[0] = pprev;
  stack[1] = pcur;
  stack[2] = pnext;
  int size = 3;
  end += incr;
  while (pnext != end) {
    const double by = p[pnext].y - p[pcur].y;
    if (sign(by) != nsign) {
      const double ax = p[pcur].x - p[pprev].x;
      const double bx = p[pnext].x - p[pcur].x;
      const double ay = p[pcur].y - p[pprev].y;
      if (sign(ay * bx - ax * by) == sign2 && (ax != 0 || ay != 0)) {
        pprev = pcur;
        pcur = pnext;
        pnext += incr;
        stack[size++] = pnext;
      } else if (pprev == start) {
        pcur = pnext;
        stack[1] = pcur;
        pnext += incr;
        stack[2] = pnext;
      } else {
        stack[size - 2] = pnext;
        pcur = pprev;
        pprev = stack[size - 4];
        --size;
      }
    } else {
      pnext += incr;
      stack[size - 1] = pnext;
    }
  }
  return size - 1;
}

// convex_hull: cv2.convexHull(points, clockwise=False)
std::vector<Pt> convex_hull(const std::vector<Pt>& data) {
  const int total = static_cast<int>(data.size());
  std::vector<int> ptr(total);
  for (int i = 0; i < total; ++i) ptr[i] = i;
  std::sort(ptr.begin(), ptr.end(), [&](int a, int b) {
    if (data[a].x != data[b].x) return data[a].x < data[b].x;
    if (data[a].y != data[b].y) return data[a].y < data[b].y;
    return a < b;
  });
  std::vector<Pt> p(total);
  for (int i = 0; i < total; ++i) p[i] = data[ptr[i]];
  int miny = 0, maxy = 0;
  for (int i = 1; i < total; ++i) {
    if (p[miny].y > p[i].y) miny = i;
    if (p[maxy].y < p[i].y) maxy = i;
  }
  if (p[0] == p[total - 1]) return {data[0]};
  std::vector<int> tl(total + 2), tr(total + 2);
  int ntl = sklansky(p, 0, maxy, tl, -1, 1);
  int ntr = sklansky(p, total - 1, maxy, tr, -1, -1);
  std::swap(tl, tr);
  std::swap(ntl, ntr);
  std::vector<int> idx;
  for (int i = 0; i < ntl - 1; ++i) idx.push_back(ptr[tl[i]]);
  for (int i = ntr - 1; i > 0; --i) idx.push_back(ptr[tr[i]]);
  const int stop = ntr > 2 ? tr[1] : (ntl > 2 ? tl[ntl - 2] : -1);
  std::vector<int> bl(total + 2), br(total + 2);
  int nbl = sklansky(p, 0, miny, bl, 1, -1);
  int nbr = sklansky(p, total - 1, miny, br, 1, 1);
  if (stop >= 0) {
    const int check = nbl > 2 ? bl[1] : (nbl + nbr > 3 ? br[2] : -1);
    if (check == stop || (check >= 0 && p[check] == p[stop])) {
      nbl = std::min(nbl, 2);
      nbr = std::min(nbr, 2);
    }
  }
  for (int i = 0; i < nbl - 1; ++i) idx.push_back(ptr[bl[i]]);
  for (int i = nbr - 1; i > 0; --i) idx.push_back(ptr[br[i]]);
  const int n = static_cast<int>(idx.size());
  if (n >= 3) {
    int lo = 0, hi = 0, lt = 0;
    for (int i = 1; i < n; ++i) {
      lt += idx[i - 1] < idx[i];
      if (1 < lt && lt <= i - 2) break;
      if (idx[i] < idx[lo]) lo = i;
      if (idx[i] > idx[hi]) hi = i;
    }
    const int span = std::abs(hi - lo);
    if ((span == 1 || span == n - 1) && (lt <= 1 || lt >= n - 2)) {
      const bool ascending = (hi + 1) % n == lo;
      const int i0 = ascending ? lo : hi;
      std::vector<int> shifted(idx.begin() + i0, idx.end());
      shifted.insert(shifted.end(), idx.begin(), idx.begin() + i0);
      bool monotone = true;
      for (int i = 0; i + 1 < n; ++i) {
        if ((shifted[i] < shifted[i + 1]) != ascending) {
          monotone = false;
          break;
        }
      }
      if (i0 > 0 && monotone) idx = shifted;
    }
  }
  std::vector<Pt> out;
  out.reserve(n);
  for (int i : idx) out.push_back({static_cast<double>(static_cast<float>(data[i].x)),
                                   static_cast<double>(static_cast<float>(data[i].y))});
  return out;
}

struct Rect {
  double cx, cy, w, h, angle;
};

// _normalized: the angle in [-90, 0), turned by steps of 90 degrees,
// each step swapping width and height; the angle rounded to f32
Rect normalized(double cx, double cy, double w, double h, double degrees) {
  while (degrees >= 0) {
    degrees -= 90;
    std::swap(w, h);
  }
  while (degrees < -90) {
    degrees += 90;
    std::swap(w, h);
  }
  return {cx, cy, w, h, static_cast<double>(static_cast<float>(degrees))};
}

// min_area_rect: cv2.minAreaRect (OpenCV 5.0), rotating calipers in f32
Rect min_area_rect(const std::vector<Pt>& points) {
  const std::vector<Pt> hull = convex_hull(points);
  const int n = static_cast<int>(hull.size());
  if (n == 1) return normalized(hull[0].x, hull[0].y, 0.0, 0.0, 0.0);
  if (n == 2) {
    const float cx = (static_cast<float>(hull[0].x) + static_cast<float>(hull[1].x)) * 0.5f;
    const float cy = (static_cast<float>(hull[0].y) + static_cast<float>(hull[1].y)) * 0.5f;
    const double dx = hull[1].x - hull[0].x, dy = hull[1].y - hull[0].y;
    const double len = static_cast<float>(std::sqrt(dx * dx + dy * dy));
    return normalized(cx, cy, len, 0.0, std::atan2(dy, dx) * 180 / M_PI);
  }
  std::vector<float> px(n), py(n), vx(n), vy(n), inv_len(n);
  for (int i = 0; i < n; ++i) {
    px[i] = static_cast<float>(hull[i].x);
    py[i] = static_cast<float>(hull[i].y);
  }
  int left = 0, bottom = 0, right = 0, top = 0;
  float left_x = px[0], right_x = px[0], top_y = py[0], bottom_y = py[0];
  for (int i = 0; i < n; ++i) {
    if (px[i] < left_x) { left_x = px[i]; left = i; }
    if (px[i] > right_x) { right_x = px[i]; right = i; }
    if (py[i] > top_y) { top_y = py[i]; top = i; }
    if (py[i] < bottom_y) { bottom_y = py[i]; bottom = i; }
    const int j = (i + 1) % n;
    const double dx = px[j] - px[i], dy = py[j] - py[i];
    vx[i] = static_cast<float>(dx);
    vy[i] = static_cast<float>(dy);
    inv_len[i] = static_cast<float>(1.0 / std::sqrt(dx * dx + dy * dy));
  }
  int seq[4] = {bottom, right, top, left};
  float minarea = std::numeric_limits<float>::max();
  int best_left = 0, best_bottom = 0;
  float best_a = 0.0f, best_b = 0.0f, best_w = 0.0f, best_h = 0.0f;
  for (int it = 0; it < n; ++it) {
    // each caliper's edge turned into the frame of the first one; the
    // edge that is furthest clockwise leads
    const float rot[4][2] = {{vx[seq[0]], vy[seq[0]]},
                             {vy[seq[1]], -vx[seq[1]]},
                             {-vx[seq[2]], -vy[seq[2]]},
                             {-vy[seq[3]], vx[seq[3]]}};
    int main_i = 0;
    for (int i = 1; i < 4; ++i) {
      const float c1 = rot[i][1] * rot[main_i][0];
      const float c2 = rot[i][0] * rot[main_i][1];
      if (c1 - c2 < 0) main_i = i;
    }
    const int pi = seq[main_i];
    const float lead_x = vx[pi] * inv_len[pi];
    const float lead_y = vy[pi] * inv_len[pi];
    float base_a, base_b;
    switch (main_i) {
      case 0: base_a = lead_x; base_b = lead_y; break;
      case 1: base_a = lead_y; base_b = -lead_x; break;
      case 2: base_a = -lead_x; base_b = -lead_y; break;
      default: base_a = -lead_y; base_b = lead_x; break;
    }
    seq[main_i] = (seq[main_i] + 1) % n;
    float dx = px[seq[1]] - px[seq[3]];
    float dy = py[seq[1]] - py[seq[3]];
    const float wa = dx * base_a, wb = dy * base_b;
    const float width = wa + wb;
    dx = px[seq[2]] - px[seq[0]];
    dy = py[seq[2]] - py[seq[0]];
    const float ha = -dx * base_b, hb = dy * base_a;
    const float height = ha + hb;
    const float area = width * height;
    if (area <= minarea) {
      minarea = area;
      best_left = seq[3];
      best_a = base_a;
      best_w = width;
      best_b = base_b;
      best_h = height;
      best_bottom = seq[0];
    }
  }
  const float a1 = best_a, b1 = best_b, a2 = -best_b, b2 = best_a;
  const float c1 = a1 * px[best_left] + py[best_left] * b1;
  const float c2 = a2 * px[best_bottom] + py[best_bottom] * b2;
  const float idet = 1.0f / (a1 * b2 - a2 * b1);
  const float qx = (c1 * b2 - c2 * b1) * idet;
  const float qy = (a1 * c2 - a2 * c1) * idet;
  const float o1x = a1 * best_w, o1y = b1 * best_w;
  const float o2x = a2 * best_h, o2y = b2 * best_h;
  const float cx = qx + (o1x + o2x) * 0.5f;
  const float cy = qy + (o1y + o2y) * 0.5f;
  const double d1x = o1x, d1y = o1y, d2x = o2x, d2y = o2y;
  const double w = static_cast<float>(std::sqrt(d1x * d1x + d1y * d1y));
  const double h = static_cast<float>(std::sqrt(d2x * d2x + d2y * d2y));
  const double degrees = std::atan2(d1y, d1x) * 180 / M_PI;
  return normalized(cx, cy, w, h, degrees);
}

// box_points: cv2.boxPoints (OpenCV 5.0), corners in f32, then
// truncated to integers as numpy's astype(int64) does
void box_points(const Rect& r, int64_t xs[4], int64_t ys[4]) {
  const float cx = static_cast<float>(r.cx), cy = static_cast<float>(r.cy);
  const float w = static_cast<float>(r.w), h = static_cast<float>(r.h);
  const double rad = static_cast<double>(static_cast<float>(r.angle)) * M_PI / 180.0;
  const float b = static_cast<float>(std::cos(rad)) * 0.5f;
  const float a = static_cast<float>(std::sin(rad)) * 0.5f;
  const float ah = a * h, bw = b * w, bh = b * h, aw = a * w;
  const float pts[4][2] = {{(cx - ah) - bw, (cy + bh) - aw},
                           {(cx + ah) - bw, (cy - bh) - aw},
                           {(cx + ah) + bw, (cy - bh) + aw},
                           {(cx - ah) + bw, (cy + bh) + aw}};
  for (int i = 0; i < 4; ++i) {
    xs[i] = static_cast<int64_t>(pts[i][0]);
    ys[i] = static_cast<int64_t>(pts[i][1]);
  }
}

// numpy's float32 sum of a contiguous array: pairwise within blocks of
// its 8192-element buffer, the blocks added in turn to a zero
float pairwise_sum(const float* a, int64_t n) {
  if (n < 8) {
    float res = 0.0f;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8) {
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    }
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

float numpy_sum(const float* a, int64_t n) {
  const int64_t block = 8192;
  float s = 0.0f;
  for (int64_t i = 0; i < n; i += block) s += pairwise_sum(a + i, std::min(block, n - i));
  return s;
}

}  // namespace

extern "C" {

// Union-find labelling (link_components). pixel: [h*w] uint8; link:
// [8*h*w] uint8; labels_out: [h*w] int32, 0 for background and the
// components numbered from 1 in the raster order of their first pixel.
// Returns the number of components.
int32_t pixellink_components(const uint8_t* pixel, const uint8_t* link, int32_t h, int32_t w,
                             int32_t* labels_out) {
  const size_t n = static_cast<size_t>(h) * w;
  DSU dsu(n);
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t p = y * w + x;
      if (!pixel[p]) continue;
      for (int j = 0; j < 8; ++j) {
        const int32_t ny = y + DY[j], nx = x + DX[j];
        if (ny < 0 || nx < 0 || ny >= h || nx >= w) continue;
        const int32_t q = ny * w + nx;
        if (pixel[q] && link[static_cast<size_t>(j) * n + p]) dsu.unite(p, q);
      }
    }
  }
  std::vector<int32_t> id_of_root(n, 0);
  int32_t next_id = 0;
  for (size_t p = 0; p < n; ++p) {
    if (!pixel[p]) {
      labels_out[p] = 0;
      continue;
    }
    const int32_t root = dsu.find(static_cast<int32_t>(p));
    if (id_of_root[root] == 0) id_of_root[root] = ++next_id;
    labels_out[p] = id_of_root[root];
  }
  return next_id;
}

// The per-component loop of mask_to_boxes over an upscaled label map.
// labels: [size*size] int32 (0 background, components 1..n_labels);
// score: [size*size] f32, the upscaled score map. For each component in
// label order: the minimum-area rectangle of the hull of its rows' end
// pixels, dropped if its shorter side is under min_height or its area
// under min_area; else its box points truncated, clipped to
// [0, size - 1], their extent into boxes_out [k, 4] (x1, y1, x2, y2) and
// the mean score over the component's pixels into scores_out [k].
// Both outputs hold n_labels rows. Returns k, the rows written.
int32_t pixellink_boxes(const int32_t* labels, const float* score, int32_t size,
                        int32_t n_labels, double min_height, double min_area,
                        double* boxes_out, double* scores_out) {
  const int64_t n = static_cast<int64_t>(size) * size;
  std::vector<int64_t> start(static_cast<size_t>(n_labels) + 2, 0);
  for (int64_t p = 0; p < n; ++p) {
    const int32_t l = labels[p];
    if (l > 0 && l <= n_labels) ++start[l + 1];
  }
  for (int32_t l = 1; l <= n_labels; ++l) start[l + 1] += start[l];
  std::vector<int64_t> pos(static_cast<size_t>(start[n_labels + 1]));
  {
    std::vector<int64_t> fill(start.begin(), start.end());
    for (int64_t p = 0; p < n; ++p) {
      const int32_t l = labels[p];
      if (l > 0 && l <= n_labels) pos[fill[l]++] = p;
    }
  }
  int32_t k = 0;
  std::vector<Pt> ends;
  std::vector<float> vals;
  for (int32_t l = 1; l <= n_labels; ++l) {
    const int64_t b = start[l], e = start[l + 1];
    if (b == e) continue;
    // the first and last pixel of every row, as (x, y)
    ends.clear();
    for (int64_t i = b; i < e;) {
      const int64_t y = pos[i] / size;
      int64_t j = i;
      while (j + 1 < e && pos[j + 1] / size == y) ++j;
      ends.push_back({static_cast<double>(pos[i] % size), static_cast<double>(y)});
      ends.push_back({static_cast<double>(pos[j] % size), static_cast<double>(y)});
      i = j + 1;
    }
    std::vector<Pt> hull = border_hull(ends);
    for (Pt& q : hull) {
      q.x = static_cast<float>(q.x);
      q.y = static_cast<float>(q.y);
    }
    const Rect r = min_area_rect(hull);
    if (std::min(r.w, r.h) < min_height) continue;
    if (r.w * r.h < min_area) continue;
    int64_t xs[4], ys[4];
    box_points(r, xs, ys);
    int64_t x1 = 0, y1 = 0, x2 = 0, y2 = 0;
    for (int i = 0; i < 4; ++i) {
      const int64_t x = std::clamp<int64_t>(xs[i], 0, size - 1);
      const int64_t y = std::clamp<int64_t>(ys[i], 0, size - 1);
      if (i == 0 || x < x1) x1 = x;
      if (i == 0 || y < y1) y1 = y;
      if (i == 0 || x > x2) x2 = x;
      if (i == 0 || y > y2) y2 = y;
    }
    vals.resize(static_cast<size_t>(e - b));
    for (int64_t i = b; i < e; ++i) vals[i - b] = score[pos[i]];
    const float sum = numpy_sum(vals.data(), e - b);
    boxes_out[4 * k + 0] = static_cast<double>(x1);
    boxes_out[4 * k + 1] = static_cast<double>(y1);
    boxes_out[4 * k + 2] = static_cast<double>(x2);
    boxes_out[4 * k + 3] = static_cast<double>(y2);
    scores_out[k] = static_cast<float>(static_cast<double>(sum) / static_cast<double>(e - b));
    ++k;
  }
  return k;
}

}  // extern "C"
