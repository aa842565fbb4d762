// The greedy TP/FP sweep of the AP/IoBB evaluation.
//
// The plain version is the numpy loop of gssd_torch/eval/ap_iobb.py
// evaluate_detections (without difficult flags); this gives its bits.
// Predictions are visited in the order given (by score, descending);
// each one takes the ground-truth box of its image with which it
// overlaps most (the first such box, as numpy's argmax; a NaN overlap
// wins, as there): a true positive if the overlap is above the threshold
// and the box is not yet taken, else a false positive. metric 0 = IoU
// (intersection over union), 1 = IoBB (intersection over the predicted
// box's area). Maxima and minima pass NaN on, as numpy's do.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

double np_maximum(double a, double b) {
  if (std::isnan(a) || std::isnan(b)) return std::isnan(a) ? a : b;
  return a >= b ? a : b;
}

double np_minimum(double a, double b) {
  if (std::isnan(a) || std::isnan(b)) return std::isnan(a) ? a : b;
  return a <= b ? a : b;
}

}  // namespace

extern "C" {

// preds: [n_pred, 6] rows (image, score, x1, y1, x2, y2), image an index
// into gt_offsets (-1: an image without ground truth); gt_offsets:
// [n_images + 1] prefix offsets into gt_boxes [total, 4]; tp, fp out:
// [n_pred] uint8.
void eval_sweep(const double* preds, int64_t n_pred, const int64_t* gt_offsets,
                int64_t n_images, const double* gt_boxes, double threshold, int32_t metric,
                uint8_t* tp, uint8_t* fp) {
  std::vector<uint8_t> claimed(static_cast<size_t>(gt_offsets[n_images]), 0);
  for (int64_t i = 0; i < n_pred; ++i) {
    const double* row = preds + i * 6;
    const int64_t img = static_cast<int64_t>(row[0]);
    tp[i] = 0;
    fp[i] = 1;
    if (img < 0 || img >= n_images) continue;
    const int64_t beg = gt_offsets[img], end = gt_offsets[img + 1];
    if (beg == end) continue;
    const double px1 = row[2], py1 = row[3], px2 = row[4], py2 = row[5];
    const double parea = (px2 - px1) * (py2 - py1);
    double best = 0.0;
    int64_t best_j = -1;
    for (int64_t j = beg; j < end; ++j) {
      const double* g = gt_boxes + j * 4;
      const double ix1 = np_maximum(g[0], px1), iy1 = np_maximum(g[1], py1);
      const double ix2 = np_minimum(g[2], px2), iy2 = np_minimum(g[3], py2);
      const double inter = np_maximum(ix2 - ix1, 0.0) * np_maximum(iy2 - iy1, 0.0);
      double denom = parea;
      if (metric != 1) {
        const double garea = (g[2] - g[0]) * (g[3] - g[1]);
        denom = (garea + parea) - inter;
      }
      const double ov = inter / np_maximum(denom, 1e-12);
      if (std::isnan(ov)) {
        best = ov;
        best_j = j;
        break;
      }
      if (best_j < 0 || ov > best) {
        best = ov;
        best_j = j;
      }
    }
    if (best > threshold && !claimed[best_j]) {
      tp[i] = 1;
      fp[i] = 0;
      claimed[best_j] = 1;
    }
  }
}

}  // extern "C"
