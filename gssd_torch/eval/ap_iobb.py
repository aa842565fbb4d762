"""AP / IoBB evaluation, the port of ``gssd_tpu/eval/ap_iobb.py`` (numpy).

1. run the detector over every eval image, keep class-1 detections,
   scale boxes to original pixels, filter by the confidence threshold;
2. sort all detections by confidence (descending) across the dataset;
3. for every (metric in {IoU, IoBB}) x (threshold in ap_list/iobb_list):
   greedy TP/FP assignment, where a detection is a TP if its best-overlap
   gt in the same image clears the threshold and is not already claimed;
   IoBB divides the intersection by the predicted box's area instead of
   the union;
4. precision/recall cumsums -> AP by the 11-point VOC-07 rule or the
   exact area under the curve.

PixelLink models go through ``collect_predictions_pixellink``: logit
maps decoded into scored boxes on the host (``pixellink_decode``).

The greedy sweep runs in the port's C++ host library
(``gssd_torch/native/eval_sweep.cpp``), as the JAX package runs its own;
the numpy loop is the plain version (``impl="numpy"``), with the same
bits. Sets with difficult flags take the numpy loop, as in the JAX
package. Unlike the JAX package, the last chunk of images is not padded
to the batch size: an eager forward has no fixed shape to keep, and the
padding rows were never read.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gssd_torch.config import PixelLinkConfig
from gssd_torch.eval.pixellink_decode import mask_to_boxes
from gssd_torch.native.build import NATIVE, check_impl, ptr


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP from recall/precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _overlap(pred_box: np.ndarray, gts: np.ndarray, metric: str) -> np.ndarray:
    """Overlap of one predicted box against [n, 4] gts (pixel coords)."""
    ix1 = np.maximum(gts[:, 0], pred_box[0])
    iy1 = np.maximum(gts[:, 1], pred_box[1])
    ix2 = np.minimum(gts[:, 2], pred_box[2])
    iy2 = np.minimum(gts[:, 3], pred_box[3])
    inter = np.maximum(ix2 - ix1, 0.0) * np.maximum(iy2 - iy1, 0.0)
    pred_area = (pred_box[2] - pred_box[0]) * (pred_box[3] - pred_box[1])
    if metric == "iobb":
        denom = pred_area
    else:
        gt_area = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
        denom = gt_area + pred_area - inter
    return inter / np.maximum(denom, 1e-12)


def evaluate_detections(
    predictions: np.ndarray,
    gt_boxes: Dict[int, np.ndarray],
    threshold: float,
    metric: str = "iou",
    use_07_metric: bool = False,
    gt_difficult: Optional[Dict[int, np.ndarray]] = None,
    impl: str = "native",
) -> float:
    """AP of a detection set at one (metric, threshold).

    predictions: [N, 6] rows (image_idx, score, x1, y1, x2, y2), any order.
    gt_boxes: image_idx -> [n, 4] pixel gt boxes. metric: 'iou' or 'iobb'.
    gt_difficult: optional image_idx -> [n] bool flags aligned with
    gt_boxes; difficult objects are ignored (VOC protocol): left out of
    npos, and a detection whose best match is difficult counts as
    neither TP nor FP. impl: the sweep in "native" C++ or "numpy".
    """
    tp, fp, npos = sweep(predictions, gt_boxes, threshold, metric, gt_difficult, impl)
    if tp is None:
        return 0.0
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    rec = tp_c / npos
    prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


def _sweep_native(preds: np.ndarray, gt_boxes: Dict[int, np.ndarray], threshold: float,
                  metric: str) -> Tuple[np.ndarray, np.ndarray]:
    keys = sorted(gt_boxes)
    remap = {k: i for i, k in enumerate(keys)}
    offsets = np.zeros(len(keys) + 1, np.int64)
    offsets[1:] = np.cumsum([len(gt_boxes[k]) for k in keys])
    flat = np.zeros((int(offsets[-1]), 4))
    for i, k in enumerate(keys):
        if len(gt_boxes[k]):
            flat[offsets[i]:offsets[i + 1]] = np.asarray(gt_boxes[k])[:, :4]
    p = np.array(preds, np.float64)
    p[:, 0] = [remap.get(int(v), -1) for v in preds[:, 0]]
    tp = np.zeros(len(p), np.uint8)
    fp = np.zeros(len(p), np.uint8)
    NATIVE["eval_sweep"](ptr(p, ctypes.c_double), len(p), ptr(offsets, ctypes.c_int64),
                         len(keys), ptr(flat, ctypes.c_double), float(threshold),
                         1 if metric == "iobb" else 0, ptr(tp, ctypes.c_uint8),
                         ptr(fp, ctypes.c_uint8))
    return tp.astype(np.float64), fp.astype(np.float64)


def sweep(
    predictions: np.ndarray,
    gt_boxes: Dict[int, np.ndarray],
    threshold: float,
    metric: str = "iou",
    gt_difficult: Optional[Dict[int, np.ndarray]] = None,
    impl: str = "native",
):
    """The greedy TP/FP assignment of ``evaluate_detections`` -> (tp [N],
    fp [N] as 0/1 floats over the predictions sorted by score, npos), or
    (None, None, npos) where there is nothing to sweep."""
    check_impl(impl)
    any_difficult = gt_difficult is not None and any(
        np.any(v) for v in gt_difficult.values())
    if any_difficult:
        npos = sum(int(np.sum(~np.asarray(gt_difficult.get(k, np.zeros(len(v), bool)))))
                   for k, v in gt_boxes.items())
    else:
        npos = sum(len(v) for v in gt_boxes.values())
    if npos == 0 or len(predictions) == 0:
        return None, None, npos
    preds = predictions[np.argsort(-predictions[:, 1], kind="stable")]
    if impl == "native" and not any_difficult:  # the C++ sweep has no difficult flags
        return (*_sweep_native(preds, gt_boxes, threshold, metric), npos)
    claimed = {k: np.zeros(len(v), bool) for k, v in gt_boxes.items()}
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    for i, row in enumerate(preds):
        img = int(row[0])
        gts = gt_boxes.get(img)
        if gts is None or len(gts) == 0:
            fp[i] = 1.0
            continue
        ov = _overlap(row[2:6], gts, metric)
        j = int(np.argmax(ov))
        if ov[j] > threshold:
            if (any_difficult and gt_difficult.get(img) is not None
                    and len(gt_difficult[img]) > j and gt_difficult[img][j]):
                continue  # ignored: neither TP nor FP
            if not claimed[img][j]:
                tp[i] = 1.0
                claimed[img][j] = True
            else:
                fp[i] = 1.0
        else:
            fp[i] = 1.0
    return tp, fp, npos


def _stream_batches(dataset, transform, batch_size: int, gt_boxes: Dict[int, np.ndarray]):
    """Yield (start, batch [b, H, W, 12] f32, sizes [(W, H), ...]) chunk by
    chunk, b <= batch_size; fills gt_boxes (pixel boxes) on the way."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        images, sizes = [], []
        for idx in range(start, min(start + batch_size, n)):
            raw = dataset.pull_image(idx)  # [4, H, W, 3] 0..255
            gt_boxes[idx] = dataset.pull_anno(idx)[:, :4].astype(np.float64)
            x, _, _ = transform(raw)
            p, h, w, c = x.shape
            images.append(np.transpose(x, (1, 2, 0, 3)).reshape(h, w, p * c))
            sizes.append((raw.shape[2], raw.shape[1]))  # (W, H)
        yield start, np.stack(images).astype(np.float32), sizes


def collect_predictions(
    infer_fn: Callable[[np.ndarray], np.ndarray],
    dataset,
    transform,
    conf_threshold: float = 0.2,
    batch_size: int = 16,
    class_idx: int = 1,
    score_sink: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """Run the detector over a dataset -> (predictions [N, 6], gt_boxes).

    infer_fn maps a [B, H, W, 12] float batch to [B, C, K, 5] detections
    (score, x1, y1, x2, y2) in normalised coordinates. Predictions are
    scaled to the original pixel size and filtered at conf_threshold. If
    score_sink is given it receives 'raw' (every score > 0) and
    'filtered' (after the threshold) score arrays.
    """
    preds: List[np.ndarray] = []
    gt_boxes: Dict[int, np.ndarray] = {}
    raw_scores: List[np.ndarray] = []
    kept_scores: List[np.ndarray] = []
    for start, batch, sizes in _stream_batches(dataset, transform, batch_size, gt_boxes):
        det = np.asarray(infer_fn(batch))
        for bi, (W, H) in enumerate(sizes):
            rows = det[bi, class_idx]
            if score_sink is not None:
                raw_scores.append(rows[rows[:, 0] > 0, 0])
            rows = rows[rows[:, 0] > conf_threshold]
            if score_sink is not None:
                kept_scores.append(rows[:, 0])
            if len(rows) == 0:
                continue
            out = np.empty((len(rows), 6))
            out[:, 0] = start + bi
            out[:, 1] = rows[:, 0]
            out[:, 2] = rows[:, 1] * W
            out[:, 3] = rows[:, 2] * H
            out[:, 4] = rows[:, 3] * W
            out[:, 5] = rows[:, 4] * H
            preds.append(out)
    if score_sink is not None:
        score_sink["raw"] = np.concatenate(raw_scores) if raw_scores else np.zeros(0)
        score_sink["filtered"] = np.concatenate(kept_scores) if kept_scores else np.zeros(0)
    return (np.concatenate(preds) if preds else np.zeros((0, 6))), gt_boxes


def collect_predictions_pixellink(
    forward_fn: Callable,
    dataset,
    transform,
    conf_threshold: float = 0.2,
    batch_size: int = 16,
    img_size: int = 300,
    pl_cfg: Optional[PixelLinkConfig] = None,
) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """The PixelLink evaluation path: ``forward_fn`` maps a [B, H, W, 12]
    batch to (pixel [B, h, w, 2], link [B, h, w, 16]) logit maps, which
    ``mask_to_boxes`` decodes on the host -> (predictions [N, 6] in the
    original pixel size, filtered at ``conf_threshold``; gt_boxes)."""
    pl_cfg = pl_cfg or PixelLinkConfig()
    preds: List[np.ndarray] = []
    gt_boxes: Dict[int, np.ndarray] = {}
    for start, batch, sizes in _stream_batches(dataset, transform, batch_size, gt_boxes):
        pix, lnk = (np.asarray(t) for t in forward_fn(batch))
        for bi, (W, H) in enumerate(sizes):
            scores, boxes = mask_to_boxes(pix[bi], lnk[bi], img_size, pl_cfg)
            keep = scores > conf_threshold
            scores, boxes = scores[keep], boxes[keep]
            if len(scores) == 0:
                continue
            out = np.empty((len(scores), 6))
            out[:, 0] = start + bi
            out[:, 1] = scores
            out[:, 2] = boxes[:, 0] * W / img_size
            out[:, 3] = boxes[:, 1] * H / img_size
            out[:, 4] = boxes[:, 2] * W / img_size
            out[:, 5] = boxes[:, 3] * H / img_size
            preds.append(out)
    return (np.concatenate(preds) if preds else np.zeros((0, 6))), gt_boxes


def run_detection_eval(
    infer_fn,
    dataset,
    transform,
    ap_list: Sequence[float] = (0.3, 0.5, 0.7),
    iobb_list: Sequence[float] = (0.3, 0.5, 0.7),
    conf_threshold: float = 0.2,
    use_07_metric: bool = False,
    batch_size: int = 16,
    use_pixel_link: bool = False,
    img_size: int = 300,
    pl_cfg: Optional[PixelLinkConfig] = None,
    score_sink: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, float]:
    """Full sweep -> {'ap30': ..., 'ap50': ..., 'iobb30': ...}. With
    ``use_pixel_link``, ``infer_fn`` returns PixelLink logit maps (see
    ``collect_predictions_pixellink``) and ``score_sink`` is not filled."""
    if use_pixel_link:
        preds, gts = collect_predictions_pixellink(infer_fn, dataset, transform,
                                                   conf_threshold, batch_size, img_size, pl_cfg)
    else:
        preds, gts = collect_predictions(infer_fn, dataset, transform, conf_threshold,
                                         batch_size, score_sink=score_sink)
    out = {}
    for t in ap_list:
        out[f"ap{int(round(t * 100))}"] = evaluate_detections(preds, gts, t, "iou",
                                                              use_07_metric)
    for t in iobb_list:
        out[f"iobb{int(round(t * 100))}"] = evaluate_detections(preds, gts, t, "iobb",
                                                                use_07_metric)
    return out
