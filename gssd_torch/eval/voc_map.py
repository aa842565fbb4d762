"""VOC multi-class mAP: the port of ``gssd_tpu/eval/voc_map.py``.

One pass over the dataset collects every class's detections from the
[B, C, K, 5] Detect output; then, per foreground class with ground
truth, the greedy TP/FP sweep and VOC AP at one IoU threshold
(``evaluate_detections``), with the difficult objects flagged and
ignored; the mAP is the mean over those classes. Unlike the JAX package,
the last chunk of images is not padded to the batch size (the padding
rows were never read).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from gssd_torch.data.voc import VOC_CLASSES
from gssd_torch.eval.ap_iobb import evaluate_detections


def run_voc_map(
    infer_fn: Callable[[np.ndarray], np.ndarray],
    dataset,
    transform,
    num_classes: int = 21,
    conf_threshold: float = 0.01,
    iou_threshold: float = 0.5,
    use_07_metric: bool = False,
    batch_size: int = 16,
) -> Dict[str, float]:
    """dataset: the ``VOCDataset`` protocol (pull_image [H, W, 3] 0..255,
    pull_anno [n, 5] normalised boxes + class index, and where it has it
    pull_anno_with_difficult). infer_fn maps a [B, H, W, 3] f32 batch to
    [B, C, K, 5] detections. Returns {"map": ..., "ap_<class>": ...} over
    the foreground classes 1..C-1 with ground truth (class 0 is the
    background)."""
    n = len(dataset)
    classes = range(1, num_classes)
    preds = {c: [] for c in classes}
    gts = {c: {} for c in classes}
    diffs = {c: {} for c in classes}
    with_diff = hasattr(dataset, "pull_anno_with_difficult")
    for start in range(0, n, batch_size):
        images, sizes = [], []
        for idx in range(start, min(start + batch_size, n)):
            raw = dataset.pull_image(idx)
            if raw.ndim == 3:
                raw = raw[None]  # [1, H, W, 3]: the phase axis
            if with_diff:
                anno, dflags = dataset.pull_anno_with_difficult(idx)
            else:
                anno = dataset.pull_anno(idx)
                dflags = np.zeros(len(anno), bool)
            H, W = raw.shape[1], raw.shape[2]
            for c in classes:
                sel = anno[:, 4] == c - 1
                gts[c][idx] = (anno[sel, :4] * [W, H, W, H]).astype(np.float64)
                diffs[c][idx] = dflags[sel]
            x, _, _ = transform(raw)
            p, h, w, ch = x.shape
            images.append(np.transpose(x, (1, 2, 0, 3)).reshape(h, w, p * ch))
            sizes.append((W, H))
        det = np.asarray(infer_fn(np.stack(images).astype(np.float32)))
        for bi, (W, H) in enumerate(sizes):
            for c in classes:
                rows = det[bi, c]
                rows = rows[rows[:, 0] > conf_threshold]
                if len(rows) == 0:
                    continue
                out = np.empty((len(rows), 6))
                out[:, 0] = start + bi
                out[:, 1] = rows[:, 0]
                out[:, 2:6] = rows[:, 1:5] * [W, H, W, H]
                preds[c].append(out)
    result, aps = {}, []
    for c in classes:
        npos = sum(int(np.sum(~diffs[c].get(k, np.zeros(len(v), bool))))
                   for k, v in gts[c].items())
        if npos == 0:
            continue  # no (non-difficult) object of this class in the set
        p = np.concatenate(preds[c]) if preds[c] else np.zeros((0, 6))
        ap = evaluate_detections(p, gts[c], iou_threshold, "iou", use_07_metric,
                                 gt_difficult=diffs[c])
        name = VOC_CLASSES[c - 1] if c - 1 < len(VOC_CLASSES) else f"class{c}"
        result[f"ap_{name}"] = ap
        aps.append(ap)
    result["map"] = float(np.mean(aps)) if aps else 0.0
    return result
