"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (float64), each over a yardstick: the same
reference with its products rounded to bfloat16, the configuration's own
precision, on the same seed. How far rounding moves these numbers
changes from seed to seed, and the yardstick takes that out: a sound
program reads about 1, the fp8 control about ten (PERF.md).

Training (the first three steps of the object the window then drives),
over the leaves whose step-1 gradient in the reference is at least a
thousandth of the median leaf's among those with one (a leaf below that
has no gradient but round-off: a key's bias under the softmax, a conv's
bias before BatchNorm; a head that no prior of the batch reaches has
none):

- ``grad``: the median over the leaves of the distance of the first
  gradient as the optimizer holds it after step 1 (its momentum: gradient
  plus weight decay) from the reference's, over the reference's norm;
- ``change``: the same for the parameters' change over the three steps.

A state left unchanged, or moved double, reads 1 in every leaf, so tens
over the yardstick. The worst leaf's gaps of norms and each step's loss
are printed beside them and not compared: on a seed where rounding flips
which priors the hard-negative mining picks, one small head's gradient
is many times the reference's in a sound run, and a step's loss is one
scalar (PERF.md).

Serving (sampled requests of the window), per image and class, from each
served detection's distance to the nearest answer the reference allows
(the least, over priors, of the larger of its score's gap to the prior's
reference score and its box's largest coordinate gap to the prior's box,
relative where a coordinate exceeds 1: random weights decode some boxes
far outside the image) and the gap between the first detection's score
and the reference's best (so that a missing top answer shows):

- ``det``: the mean of both over the program's detections and images,
  over the yardstick's (the reference's own Detect/NMS on its bfloat16
  scores and boxes);
- ``det_max``: the widest of either gap, as it stands (a single wrong
  answer);
- ``overlap``: how far the largest overlap of two served boxes exceeds the
  NMS threshold (greedy NMS keeps none above it).

Which of two near-equal priors NMS keeps is rounding, and not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import torch

from benchmark.reference.boxes import iou

CHANGE_FLOOR = 1e-3


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names: Iterable[str]) -> Tuple[float, str]:
    """(the largest gap of norms over ``names``, its leaf)."""
    names = list(names)
    ref_n = {k: float(ref[k].double().norm()) for k in names}
    med = statistics.median(ref_n.values())
    worst, leaf = 0.0, ""
    for k in names:
        gap = abs(float(prog[k].double().norm()) - ref_n[k]) / max(ref_n[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(grad0: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.double().norm()) for k, g in grad0.items()}
    med = statistics.median([n for n in norms.values() if n > 0] or [0.0])
    return [k for k, n in norms.items() if n > 0 and n >= CHANGE_FLOOR * med]


def loss_gaps(prog: Dict, ref: Dict) -> List[float]:
    """Each step's relative loss gap (printed, not compared)."""
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]


def median_leaf_distance(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                         names: Iterable[str]) -> float:
    """The median over ``names`` of |prog - ref| / |ref|."""
    return statistics.median(
        float((prog[k].double() - ref[k].double()).norm())
        / max(float(ref[k].double().norm()), 1e-300) for k in names)


def train_numbers(prog: Dict, ref: Dict, yard: Dict) -> Dict[str, float]:
    """prog: {"first", "change"} of the program (or the control); ref and
    yard: the reference's ``run_steps`` output in float64 and with its
    products rounded to bfloat16."""
    leaves = moving_leaves(ref["grad0"])
    return {name: median_leaf_distance(prog[key], ref[key], leaves)
            / max(median_leaf_distance(yard[key], ref[key], leaves), 1e-300)
            for name, key in (("grad", "first"), ("change", "change"))}


def detection_stats(det: torch.Tensor, scores: torch.Tensor, boxes: torch.Tensor,
                    nms_thresh: float, conf_thresh: float) -> Dict[str, float]:
    """det [B, C, K, 5] (score, x1, y1, x2, y2; zeros after the kept
    ones), scores [B, C, P] and boxes [B, P, 4] of the reference ->
    {"match", "served", "top", "images", "widest", "overlap"}: the sums
    and counts of the nearest-answer and top-score gaps, the widest gap
    and the overlap above the threshold (see the module docstring)."""
    det = det.to(scores.device, scores.dtype)
    st = dict(match=0.0, served=0, top=0.0, images=0, widest=0.0, overlap=0.0)
    for b in range(det.shape[0]):
        for c in range(1, det.shape[1]):
            rows = det[b, c]
            if not torch.isfinite(rows).all():
                return dict(st, widest=float("inf"), overlap=float("inf"))
            n = int((rows[:, 0] > 0).sum())
            s, bx = scores[b, c], boxes[b]
            if n:
                coord = (rows[:n, None, 1:] - bx[None]).abs() / bx[None].abs().clamp(min=1.0)
                d = torch.maximum((rows[:n, 0, None] - s[None]).abs(), coord.amax(-1))
                e = d.min(dim=1).values
                st["match"] += float(e.sum())
                st["served"] += n
                st["widest"] = max(st["widest"], float(e.max()))
            best = float(s.max()) if bool((s > conf_thresh).any()) else 0.0
            top = abs(float(rows[0, 0]) - best)
            st["top"] += top
            st["images"] += 1
            st["widest"] = max(st["widest"], top)
            if n > 1:
                ov = iou(rows[:n, 1:], rows[:n, 1:])
                ov.fill_diagonal_(0.0)
                st["overlap"] = max(st["overlap"], float(ov.max()) - nms_thresh)
    return st


def merge(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Two ``detection_stats`` as one."""
    return {k: max(a[k], b[k]) if k in ("widest", "overlap") else a[k] + b[k] for k in a}


def mean_gap(st: Dict[str, float]) -> float:
    return st["match"] / max(st["served"], 1) + st["top"] / max(st["images"], 1)


def serve_numbers(prog: Dict[str, float], yard: Dict[str, float]) -> Dict[str, float]:
    """The serving numbers from merged ``detection_stats`` of the program
    (or the control) and of the yardstick."""
    return {"det": mean_gap(prog) / max(mean_gap(yard), 1e-300), "det_max": prog["widest"],
            "overlap": max(prog["overlap"], 0.0)}
