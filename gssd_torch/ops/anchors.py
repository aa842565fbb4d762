"""Anchor (prior box) table, built once with numpy.

Per-cell box order: [min_size square, sqrt(min*max) square, then for
each aspect ratio ar: (s*sqrt(ar), s/sqrt(ar)), (s/sqrt(ar), s*sqrt(ar))].
The 'v2_custom' variants replace the rectangular pair with squares of
sizes s*sqrt(ar) and s/sqrt(ar). Cells iterate row-major over
(i, j) = (y, x) with centers ((j+.5)/f_k, (i+.5)/f_k), f_k = size/step.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Union

import numpy as np

from gssd_torch.config import ANCHOR_CONFIGS, AnchorConfig


def _cell_boxes(cfg: AnchorConfig, k: int) -> np.ndarray:
    """The (w, h) menu for one cell of scale k: [n_box, 2]."""
    if cfg.name == "v1":
        # legacy branch: no sqrt box when max_size <= 0, rectangles only
        # for ar != 1
        s = cfg.min_sizes[k] / cfg.min_dim
        wh = [(s, s)]
        if cfg.max_sizes[k] > 0:
            sp = math.sqrt(cfg.min_sizes[k] * cfg.max_sizes[k]) / cfg.min_dim
            wh.append((sp, sp))
        for ar in cfg.aspect_ratios[k]:
            if abs(ar - 1) >= 1e-6:
                r = math.sqrt(ar)
                wh.append((s * r, s / r))
        return np.asarray(wh, dtype=np.float64)
    s_k = cfg.min_sizes[k] / cfg.min_dim
    s_k_prime = math.sqrt(s_k * (cfg.max_sizes[k] / cfg.min_dim))
    wh = [(s_k, s_k), (s_k_prime, s_k_prime)]
    square_only = cfg.name.startswith("v2_custom")
    for ar in cfg.aspect_ratios[k]:
        r = math.sqrt(ar)
        if square_only:
            wh += [(s_k * r, s_k * r), (s_k / r, s_k / r)]
        else:
            wh += [(s_k * r, s_k / r), (s_k / r, s_k * r)]
    return np.asarray(wh, dtype=np.float64)


@lru_cache(maxsize=None)
def make_anchors(cfg: Union[str, AnchorConfig] = "v2") -> np.ndarray:
    """Build the full center-form anchor table [num_priors, 4] float32."""
    if isinstance(cfg, str):
        cfg = ANCHOR_CONFIGS[cfg]
    scales = []
    for k, f in enumerate(cfg.feature_maps):
        # legacy v1 centers divide by the feature-map size itself
        f_k = float(f) if cfg.name == "v1" else cfg.min_dim / cfg.steps[k]
        ij = np.arange(f, dtype=np.float64)
        cy, cx = np.meshgrid(ij, ij, indexing="ij")  # cy varies slowest
        centers = np.stack([(cx + 0.5) / f_k, (cy + 0.5) / f_k], axis=-1)
        centers = centers.reshape(-1, 1, 2)  # [f*f, 1, 2]
        wh = _cell_boxes(cfg, k)[None]  # [1, n_box, 2]
        boxes = np.concatenate(
            [np.broadcast_to(centers, (f * f, wh.shape[1], 2)),
             np.broadcast_to(wh, (f * f, wh.shape[1], 2))],
            axis=-1,
        )
        scales.append(boxes.reshape(-1, 4))
    out = np.concatenate(scales, axis=0)
    if cfg.clip:
        out = np.clip(out, 0.0, 1.0)
    out = np.ascontiguousarray(out, dtype=np.float32)
    out.flags.writeable = False  # shared by every caller of the cache
    return out
