"""The port's box math, Detect head (gssd_torch.ops) and eval transform
(gssd_torch.data.transforms) against the JAX package's, fed the same
seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.config import ANCHOR_CONFIGS as JAX_ANCHOR_CONFIGS
from gssd_tpu.config import DetectConfig as JaxDetectConfig
from gssd_tpu.data.transforms import BaseTransform as JaxBaseTransform
from gssd_tpu.data.transforms import resize_phases as cv2_resize
from gssd_tpu.ops import boxes as jax_boxes
from gssd_tpu.ops.anchors import make_anchors as jax_make_anchors
from gssd_tpu.ops.nms import detect as jax_detect
from gssd_torch.config import ANCHOR_CONFIGS, DetectConfig
from gssd_torch.data.transforms import BaseTransform, resize_phases
from gssd_torch.ops import boxes
from gssd_torch.ops.anchors import make_anchors
from gssd_torch.ops.nms import detect


@pytest.mark.parametrize("name", sorted(JAX_ANCHOR_CONFIGS))
def test_anchors_match_exactly(name):
    assert ANCHOR_CONFIGS[name].num_priors_per_cell == (
        JAX_ANCHOR_CONFIGS[name].num_priors_per_cell)
    np.testing.assert_array_equal(make_anchors(name), jax_make_anchors(name))


def _point_boxes(rng, shape):
    lo = rng.uniform(0, 0.7, shape + (2,))
    return np.concatenate([lo, lo + rng.uniform(0.01, 0.3, shape + (2,))],
                          axis=-1).astype(np.float32)


def test_iou_and_decode_match(rng):
    a, b = _point_boxes(rng, (2, 7)), _point_boxes(rng, (2, 5))
    np.testing.assert_allclose(
        boxes.iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)  # same f32 ops, same order
    priors = make_anchors("v2")
    loc = rng.normal(0, 1, (2, priors.shape[0], 4)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.decode(torch.from_numpy(loc), torch.tensor(priors)).numpy(),
        np.asarray(jax_boxes.decode(jnp.asarray(loc), jnp.asarray(priors))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        boxes.point_form(torch.tensor(priors)).numpy(),
        np.asarray(jax_boxes.point_form(jnp.asarray(priors))), atol=1e-7)


def test_detect_matches_jax(rng):
    # full v2 prior table, small loc offsets so neighbouring priors
    # overlap and NMS suppresses; tie-free softmax scores, some under
    # conf_thresh
    priors = make_anchors("v2")
    P = priors.shape[0]
    loc = rng.normal(0, 0.5, (2, P, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (2, P, 3)).astype(np.float32)
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cfg = DetectConfig(num_classes=3)
    got = detect(torch.from_numpy(loc), torch.from_numpy(conf),
                 torch.tensor(priors), cfg).numpy()
    want = np.asarray(jax_detect(jnp.asarray(loc), jnp.asarray(conf),
                                 jnp.asarray(priors),
                                 JaxDetectConfig(num_classes=3)))
    assert got.shape == want.shape == (2, 3, cfg.top_k, 5)
    kept = (want[:, 1:, :, 0] > 0).sum()
    assert 0 < kept < 2 * 2 * cfg.top_k  # some kept, some suppressed
    # same candidates, same greedy order: only f32 rounding differs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(4, 512, 512, 3), (2, 97, 131, 3)])
def test_resize_and_base_transform_match_cv2(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    # OpenCV's INTER_LINEAR and torch's bilinear (half-pixel centres, no
    # antialias) sample the same points; their interpolation weights
    # differ in the last bits: ~1e-2 on the 0..255 scale
    np.testing.assert_allclose(resize_phases(img, 300), cv2_resize(img, 300),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(BaseTransform(300)(img)[0],
                               JaxBaseTransform(300)(img)[0], atol=1e-4, rtol=0)
