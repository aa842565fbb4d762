"""The plain reference held to the port (``gssd_torch``) on the CPU at
small sizes: priors, the training batch, the loss, the forward in both
modes, Detect/NMS and one SGD step. This test imports both; the reference
imports nothing of the port."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, data, program
from benchmark.reference import augment, boxes as rb
from benchmark.reference.infer import detect as ref_detect
from benchmark.reference.model import GSSD, param_spec
from benchmark.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["gssdpp-300", "gssdpp-512"])
def test_priors(name):
    from gssd_torch.ops.anchors import make_anchors

    m = config(name)["model"]
    np.testing.assert_array_equal(rb.priors(m["anchors"]), make_anchors(m["anchors"]["name"]))


def test_training_batch_matches_the_device_cache():
    from gssd_torch.data import DeviceCacheLoader

    ct, bboxes = data.lesion_slices(5, 64, seed=2**31 + 7, device="cpu")
    raw = data.to_uint8(ct)
    loader = iter(DeviceCacheLoader(data.SliceSet(raw.numpy(), bboxes), 3, size=48, max_gt=4,
                                    seed=2**31 + 7, pixeljitter=0.01, device="cpu"))
    aug = {"size": 48, "max_gt": 4, "pixel_jitter": 0.01, "expand_ratio": 1.5, "mean": 0.0}
    for j in range(4):
        port = next(loader)
        ref = augment.make_batch(raw, bboxes, 2**31 + 7, j, 3, aug)
        # the port warps in float32, the reference in float64
        assert (port["image"].double() - ref["image"]).abs().max() < 1e-5
        for key in ("boxes", "labels", "valid"):
            assert torch.equal(port[key], ref[key].to(port[key].dtype)), key


def test_multibox_loss_matches_the_port():
    from gssd_torch.config import LossConfig
    from gssd_torch.ops.losses import multibox_loss

    cfg = config("gssdpp-300")
    pri = torch.as_tensor(rb.priors(cfg["model"]["anchors"]))
    g = torch.Generator().manual_seed(3)
    B, G = 4, 5
    lo = torch.rand(B, G, 2, generator=g) * 0.6
    truths = torch.cat([lo, lo + 0.05 + torch.rand(B, G, 2, generator=g) * 0.3], dim=-1)
    labels = torch.zeros(B, G, dtype=torch.int32)
    valid = torch.rand(B, G, generator=g) < 0.7
    valid[:, 0] = True
    loc = torch.randn(B, len(pri), 4, generator=g)
    conf = torch.randn(B, len(pri), 2, generator=g)
    lc = cfg["loss"]
    ours = rb.multibox_loss(loc, conf, pri, truths, labels, valid, lc)
    port = multibox_loss(loc, conf, pri, truths, labels, valid,
                         LossConfig(overlap_thresh=lc["overlap_thresh"],
                                    neg_pos_ratio=lc["neg_pos_ratio"]))
    for a, b in zip(ours, port[:2]):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port_in_float32(train):
    cfg = config("gssdpp-300")
    cfg["model"].update(compute_dtype="float32", dcn_impl="xla")
    w = make_weights(param_spec(cfg["model"]), 11, "cpu")
    model, _ = program.model_and_priors(cfg, w, "cpu")
    model.train(train)
    x = torch.rand(1, 300, 300, 12, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = copy.deepcopy(model)(x)
        loc, conf = GSSD(cfg["model"], w).forward(x, train=train)
    for a, b in ((out["loc"], loc), (out["conf"], conf)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_detect_matches_the_port():
    from gssd_torch.config import DetectConfig
    from gssd_torch.ops.nms import detect

    g = torch.Generator().manual_seed(5)
    P = 600
    lo = torch.rand(2, P, 2, generator=g)
    bx = torch.cat([lo, lo + 0.05 + 0.2 * torch.rand(2, P, 2, generator=g)], dim=-1)
    s1 = torch.rand(2, P, generator=g)
    scores = torch.stack([1 - s1, s1], dim=1)
    ours = ref_detect(scores, bx, 200, 0.01, 0.45)
    # the port's detect decodes loc against priors: zero variance-scaled
    # offsets on centre-form priors give back the boxes themselves
    pri = rb.point_form(torch.cat([(bx[0, :, :2] + bx[0, :, 2:]) / 2, bx[0, :, 2:] - bx[0, :, :2]],
                                  -1))
    centre = torch.cat([(bx[0, :, :2] + bx[0, :, 2:]) / 2, bx[0, :, 2:] - bx[0, :, :2]], -1)
    port = detect(torch.zeros(1, P, 4), scores[:1].transpose(1, 2), centre, DetectConfig())
    assert torch.allclose(port[0], ours[0], atol=1e-6)
    assert torch.allclose(pri, bx[0], atol=1e-6)
    # the reference's own Detect output is what check.detection_gap accepts
    assert check.detection_stats(ours, scores, bx, 0.45, 0.01)["widest"] <= 1e-6


def test_first_training_step_matches_the_port_in_float32():
    from benchmark.drivers import train as T

    cfg = config("gssdpp-300")
    cfg["model"].update(compute_dtype="float32", dcn_impl="xla")
    cfg["slices"] = 4
    traffic = {"kind": "train", "batch": 2, "source_size": 96, "max_lesions": 2,
               "check_steps": 1, "warm_steps": 0, "trace_steps": 1}
    d = T.Driver(cfg, traffic, 2**33 + 1, "cpu")
    d.setup()
    d.release()
    numbers = d.check()
    # distances to float64 over bfloat16 rounding's: float32 reads far below 1
    assert numbers["grad"] < 0.2 and numbers["change"] < 0.2, numbers
