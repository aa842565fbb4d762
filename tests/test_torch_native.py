"""The port's host library in C++ (gssd_torch/native, built with g++ here)
against its numpy plain versions and the JAX package: the union-find
labels, the PixelLink decode's boxes and scores, and the AP/IoBB sweep's
TP/FP, all exact (the same bits); and two builds started at once, as
pytest-xdist workers may start them, end with one library."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gssd_tpu.config import PixelLinkConfig as JaxPixelLinkConfig
from gssd_tpu.eval import ap_iobb as jeval
from gssd_tpu.eval.pixellink_decode import _components_numpy as jax_components
from gssd_tpu.eval.pixellink_decode import mask_to_boxes as jax_mask_to_boxes
from gssd_torch.config import PixelLinkConfig
from gssd_torch.eval import ap_iobb as teval
from gssd_torch.eval.pixellink_decode import link_components, mask_to_boxes
from gssd_torch.native import NATIVE


def _near_threshold_logits(rng, hw, spread):
    """Pixel and link logits whose foreground probabilities scatter around
    the decoder's thresholds (0.2 and 0.8) with ``spread`` in logit
    units: small spreads give many small components."""
    pix = np.zeros((hw, hw, 2), np.float32)
    lnk = np.zeros((hw, hw, 16), np.float32)
    pix[..., 1] = rng.normal(np.log(0.2 / 0.8), spread, (hw, hw))
    lnk[..., 1::2] = rng.normal(np.log(0.8 / 0.2), spread, (hw, hw, 8))
    return pix, lnk


@pytest.mark.parametrize("hw", [9, 24, 75])
def test_union_find_matches_numpy_and_jax(hw):
    rng = np.random.default_rng(hw)
    calls = NATIVE["pixellink_components"].calls
    for density in (0.2, 0.5, 0.9):
        pixel = (rng.random((hw, hw)) < density).astype(np.uint8)
        link = (rng.random((8, hw, hw)) < 0.6).astype(np.uint8) * pixel
        got = link_components(pixel, link)
        np.testing.assert_array_equal(got, link_components(pixel, link, impl="numpy"))
        np.testing.assert_array_equal(got, jax_components(pixel, link))
        assert got.dtype == np.int32 and got.max() >= 1
    assert NATIVE["pixellink_components"].calls == calls + 3


@pytest.mark.parametrize("spread", [0.05, 0.5, 4.0], ids=["near", "mid", "far"])
def test_decode_matches_numpy_and_jax(spread):
    """Random logits near and far from the thresholds at the decoder's
    map sizes (24 -> 96, 38 and 75 -> 300, 150 -> 300 as PixelLink++ 2s):
    the C++ decode gives the numpy decode's boxes and scores bit for bit,
    in the same order, and cv2's (the JAX package's decode)."""
    rng = np.random.default_rng(int(spread * 100))
    calls = NATIVE["pixellink_boxes"].calls
    n_boxes = 0
    for hw, size in ((24, 96), (38, 300), (75, 300), (150, 300)):
        pix, lnk = _near_threshold_logits(rng, hw, spread)
        got_s, got_b = mask_to_boxes(pix, lnk, size, PixelLinkConfig())
        np_s, np_b = mask_to_boxes(pix, lnk, size, PixelLinkConfig(), impl="numpy")
        want_s, want_b = jax_mask_to_boxes(pix, lnk, size, JaxPixelLinkConfig())
        for s, b in ((np_s, np_b), (want_s, want_b)):
            assert got_s.shape == s.shape and got_b.shape == b.shape
            np.testing.assert_array_equal(got_s, s)
            np.testing.assert_array_equal(got_b, b)
        n_boxes += len(got_b)
    assert n_boxes > 100, n_boxes
    assert NATIVE["pixellink_boxes"].calls == calls + 4


def test_decode_with_no_component():
    pix = np.zeros((16, 16, 2), np.float32)
    pix[..., 0] = 5.0  # background everywhere
    scores, boxes = mask_to_boxes(pix, np.zeros((16, 16, 16), np.float32), 64)
    assert scores.shape == (0,) and boxes.shape == (0, 4)


def _predictions(rng, n_img=8, n_det=80):
    """Ground truth (some images empty, one missing) and detections with
    tied scores, many near a gt box, some degenerate (zero width)."""
    gts = {}
    for i in range(n_img - 1):
        k = int(rng.integers(0, 4))
        xy = rng.integers(0, 400, (k, 2)).astype(np.float64)
        gts[i] = np.concatenate([xy, xy + rng.integers(10, 90, (k, 2))], 1)
    rows = []
    for _ in range(n_det):
        i = int(rng.integers(0, n_img))
        if len(gts.get(i, ())) and rng.random() < 0.7:
            box = gts[i][int(rng.integers(0, len(gts[i])))] + rng.integers(-8, 9, 4)
        else:
            xy = rng.integers(0, 400, 2)
            box = np.r_[xy, xy + rng.integers(0, 60, 2)]
        rows.append(np.r_[i, rng.choice([0.3, 0.5, 0.9]), box])
    return np.asarray(rows, np.float64), gts


@pytest.mark.parametrize("metric", ["iou", "iobb"])
def test_sweep_matches_numpy_and_jax(metric):
    rng = np.random.default_rng(11 if metric == "iou" else 12)
    calls = NATIVE["eval_sweep"].calls
    for trial in range(4):
        preds, gts = _predictions(rng)
        for thr in (0.3, 0.5, 0.7):
            tp, fp, npos = teval.sweep(preds, gts, thr, metric)
            tp_np, fp_np, npos_np = teval.sweep(preds, gts, thr, metric, impl="numpy")
            np.testing.assert_array_equal(tp, tp_np)
            np.testing.assert_array_equal(fp, fp_np)
            assert npos == npos_np and tp.sum() > 0 and fp.sum() > 0
            assert (teval.evaluate_detections(preds, gts, thr, metric)
                    == jeval.evaluate_detections(preds, gts, thr, metric))
    assert NATIVE["eval_sweep"].calls == calls + 4 * 3 * 2


def test_sweep_keeps_numpy_for_difficult_flags():
    """Difficult objects are ignored by the numpy loop, which the C++
    sweep does not run: no native call, and the JAX package's AP."""
    rng = np.random.default_rng(5)
    preds, gts = _predictions(rng)
    flags = {k: rng.random(len(v)) < 0.4 for k, v in gts.items()}
    calls = NATIVE["eval_sweep"].calls
    got = teval.evaluate_detections(preds, gts, 0.5, "iou", False, flags)
    assert got == jeval.evaluate_detections(preds, gts, 0.5, "iou", False, flags)
    assert NATIVE["eval_sweep"].calls == calls


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        mask_to_boxes(np.zeros((4, 4, 2), np.float32), np.zeros((4, 4, 16), np.float32),
                      impl="cv2")


def test_concurrent_builds_end_with_one_library(tmp_path):
    """Two processes build into one empty directory at once (as xdist
    workers can): both load a library, and one library file remains,
    with no temporary file left."""
    from gssd_torch.native import build

    # the build module alone, without the package (and torch) around it
    code = (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('build', {build.__file__!r})\n"
        "build = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(build)\n"
        f"build.BUILD_DIR = {str(tmp_path)!r}\n"
        "lib = build.load()\n"
        "print(build.library_path(), lib.pixellink_components is not None)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1 and all(out.split()[1] == "True" for out, _ in outs)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


def test_failed_build_raises(tmp_path, monkeypatch):
    from gssd_torch.native import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="native build failed"):
        build.build()
