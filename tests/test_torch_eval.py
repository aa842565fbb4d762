"""The port's AP/IoBB evaluation (gssd_torch.eval.ap_iobb, numpy) against
gssd_tpu.eval.ap_iobb: ``voc_ap`` under both rules, ``evaluate_detections``
with and without difficult flags, and ``run_detection_eval`` over a small
synthetic set with one stub detector fed to both packages. The two run
the same float64 arithmetic in the same order, so results must be equal
(up to 1e-12 for the summed areas)."""

import numpy as np
import pytest

from gssd_tpu.data import BaseTransform as JaxBaseTransform
from gssd_tpu.data import LesionDataset as JaxLesionDataset
from gssd_tpu.eval import ap_iobb as jeval
from gssd_torch.data import BaseTransform, LesionDataset, make_synthetic_dataset
from gssd_torch.eval import ap_iobb as teval


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_matches_jax(rng, use_07):
    for n in (1, 7, 40):
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        assert teval.voc_ap(rec, prec, use_07) == pytest.approx(
            jeval.voc_ap(rec, prec, use_07), abs=1e-12)


def _scene(rng, n_img=6, n_det=60):
    gts, difficult = {}, {}
    for i in range(n_img):
        k = int(rng.integers(0, 4))  # some images have no lesion
        xy = rng.uniform(0, 400, (k, 2))
        wh = rng.uniform(20, 90, (k, 2))
        gts[i] = np.concatenate([xy, xy + wh], axis=1)
        difficult[i] = rng.uniform(size=k) < 0.3
    rows = []
    for _ in range(n_det):
        i = int(rng.integers(0, n_img))
        if len(gts[i]) and rng.uniform() < 0.7:  # near a lesion: jittered copy
            box = gts[i][int(rng.integers(0, len(gts[i])))] + rng.normal(0, 8, 4)
        else:
            xy = rng.uniform(0, 400, 2)
            box = np.concatenate([xy, xy + rng.uniform(10, 80, 2)])
        rows.append([i, rng.uniform(0.2, 1.0), *box])
    preds = np.asarray(rows)
    preds[5, 1] = preds[6, 1]  # one score tie: the stable sort decides
    return preds, gts, difficult


@pytest.mark.parametrize("metric", ["iou", "iobb"])
@pytest.mark.parametrize("use_07", [False, True])
def test_evaluate_detections_matches_jax(rng, metric, use_07):
    preds, gts, difficult = _scene(rng)
    for thr in (0.3, 0.5, 0.7):
        for flags in (None, difficult):
            want = jeval.evaluate_detections(preds, gts, thr, metric, use_07, flags)
            got = teval.evaluate_detections(preds, gts, thr, metric, use_07, flags)
            assert got == pytest.approx(want, abs=1e-12), (thr, flags is None)
    assert teval.evaluate_detections(np.zeros((0, 6)), gts, 0.5) == 0.0
    assert teval.evaluate_detections(preds, {0: np.zeros((0, 4))}, 0.5) == 0.0


def test_run_detection_eval_matches_jax(tmp_path):
    data = str(tmp_path / "ml")
    make_synthetic_dataset(data, num_subjects=7, slices_per_subject=1, image_size=64)
    ids = [f"synth{i:03d}_0" for i in range(7)]
    table = np.random.default_rng(3).uniform(0, 1, (7, 2, 10, 5))
    table[..., 3:] = table[..., 1:3] + 0.3 * table[..., 3:]  # x2, y2 past x1, y1
    calls = []

    def stub(batch):
        # detections of the k-th real image seen, whatever the batch; the
        # JAX package pads its last batch with zero images
        out = np.zeros((len(batch), 2, 10, 5))
        for b, img in enumerate(batch):
            if img.any():
                out[b] = table[len([c for c in calls if c])]
                calls.append(True)
        return out

    results = []
    for ds_cls, tf_cls, mod in ((JaxLesionDataset, JaxBaseTransform, jeval),
                                (LesionDataset, BaseTransform, teval)):
        calls.clear()
        sink = {}
        res = mod.run_detection_eval(stub, ds_cls(data, ids), tf_cls(64), (0.3, 0.5, 0.7),
                                     (0.3, 0.5), 0.2, False, 3, score_sink=sink)
        results.append((res, sink))
        assert len(calls) == 7
    (want, want_sink), (got, got_sink) = results
    assert set(got) == {"ap30", "ap50", "ap70", "iobb30", "iobb50"}
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert any(v > 0 for v in got.values())
    for key in ("raw", "filtered"):
        np.testing.assert_array_equal(got_sink[key], want_sink[key])

    # the PixelLink path: logit maps decoded on the host, as gssd_tpu does
    # (the maps hold one rectangle per image, so the boxes agree exactly)
    maps = []
    for k in range(7):
        pix = np.full((16, 16, 2), [4.0, -4.0])
        lnk = np.tile([4.0, -4.0], (16, 16, 8))
        y, x = 2 + k, 3 + (k % 4)
        pix[y:y + 6, x:x + 5] = [-4.0, 4.0 - 0.3 * k]
        lnk[y:y + 6, x:x + 5] = np.tile([-4.0, 4.0], 8)
        maps.append((pix.astype(np.float32), lnk.astype(np.float32)))

    def forward(batch):
        pix, lnk = [], []
        for img in batch:
            if img.any():
                p, q = maps[len(calls)]
                calls.append(True)
            else:
                p, q = maps[0]
            pix.append(p)
            lnk.append(q)
        return np.stack(pix), np.stack(lnk)

    results = []
    for ds_cls, tf_cls, mod in ((JaxLesionDataset, JaxBaseTransform, jeval),
                                (LesionDataset, BaseTransform, teval)):
        calls.clear()
        results.append(mod.run_detection_eval(
            forward, ds_cls(data, ids), tf_cls(64), (0.3, 0.5), (0.3,), 0.2, False, 3,
            use_pixel_link=True, img_size=64))
        assert len(calls) == 7
    want, got = results
    assert set(got) == {"ap30", "ap50", "iobb30"}
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
