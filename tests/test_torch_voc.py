"""The VOC SSD300 slice of the port against gssd_tpu, on a synthetic
VOCdevkit tree (``write_voc_tree``: cv2 JPEGs and XML, as
tests/test_voc.py writes one):
annotation parsing, dataset items and collate (equal), ``run_voc_map``
with one numpy detector fed to both packages, difficult objects included
(equal), the vanilla 3-channel 21-class SSD300 through the param bridge
(f32 on both sides: loc and conf within 1e-3 of their max, the tolerance
of tests/test_torch_ssd.py's forward test), and ``python -m
gssd_torch.train_voc`` end to end with a mini detector at 64 x 64
(training, mAP, checkpoints, ``--resume``, ``--test --checkpoint``)."""

import os
import sys
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_folds import MiniTwin, _Stage

from gssd_tpu.config import ModelConfig as JaxModelConfig
from gssd_tpu.data.dataset import collate as jax_collate
from gssd_tpu.data.transforms import BaseTransform as JaxBaseTransform
from gssd_tpu.data.voc import VOCDataset as JaxVOCDataset
from gssd_tpu.data.voc import parse_voc_annotation as jax_parse
from gssd_tpu.eval.voc_map import run_voc_map as jax_run_voc_map
from gssd_tpu.models import build_model as jax_build_model
from gssd_torch.data import BaseTransform, collate
from gssd_torch.data.voc import VOC_CLASSES, VOCDataset, parse_voc_annotation, write_voc_tree
from gssd_torch.eval.voc_map import run_voc_map
from gssd_torch.models import build_model
from gssd_torch.params import load_jax_variables

# (class, (xmin, ymin, xmax, ymax) 1-based, difficult) per image; every
# image has an object that is not difficult
OBJECTS = {
    "img0": [("dog", (48, 23, 120, 90), 0), ("cat", (10, 10, 40, 60), 0)],
    "img1": [("person", (5, 8, 60, 100), 1), ("dog", (70, 30, 150, 120), 0)],
    "img2": [("cat", (20, 40, 90, 110), 0), ("cat", (95, 5, 155, 70), 1)],
    "img3": [("person", (30, 20, 100, 125), 0)],
}


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_voc_tree(str(root), OBJECTS)
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"keep_difficult": True}, {"return_difficult": True}])
def test_parse_annotation_matches_jax(voc_root, kw):
    for name in OBJECTS:
        root = ET.parse(os.path.join(voc_root, "VOC2007", "Annotations", name + ".xml")).getroot()
        got, want = parse_voc_annotation(root, 160.0, 128.0, **kw), jax_parse(root, 160.0, 128.0,
                                                                               **kw)
        for a, b in (zip(got, want) if kw.get("return_difficult") else [(got, want)]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert VOC_CLASSES.index("dog") == 11 and len(VOC_CLASSES) == 20


def test_dataset_items_and_collate_match_jax(voc_root):
    sets = [("2007", "trainval")]
    for keep in (False, True):
        ds = VOCDataset(voc_root, sets, BaseTransform(64, use_normalize=False), keep)
        jds = JaxVOCDataset(voc_root, sets, JaxBaseTransform(64, use_normalize=False), keep)
        assert len(ds) == len(jds) == len(OBJECTS)
        for i in range(len(ds)):
            for a, b in zip(ds[i], jds[i]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ds.pull_image(i), jds.pull_image(i))
            for a, b in zip(ds.pull_anno_with_difficult(i), jds.pull_anno_with_difficult(i)):
                np.testing.assert_array_equal(a, b)
        got = collate([ds[i] for i in range(len(ds))], max_gt=8)
        want = jax_collate([jds[i] for i in range(len(jds))], max_gt=8)
        assert got["image"].shape == (4, 64, 64, 3)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def _detector(num_classes=21, k=6):
    """A numpy detector: for each image of a batch, ``k`` boxes a class
    drawn from a generator seeded by the image's content, so that both
    packages see the same detections for the same image."""

    def infer(batch):
        out = np.zeros((len(batch), num_classes, k, 5), np.float32)
        for b, img in enumerate(batch):
            rng = np.random.default_rng(int(np.abs(img).sum() * 1000) % 2**32)
            xy = rng.uniform(0, 0.6, (num_classes, k, 2))
            out[b, :, :, 0] = rng.choice([0.005, 0.3, 0.6, 0.9], (num_classes, k))
            out[b, :, :, 1:3] = xy
            out[b, :, :, 3:5] = xy + rng.uniform(0.1, 0.4, (num_classes, k, 2))
        return out

    return infer


@pytest.mark.parametrize("use_07", [True, False])
def test_run_voc_map_matches_jax(voc_root, use_07):
    sets = [("2007", "trainval")]
    got = run_voc_map(_detector(), VOCDataset(voc_root, sets), BaseTransform(64, 114.0),
                      use_07_metric=use_07, batch_size=3)
    want = jax_run_voc_map(_detector(), JaxVOCDataset(voc_root, sets),
                           JaxBaseTransform(64, 114.0), use_07_metric=use_07, batch_size=3)
    assert got == want
    assert set(got) == {"map", "ap_dog", "ap_cat", "ap_person"}
    assert 0.0 <= got["map"] <= 1.0


def test_vanilla_ssd300_through_the_bridge_matches_jax():
    cfg = dict(ssd_type="ssd", num_phases=1, slices_per_phase=3, num_classes=21,
               batch_norm=False, compute_dtype="float32")
    jmodel, jpriors = jax_build_model(JaxModelConfig(**cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 300, 300, 3)), train=False))
    rng = np.random.default_rng(2)

    def draw(path, s):
        if len(s.shape) == 4:  # conv kernels, He-scaled: no BatchNorm here
            return rng.normal(0, np.sqrt(2 / np.prod(s.shape[:3])), s.shape)
        if str(getattr(path[-1], "key", path[-1])) == "weight":  # l2norm
            return rng.uniform(15, 25, s.shape)
        return rng.normal(0, 0.1, s.shape)  # biases

    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       jax.tree_util.tree_map_with_path(draw, shapes))
    x = rng.uniform(-114, 141, (1, 300, 300, 3)).astype(np.float32)
    want = jax.jit(lambda v, images: jmodel.apply(v, images, train=False))(variables,
                                                                           jnp.asarray(x))
    from gssd_torch.config import ModelConfig

    model, priors = build_model(ModelConfig(**cfg), device="cpu")
    load_jax_variables(model, variables)  # strict: every key and shape
    assert not any(".bn." in name for name in model.state_dict())
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(priors, np.asarray(jpriors), rtol=0, atol=1e-7)
    assert got["loc"].shape == (1, 8732, 4) and got["conf"].shape == (1, 8732, 21)
    for key in ("loc", "conf"):
        ref = np.asarray(want[key])
        err = np.abs(got[key].numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (key, err, np.abs(ref).max())


class _MiniVOC(MiniTwin):
    """The mini detector on 3 input channels (its MINI_ANCHORS at 64)."""

    def __init__(self, num_classes):
        super().__init__(num_classes)
        self.s0 = _Stage(3, 8, 2, True)


@pytest.fixture
def mini_voc(monkeypatch):
    import gssd_torch.models as models_pkg
    from mini_model import MINI_ANCHORS

    from gssd_torch.ops.anchors import make_anchors

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(models_pkg, "build_model", lambda cfg, device, seed: (
        _MiniVOC(cfg.num_classes), make_anchors(MINI_ANCHORS)))


def _voc_cli(root, out, *extra):
    from gssd_torch import train_voc

    return train_voc.main(["--voc_root", root, "--eval_sets", "2007:trainval", "--ssd_dim",
                           "64", "--batch_size", "2", "--max_gt", "8", "--eval_batch", "2",
                           "--compute_dtype", "float32", "--device", "cpu", "--output",
                           str(out), *extra])


def test_trainer_end_to_end(voc_root, tmp_path, mini_voc, capsys):
    """13 steps with an evaluation and a checkpoint at 6 and at 12; the
    checkpoint restored by --test gives the run's mAP; --resume 6
    continues at the stored step."""
    from gssd_torch.train.checkpoint import checkpoint_path

    res = _voc_cli(voc_root, tmp_path, "--max_iter", "13", "--val_every", "6")
    assert [e["iter"] for e in res["evals"]] == [6, 12] and res["step"] == 13
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    assert {"ap_dog", "ap_cat", "ap_person"} <= set(res["voc_map"])
    assert 0.0 <= res["voc_map"]["map"] <= 1.0
    assert os.path.exists(checkpoint_path(str(tmp_path / "checkpoints"), "ssd300_voc", 12))
    assert "VOC mAP" in capsys.readouterr().out
    tested = _voc_cli(voc_root, tmp_path, "--test", "True", "--checkpoint", "12")
    assert tested["voc_map"] == res["voc_map"]
    resumed = _voc_cli(voc_root, tmp_path, "--max_iter", "8", "--val_every", "100",
                       "--resume", "6")
    assert [r["iter"] for r in resumed["records"]] == [6, 7] and resumed["step"] == 9
    assert "restored iteration 6 (step 7)" in capsys.readouterr().out


def test_trainer_raises_on_a_box_free_image(tmp_path, mini_voc):
    """An image whose only object is difficult has no box to train on; the
    random crop cannot run on it (in the JAX package too). The port's
    loader raises that error instead of waiting on it."""
    write_voc_tree(str(tmp_path), {"img0": OBJECTS["img0"],
                                   "img1": [("person", (5, 8, 60, 100), 1)]})
    with pytest.raises(RuntimeError, match="building a batch failed"):
        _voc_cli(str(tmp_path), tmp_path / "out", "--max_iter", "40", "--val_every", "100")


def test_trainer_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    from gssd_torch import train_voc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_voc.main(["--voc_root", str(tmp_path), "--output", str(tmp_path)])
