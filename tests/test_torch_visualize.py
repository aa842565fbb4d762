"""The --visualize path of the port against gssd_tpu: the drawing
functions and the dump files bit for bit (both sides draw with the same
OpenCV), and the aux steps. PixelLink++ (4s at 32 x 32, f32, bridged
weights) is held against the JAX package's
``make_pixellink_forward_with_aux``: logits, DCN offsets and attention
maps within 1e-4 of their max, the tolerance of the forward test in
tests/test_torch_pixellink.py (f32 on both sides, another summation
order). GSSD++ runs only at 300 x 300, whose JAX forward costs ~25 s
here; its maps are held against JAX in
tests/test_torch_ssd.py::test_full_width_forward_matches_jax, and here
the port's aux step is held to the forward it wraps."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pixellink import PLUSPLUS
from test_torch_pixellink import _seeded_variables as _seeded_pixellink

from gssd_tpu.config import PixelLinkConfig as JaxPixelLinkConfig
from gssd_tpu.models.pixellink import PixelLink as JaxPixelLink
from gssd_tpu.train.steps import make_pixellink_forward_with_aux as jax_forward_with_aux
from gssd_tpu.utils import visualize as jvis
from gssd_torch.config import DetectConfig, ModelConfig, PixelLinkConfig
from gssd_torch.models import build_model
from gssd_torch.models.pixellink import PixelLink
from gssd_torch.params import load_jax_variables
from gssd_torch.train.steps import (make_infer_step, make_infer_step_with_aux,
                                    make_pixellink_forward_with_aux)
from gssd_torch.utils import visualize as tvis


def _scene(rng, size=96):
    image = rng.uniform(0, 1, (size, size, 12)).astype(np.float32)
    gt = np.array([[10.0, 12, 40, 44], [50, 60, 90, 88]])
    det = np.zeros((2, 50, 5), np.float32)
    det[1, :4, 0] = [0.9, 0.6, 0.1, 0.3]
    det[1, :4, 1:] = rng.uniform(0, 0.5, (4, 4)) + [0, 0, 0.4, 0.4]
    offsets = [rng.normal(0, 2, (12, 12, 4, 9, 2)).astype(np.float32)]
    attn = [rng.uniform(0, 1, (144, 144)).astype(np.float32)]
    return image, gt, det, offsets, attn


def test_drawing_matches_jax():
    rng = np.random.default_rng(0)
    image, gt, det, offsets, _ = _scene(rng)
    scores = np.array([0.91, 0.35])
    for args in ((image[..., 7], gt), (image[..., :3], gt, (255, 0, 0), scores)):
        np.testing.assert_array_equal(tvis.draw_boxes(*args), jvis.draw_boxes(*args))
    np.testing.assert_array_equal(tvis.offsets_to_image_coords(offsets[0], 96),
                                  jvis.offsets_to_image_coords(offsets[0], 96))
    for group in (0, 3):
        np.testing.assert_array_equal(tvis.draw_offsets(image[..., 7], offsets[0], 96, group),
                                      jvis.draw_offsets(image[..., 7], offsets[0], 96, group))
    batch = rng.uniform(0, 1, (5, 32, 32, 12)).astype(np.float32)
    boxes = rng.uniform(0, 0.5, (5, 3, 4)) + [0, 0, 0.4, 0.4]
    valid = rng.random((5, 3)) < 0.7
    got = tvis.input_grid_with_boxes(batch, boxes, valid)
    assert got.shape == (32, 128, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jvis.input_grid_with_boxes(batch, boxes, valid))


@pytest.mark.parametrize("with_aux", [True, False])
def test_dump_files_match_jax(tmp_path, with_aux):
    """The same file names, equal arrays and the same JPEG bytes; the
    names are those ``dump_names`` lists."""
    image, gt, det, offsets, attn = _scene(np.random.default_rng(1))
    aux = dict(offsets=offsets, attn=attn, attn_base=attn) if with_aux else {}
    for vis, out in ((tvis, tmp_path / "torch"), (jvis, tmp_path / "jax")):
        vis.dump_eval_visuals(str(out), 7, image, gt, det, conf_threshold=0.2,
                              image_size=96, **aux)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(tvis.dump_names(7, with_aux, with_aux, with_aux))
    for name in names:
        a, b = tmp_path / "torch" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert a.read_bytes() == b.read_bytes(), name


class _State:
    """What the JAX forward reads of a TrainState: its variables."""

    def __init__(self, variables):
        self._variables = variables

    def variables(self):
        return self._variables


def test_pixellink_aux_forward_matches_jax():
    rng = np.random.default_rng(3)
    jmodel = JaxPixelLink(JaxPixelLinkConfig(**PLUSPLUS), dtype=jnp.float32, dcn_impl="xla")
    x = rng.uniform(0, 1, (2, 32, 32, 12)).astype(np.float32)
    variables = _seeded_pixellink(jmodel, x, rng)
    forward = jax.jit(lambda v, images: jax_forward_with_aux(jmodel)(_State(v), images))
    want_pix, want_lnk, want_aux = forward(variables, jnp.asarray(x))
    model = PixelLink(PixelLinkConfig(**PLUSPLUS), False, True, "float32", "xla")
    load_jax_variables(model, variables)
    pix, lnk, aux = make_pixellink_forward_with_aux(model, torch.device("cpu"))(x)

    assert sorted(aux) == sorted(want_aux) == ["attn", "attn_base", "offsets"]
    pairs = [("pixel", pix, want_pix), ("link", lnk, want_lnk)]
    for key in aux:
        assert len(aux[key]) == len(want_aux[key]) and len(aux[key]) >= 1
        pairs += [(f"{key}[{i}]", a.numpy(), b) for i, (a, b) in
                  enumerate(zip(aux[key], want_aux[key]))]
    assert aux["offsets"][0].shape == (2, 8, 8, 4, 9, 2)
    assert aux["attn"][0].shape == (2, 64, 64)  # conv3_3's 8 x 8 tokens
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape, name
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_gssd_aux_step_returns_its_forward():
    """GSSD++ at 300 (f32, random weights): the aux step's detections are
    the inference step's, bit for bit, and its maps those of the forward
    with ``return_attn``: 6 + 6 attention sites, one DCN layer."""
    cfg = ModelConfig(ssd_type="gssd", use_self_attention=True, use_self_attention_base=True,
                      num_dcn_layers=1, groups_dcn=4, dcn_cat_sab=True,
                      compute_dtype="float32", dcn_impl="xla")
    model, priors = build_model(cfg, device="cpu", seed=5)
    priors = torch.tensor(priors)
    x = np.random.default_rng(4).uniform(0, 1, (1, 300, 300, 12)).astype(np.float32)
    det, aux = make_infer_step_with_aux(model, priors, DetectConfig())(x)
    assert torch.equal(det, make_infer_step(model, priors, DetectConfig())(x))
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x), return_attn=True)
    assert [len(aux[k]) for k in ("offsets", "attn", "attn_base")] == [1, 6, 6]
    for key, maps in aux.items():
        for got, want in zip(maps, out[key]):
            assert torch.equal(got, want), key
    assert aux["offsets"][0].shape == (1, 38, 38, 4, 9, 2)
    assert aux["attn"][0].shape == (1, 1444, 1444)
    assert torch.allclose(aux["attn"][0].sum(-1), torch.ones(1, 1444), atol=1e-5)


class _Board:
    """What ``MetricsLogger`` calls of a TensorBoard writer, recorded."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, image, step):
        self.images.append((tag, image, step))


def test_input_grid_goes_to_tensorboard(tmp_path, monkeypatch):
    """The trainer's input grid every 100 iterations: fold 0's batch (a
    bf16 image as a bf16 model's batch carries it) drawn as the JAX
    function draws it, logged as a [3, H, W * n] image."""
    from gssd_torch.train.trainer import log_input_grid
    from gssd_torch.utils.logging import MetricsLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~15 s to import
    rng = np.random.default_rng(6)
    batch = {"image": torch.from_numpy(rng.uniform(0, 1, (3, 32, 32, 12))).to(torch.bfloat16),
             "boxes": torch.from_numpy(rng.uniform(0, 0.5, (3, 2, 4)) + [0, 0, 0.4, 0.4]),
             "valid": torch.from_numpy(rng.random((3, 2)) < 0.8)}
    logger = MetricsLogger(str(tmp_path))
    logger.tb = _Board()
    log_input_grid(logger, 200, batch)
    ((tag, image, step),) = logger.tb.images
    want = jvis.input_grid_with_boxes(batch["image"].float().numpy(), batch["boxes"].numpy(),
                                      batch["valid"].numpy())
    assert tag == "inputs/train_fold0" and step == 200 and image.shape == (3, 32, 96)
    np.testing.assert_array_equal(image, np.transpose(want, (2, 0, 1)))
    logger.tb = None
    log_input_grid(logger, 300, batch)  # no TensorBoard: nothing to do
