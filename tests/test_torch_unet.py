"""The UNet liver-segmentation slice of the port against gssd_tpu's on the
CPU: the forward (transposed-conv and bilinear ups, an odd input side
whose skips are centre-cropped), the weighted pixel NLL with a validity
mask, one train-mode step's gradients, the bridge's transposed-conv
layout, and ``python -m gssd_torch.train_unet`` end to end with
``--resume``. Small: 64x64 (and 70x70) inputs, ``feature_scale`` 8
(widths 8 ... 128)."""

import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.models.unet import UNet as JaxUNet
from gssd_tpu.models.unet import segmentation_nll_loss as jax_nll
from gssd_torch.models.unet import UNet, segmentation_nll_loss
from gssd_torch.params import from_jax_variables, load_jax_variables, transposed_layers

FS = 8


def _variables(model, rng, size):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), train=False))

    def draw(path, s):
        leaf, shape = str(getattr(path[-1], "key", path[-1])), s.shape
        if leaf == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)  # biases, BN means

    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.tree_util.tree_map_with_path(draw, shapes))


def _pair(is_deconv, size, seed=0):
    jmodel = JaxUNet(n_classes=2, feature_scale=FS, is_deconv=is_deconv)
    variables = _variables(jmodel, np.random.default_rng(seed), size)
    model = UNet(n_classes=2, feature_scale=FS, is_deconv=is_deconv)
    load_jax_variables(model, variables)
    return jmodel, variables, model


@pytest.mark.parametrize("is_deconv,size", [(True, 64), (False, 64), (True, 70), (False, 70)])
def test_forward_matches_jax(is_deconv, size):
    """Eval mode, f32 both sides: within 1e-4 of max |ref| (only the
    summation order of the convolutions differs; 70 -> 35 -> 17 -> 8 -> 4
    makes three of the four skips drift and be cropped, at offsets 0 and
    1)."""
    jmodel, variables, model = _pair(is_deconv, size)
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    side = {64: 64, 70: 64}[size]  # 70: the last up gives 64, the skip is cropped to it
    assert got.shape == want.shape == (2, side, side, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_weighted_nll_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, 5, 2)).astype(np.float32)
    labels = (rng.uniform(size=(2, 6, 5)) > 0.6).astype(np.int32)
    valid = (rng.uniform(size=(2, 6, 5)) > 0.3).astype(np.float32)
    cw = np.asarray([0.3, 0.7], np.float32)
    for kw in ({}, {"class_weight": cw}, {"valid": valid}, {"class_weight": cw, "valid": valid}):
        want = float(jax_nll(jnp.asarray(logits), jnp.asarray(labels),
                             **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = float(segmentation_nll_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                          **{k: torch.from_numpy(v) for k, v in kw.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(list(kw)))
    # an all-masked batch: 0, not a division by zero
    zero = segmentation_nll_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 valid=torch.zeros(2, 6, 5))
    assert float(zero) == 0.0


@pytest.mark.parametrize("is_deconv", [True, False])
def test_train_step_gradients_match_jax(is_deconv):
    """One train-mode forward (batch statistics) and the trainer's
    balanced class-weighted loss at batch 2, 64x64: the loss within 1e-5
    relative, every gradient within 2e-2 of the largest entry of all and
    at cosine >= 0.999, the limits of tests/test_torch_train.py (f32, sums
    in another order; BatchNorm's batch statistics at batch 2 move single
    entries by ~3e-3 of that; conv biases in front of a train-mode
    BatchNorm, 0 in exact arithmetic, are held to the first limit only)."""
    jmodel, variables, model = _pair(is_deconv, 64, seed=3)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    y = (rng.uniform(size=(2, 64, 64)) > 0.7).astype(np.int32)
    fg = float(y.mean())
    cw = np.asarray([fg, 1 - fg], np.float32)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_nll(out, jnp.asarray(y), class_weight=jnp.asarray(cw))

    want, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want_g = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)},
        transposed_layers(model)).items()}
    model.train()
    loss = segmentation_nll_loss(model(torch.from_numpy(x)), torch.from_numpy(y),
                                 class_weight=torch.from_numpy(cw))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    top = max(np.abs(g).max() for g in want_g.values())
    for name, w in want_g.items():
        g = got_g[name]
        assert np.abs(g - w).max() <= 2e-2 * top, name
        if np.abs(w).max() > 1e-3 * top:
            cos = np.sum(g * w) / np.sqrt(np.sum(g * g) * np.sum(w * w))
            assert cos >= 0.999, (name, cos)


def test_bridge_flips_transposed_conv_kernels():
    """A lone flax ConvTranspose (2x2, stride 2, SAME, 3 -> 5 channels) at
    a kernel that is not symmetric under the spatial flip: the bridge's
    [in, out, kh, kw] layout with both spatial axes flipped gives torch's
    ConvTranspose2d the same output (to f32 rounding; without the flip
    it reads ~1 on these N(0, 1) inputs)."""
    rng = np.random.default_rng(5)
    kernel = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    assert np.abs(kernel - kernel[::-1, ::-1]).max() > 0.5
    x = rng.normal(size=(2, 7, 6, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = torch.nn.ConvTranspose2d(3, 5, 2, stride=2)

    mod = Holder()
    assert transposed_layers(mod) == ["up"]
    load_jax_variables(mod, {"params": {"up": {"kernel": kernel, "bias": bias}}})
    with torch.no_grad():
        got = mod.up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 14, 12, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    with torch.no_grad():
        wrong = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), unflipped, torch.from_numpy(bias),
            stride=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - want).max() > 0.5


def test_unet_trainer_cli_with_resume(tmp_path, capsys, monkeypatch):
    """``gssd_torch.train_unet`` on a tiny synthetic set, as
    tests/test_train_unet.py drives the JAX trainer: validation at 15 and
    30, a checkpoint each time, then ``--resume 30``, which restores every
    parameter, buffer and momentum bit for bit."""
    from gssd_torch import train_unet
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.train.checkpoint import restore_checkpoint
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.config import OptimConfig

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    make_synthetic_dataset(str(tmp_path / "ml"), num_subjects=4, slices_per_subject=2,
                           image_size=64)
    common = ["--datapath", str(tmp_path / "ml"), "--output", str(tmp_path / "out"),
              "--batch_size", "4", "--val_every", "15", "--feature_scale", "8",
              "--test_size", "0.25", "--device", "cpu"]
    res = train_unet.main(common + ["--max_iter", "31"])
    valid = res["valid"]
    assert np.isfinite(valid["loss"])
    assert 0.0 <= valid["pixel_acc"] <= 1.0 and 0.0 <= valid["fg_iou"] <= 1.0
    assert [e["iter"] for e in res["evals"]] == [15, 30] and res["step"] == 31
    assert len(res["records"]) == 31 and all(r["ms"] > 0 for r in res["records"])
    out = capsys.readouterr().out
    assert "6 train / 2 valid slices" in out and "iter 30 valid:" in out

    model = UNet(n_classes=2, feature_scale=8, seed=99)
    opt = make_optimizer(model, OptimConfig(lr=1e-4, momentum=0.8, stepvalues=()))
    step = restore_checkpoint(model, opt, str(tmp_path / "out" / "checkpoints"),
                              "unet_liverseg", 30)
    assert step == 31
    want = res["model"].state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    want_m = res["optimizer"].state_dict()["state"]
    assert all(torch.equal(st["momentum_buffer"], want_m[i]["momentum_buffer"])
               for i, st in opt.state_dict()["state"].items())

    res2 = train_unet.main(common + ["--max_iter", "33", "--resume", "30"])
    assert [r["iter"] for r in res2["records"]] == [30, 31, 32] and res2["step"] == 34
    assert np.isfinite(res2["valid"]["loss"])
    assert "resumed from iteration 30 (step 31)" in capsys.readouterr().out
