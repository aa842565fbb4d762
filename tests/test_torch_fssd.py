"""The FSSD family (fssd, groupfssd, fusedssd) of the port against
gssd_tpu's on the CPU: the eval-mode forward, the priors, one train-mode
step's MultiBox loss and gradients, the trainer and serving CLIs with
--ssd_type fusedssd, and the wide-conv switch at the trunk's stem.

The models run at their only input size, 300x300x12 (FSSD's six sources
are the 300 pyramid, 38 ... 1), and at ``feature_scale`` 1: in the SSD
family it multiplies the widths, so 1 is the narrowest model. Variables
come from ``jax.eval_shape`` plus seeded numpy, with positive BN
variances, and load through ``gssd_torch.params`` strictly.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.config import LossConfig as JaxLossConfig
from gssd_tpu.config import ModelConfig as JaxModelConfig
from gssd_tpu.models import build_model as jax_build_model
from gssd_tpu.ops.losses import multibox_loss as jax_multibox_loss
from gssd_torch.config import LossConfig, ModelConfig
from gssd_torch.models import build_model
from gssd_torch.ops import layers
from gssd_torch.ops.losses import multibox_loss
from gssd_torch.params import load_jax_variables

TYPES = ("fssd", "groupfssd", "fusedssd")
BASE = dict(batch_norm=True, use_fuseconv=True, compute_dtype="float32")


def _seeded_variables(model, rng):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 12)), train=False))

    def draw(path, s):
        leaf, shape = str(getattr(path[-1], "key", path[-1])), s.shape
        if leaf == "kernel":  # conv [kh, kw, in, out], transposed conv alike
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        if leaf == "weight":  # L2Norm
            return rng.uniform(8, 22, shape)
        return rng.normal(0, 0.1, shape)  # biases, BN means

    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.tree_util.tree_map_with_path(draw, shapes))


@pytest.fixture(scope="module", params=TYPES)
def pair(request):
    """(ssd_type, JAX model, its priors, seeded variables, the port's
    model with them loaded, its priors)."""
    t = request.param
    jmodel, jpriors = jax_build_model(JaxModelConfig(ssd_type=t, **BASE))
    variables = _seeded_variables(jmodel, np.random.default_rng(TYPES.index(t)))
    model, priors = build_model(ModelConfig(ssd_type=t, **BASE), device="cpu")
    load_jax_variables(model, variables)
    return t, jmodel, np.asarray(jpriors), variables, model, priors


def _batch(rng, n):
    x = rng.uniform(0, 1, (n, 300, 300, 12)).astype(np.float32)
    boxes = np.zeros((n, 16, 4), np.float32)
    boxes[:, 0] = [0.30, 0.35, 0.45, 0.52]
    boxes[:, 1] = [0.55, 0.40, 0.62, 0.47]
    labels = np.zeros((n, 16), np.int32)
    valid = np.zeros((n, 16), bool)
    valid[:, :2] = True
    return {"image": x, "boxes": boxes, "labels": labels, "valid": valid}


def test_forward_and_priors_match_jax(pair):
    t, jmodel, jpriors, variables, model, priors = pair
    x = np.random.default_rng(0).uniform(0, 1, (1, 300, 300, 12)).astype(np.float32)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert priors.shape == jpriors.shape == (8732, 4)
    np.testing.assert_array_equal(priors, jpriors)
    assert got["loc"].shape == (1, 8732, 4) and got["conf"].shape == (1, 8732, 2)
    # f32 on both sides; only the convolutions' summation order differs
    # (the JAX package's block-diagonal grouped lowering too), as in
    # tests/test_torch_ssd.py
    for name in ("loc", "conf"):
        ref = np.asarray(want[name])
        err = np.abs(got[name].numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (t, name, err, np.abs(ref).max())


def test_train_step_loss_and_grads_match_jax(pair):
    """One train-mode forward (batch statistics) + MultiBox loss at batch
    2 and its gradients, against ``jax.value_and_grad``. Limits: the loss
    within 1e-4 relative; every parameter's gradient within 2e-2 of the
    largest gradient entry of all parameters, and at cosine >= 0.999
    where its gradient stands above 1e-3 of that (f32 in both, sums in
    another order through ~30 layers and back; a conv bias in front of a
    train-mode BatchNorm has a gradient that is 0 in exact arithmetic)."""
    t, jmodel, jpriors, variables, model, priors = pair
    batch = _batch(np.random.default_rng(5), 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, **rest}, jb["image"], train=True,
                              mutable=["batch_stats"])
        loss_l, loss_c, _ = jax_multibox_loss(out["loc"], out["conf"], jnp.asarray(jpriors),
                                              jb["boxes"], jb["labels"], jb["valid"],
                                              JaxLossConfig())
        return loss_l + loss_c

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])

    from gssd_torch.params import from_jax_variables, transposed_layers

    want_g = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)},
        transposed_layers(model)).items()}
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["image"])
    loss_l, loss_c, aux = multibox_loss(out["loc"], out["conf"], torch.from_numpy(priors),
                                        tb["boxes"], tb["labels"], tb["valid"], LossConfig())
    model.zero_grad(set_to_none=True)
    (loss_l + loss_c).backward()
    model.eval()
    assert int(aux["num_pos"]) > 0
    np.testing.assert_allclose(float(loss_l + loss_c), float(want), rtol=1e-4)

    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    top = max(np.abs(g).max() for g in want_g.values())
    for name, w in want_g.items():
        g = got_g[name]
        err = np.abs(g - w).max()
        assert err <= 2e-2 * top, (t, name, err / top)
        if np.abs(w).max() > 1e-3 * top:
            cos = np.sum(g * w) / np.sqrt(np.sum(g * g) * np.sum(w * w))
            assert cos >= 0.999, (t, name, cos)


def test_fssd_groups_and_bridge_names():
    """'fssd' is ungrouped (conv9_1 sees all 768 fused channels), 'groupfssd'
    keeps the configured groups; the bridge maps bn_fused and FusedSSD's
    transposed conv (a missing or surplus key raises)."""
    fssd, _ = build_model(ModelConfig(ssd_type="fssd", **BASE), device="cpu")
    group, _ = build_model(ModelConfig(ssd_type="groupfssd", **BASE), device="cpu")
    fused, _ = build_model(ModelConfig(ssd_type="fusedssd", **BASE), device="cpu")
    assert fssd.conv9_1.conv.weight.shape == (512, 768, 3, 3)
    assert group.conv9_1.conv.weight.shape == (512, 192, 3, 3)
    assert fssd.trunk.vgg_1.conv.groups == 1 and group.trunk.vgg_1.conv.groups == 4
    assert "bn_fused.running_var" in fssd.state_dict()
    assert isinstance(fused.fuse_deconv_53, torch.nn.ConvTranspose2d)
    with pytest.raises(ValueError, match="300 pyramid"):
        build_model(ModelConfig(ssd_type="fssd", size=512, **BASE), device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(fused, {"params": {"fuse_deconv_53": {
            "kernel": np.zeros((2, 2, 512, 512), np.float32),
            "bias": np.zeros(512, np.float32)}}})


def test_stem_sites_take_the_wide_conv_switch(monkeypatch):
    """With USE_WIDE_CONV_KERNEL on, the FSSD trunk's conv1_1 and conv1_2
    pass ``ConvBNRelu.wide`` and run through ``stem_conv`` (its plain
    version on the CPU), while the SSD's W-pair packed stem (bf16) keeps
    the plain conv; no other site of either model is a stem site."""
    from gssd_torch.ops.kernels import stem_conv as sc

    calls = []
    real = sc.StemConv.apply
    monkeypatch.setattr(sc.StemConv, "apply",
                        lambda x, w, b, g: calls.append((x.shape[1], w.shape[0], g))
                        or real(x, w, b, g))
    monkeypatch.setattr(layers, "USE_WIDE_CONV_KERNEL", True)
    x = torch.rand(1, 300, 300, 12)
    for t, groups in (("fssd", 1), ("groupfssd", 4), ("fusedssd", 4)):
        model, _ = build_model(ModelConfig(ssd_type=t, **BASE), device="cpu")
        assert model.trunk.vgg_1.wide(torch.empty(1, 12, 300, 300))
        assert model.trunk.vgg_2.wide(torch.empty(1, 64, 300, 300))
        calls.clear()
        with torch.inference_mode():
            model.eval()(x)
        assert calls == [(12, 64, groups), (64, 64, groups)], (t, calls)
    ssd, _ = build_model(ModelConfig(ssd_type="gssd", batch_norm=True,
                                     compute_dtype="bfloat16"), device="cpu")

    class StemDone(Exception):
        pass

    def stop(*_):
        raise StemDone

    ssd.vgg_2.register_forward_hook(stop)  # the stem is all this part checks
    calls.clear()
    with torch.inference_mode(), pytest.raises(StemDone):
        ssd.eval()(x)
    assert calls == []


@pytest.mark.parametrize("B,Cin,G,H", [(2, 64, 1, 40), (3, 12, 1, 33), (2, 64, 4, 40)])
def test_plain_stem_dw_against_f64(B, Cin, G, H):
    """The plain version of the stem backward's dW (``stem_conv_dw_plain``:
    f32 products of the unfolded bf16 patches and bf16 g, in chunks of
    images) at the FSSD trunk's channels, within 1e-6 of max |dW| of the
    same sum in f64 (the card's readings at batch 32: 3.5e-7 to 5.7e-7)."""
    from gssd_torch.ops.kernels import stem_conv as sc

    rng = np.random.default_rng(B * Cin + G)
    x = torch.from_numpy(rng.uniform(0, 1, (B, Cin, H, H + 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, 64, H, H + 5)).astype(np.float32))
    w = torch.zeros(64, Cin // G, 3, 3)
    _, dw = sc.stem_conv_bwd_plain(x.bfloat16(), w, g.bfloat16(), G, need_dx=False)
    dw64 = torch.nn.grad.conv2d_weight(x.bfloat16().double(), tuple(w.shape),
                                       g.bfloat16().double(), padding=1, groups=G)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert ((dw.double() - dw64).abs().max() / dw64.abs().max()).item() <= 1e-6


def test_trainer_then_serving_cli_fusedssd(tmp_path, capsys, monkeypatch):
    from gssd_torch import infer
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.train import main

    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    out = tmp_path / "run"
    # text logs only (a TensorBoard import can pull in TensorFlow)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    common = ["--ssd_type", "fusedssd", "--datapath", str(data), "--num_test_subjects", "1",
              "--compute_dtype", "float32", "--device", "cpu", "--output", str(out),
              "--model_name", "fused"]
    res = main(common + ["--batch_size", "2", "--max_iter", "2", "--val_every", "1",
                         "--speedrun", "0"])
    assert [r["iter"] for r in res["records"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    keys = {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}
    assert [e["iter"] for e in res["evals"]] == [1]
    assert set(res["evals"][0]["test"]) == keys
    assert all(0.0 <= v <= 1.0 for v in res["evals"][0]["test"].values())
    weights = out / "checkpoints" / "fused" / "fused_1_CV0.pt"
    assert res["weights"] == str(weights) and weights.exists()
    capsys.readouterr()

    det_path = tmp_path / "dets.json"
    served = infer.main(["--ssd_type", "fusedssd", "--datapath", str(data),
                         "--num_test_subjects", "1", "--compute_dtype", "float32",
                         "--device", "cpu", "--weights", str(weights), "--eval_batch", "1",
                         "--det_output", str(det_path)])
    assert len(served["detections"]) == 1 and det_path.exists()
