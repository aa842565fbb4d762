"""The PixelLink++ slice of the port against gssd_tpu: the model's logits
(4s, 2s, cascade_fuse; 4s with the wide-conv switch on in both), the
bf16 upsampling, targets, loss and decode (also against the reference
goldens in tests/goldens/reference_pixellink.npz) and one training step
with and without attention remat. Inputs come from numpy seeds; each
check states its tolerance.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.config import PixelLinkConfig as JaxPixelLinkConfig
from gssd_tpu.data.pixellink_targets import make_pixel_link_targets as jax_targets
from gssd_tpu.eval.pixellink_decode import mask_to_boxes as jax_mask_to_boxes
from gssd_tpu.models.pixellink import PixelLink as JaxPixelLink
from gssd_tpu.models.pixellink import upsample_bilinear_ac as jax_upsample
from gssd_tpu.ops import layers as jl
from gssd_tpu.ops import pixellink_loss as jloss
from gssd_tpu.train.state import TrainState, make_optimizer as jax_make_optimizer
from gssd_tpu.train.steps import make_pixellink_train_step
from gssd_torch.config import OptimConfig, PixelLinkConfig
from gssd_torch.data.pixellink_targets import make_pixel_link_targets
from gssd_torch.eval.pixellink_decode import mask_to_boxes
from gssd_torch.models.pixellink import PixelLink, upsample_bilinear_ac
from gssd_torch.ops import layers as tl
from gssd_torch.ops.pixellink_loss import link_loss, pixel_loss
from gssd_torch.params import from_jax_variables, load_jax_variables
from gssd_torch.train import make_optimizer
from gssd_torch.train.steps import pixellink_train_step

PLUSPLUS = dict(use_self_attention=True, use_self_attention_base=True, num_dcn_layers=1,
                groups_dcn=4, dcn_cat_sab=True)
BOX_SETS = ["two", "overlap", "border", "single", "touching"]


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "reference_pixellink.npz"))


def _seeded_variables(model, x, rng):
    """flax variables from eval_shape plus seeded numpy: He-scaled convs
    (the trunk has no BatchNorm), positive BN variances, sigma 0.5 and
    the spectral vectors at the top singular pair, so that every path
    contributes and nothing explodes."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                               train=False))

    def draw(path, s):
        leaf, shape = str(getattr(path[-1], "key", path[-1])), s.shape
        if leaf == "kernel" and len(shape) == 4:
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[2])), shape)
        if leaf == "kernel":
            return rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        if leaf == "weight" and len(shape) == 3:  # DCN [K, C, Cout]
            b = 1 / np.sqrt(shape[0] * shape[1])
            return rng.uniform(-b, b, shape)
        if leaf in ("u", "v"):
            return np.zeros(shape)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        if leaf == "sigma":
            return np.full(shape, 0.5)
        return rng.normal(0, 0.1, shape)  # biases, BN means

    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jax.tree_util.tree_map_with_path(draw, shapes))
    for attn, sub in v["spectral"].items():
        for name, uv in sub.items():
            u, _, vt = np.linalg.svd(v["params"][attn][name]["kernel"].T, full_matrices=False)
            uv["u"], uv["v"] = u[:, 0].copy(), vt[0].copy()
    return v


class _TpuBackend:
    """The ``jax`` name gssd_tpu.ops.layers sees, reporting a TPU backend
    so that its wide-conv gate opens; stem_conv's own ``jax`` still sees
    the CPU and runs the kernel in interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.mark.parametrize("version,cascade,size,wide", [
    ("4s", False, 72, True), ("2s", False, 32, False), ("4s", True, 32, False)],
    ids=["4s_72_wide_conv", "2s_32", "4s_cascade_32"])
def test_forward_matches_jax(monkeypatch, version, cascade, size, wide):
    rng = np.random.default_rng(3)
    kw = dict(PLUSPLUS, version=version)
    jmodel = JaxPixelLink(JaxPixelLinkConfig(**kw), cascade_fuse=cascade, dtype=jnp.float32,
                          dcn_impl="xla")
    x = rng.uniform(0, 1, (2, size, size, 12)).astype(np.float32)
    variables = _seeded_variables(jmodel, x, rng)
    model = PixelLink(PixelLinkConfig(**kw), cascade, True, "float32", "xla").eval()
    load_jax_variables(model, variables)
    if wide:  # 72 x 72 = 5184 stem pixels: conv1_1 and conv1_2 pass the gate
        monkeypatch.setattr(jl, "USE_PALLAS_WIDE_CONV", True)
        monkeypatch.setattr(jl, "jax", _TpuBackend())
        monkeypatch.setattr(tl, "USE_WIDE_CONV_KERNEL", True)
        assert model.conv1_1.wide(torch.zeros(1, 12, size, size))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))

    s = size // (2 if version == "2s" else 4)
    assert got["pixel"].shape == (2, s, s, 2) and got["link"].shape == (2, s, s, 16)
    # f32 on both sides; only the summation order differs, through ~20 layers
    for key in ("pixel", "link"):
        ref = np.asarray(want[key])
        err = np.abs(got[key].numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (key, err, np.abs(ref).max())
    offs = np.asarray(want["offsets"][0])
    assert np.abs(got["offsets"][0].numpy() - offs).max() <= 1e-4 * np.abs(offs).max()


def test_bf16_upsampling_rounds_its_weights():
    """19 -> 38 (align_corners): the weights i * 18 / 37 are not bf16
    numbers. The port's bf16 upsampling meets JAX's to one bf16 ulp per
    element; F.interpolate, with its f32 weights, does not."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 4, (2, 19, 19, 16)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_upsample(xb, 38, 38)).astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
    got = upsample_bilinear_ac(xt, 38, 38)
    f32w = F.interpolate(xt.float(), size=(38, 38), mode="bilinear",
                         align_corners=True).bfloat16()

    def ulps(t):
        a = want.view(np.int16).astype(np.int32)
        b = t.permute(0, 2, 3, 1).contiguous().view(torch.int16).numpy().astype(np.int32)
        a, b = (np.where(i < 0, -(i + 32768), i) for i in (a, b))
        return np.abs(a - b).max()

    assert got.dtype == torch.bfloat16 and ulps(got) <= 1
    assert ulps(f32w) > 1


@pytest.mark.parametrize("version", ["2s", "4s"])
@pytest.mark.parametrize("name", BOX_SETS)
def test_targets_match_jax_and_goldens(goldens, name, version):
    size = int(goldens["size"])
    boxes = goldens[f"tgt_{name}_boxes"]
    got = make_pixel_link_targets(boxes, size, version)
    want = jax_targets(boxes, size, version)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
    for key in ("pixel_mask", "neg_pixel_mask", "link_mask"):
        np.testing.assert_array_equal(got[key], goldens[f"tgt_{name}_{version}_{key}"])
    np.testing.assert_allclose(got["pixel_pos_weight"],
                               goldens[f"tgt_{name}_{version}_pixel_pos_weight"],
                               rtol=1e-6, atol=1e-7)


def test_targets_match_jax_on_random_boxes():
    """Boxes past the borders, touching and overlapping, degenerate:
    the slice fill gives cv2.fillPoly's maps exactly."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        b = rng.uniform(-0.2, 1.2, (int(rng.integers(0, 5)), 2, 2))
        b = np.concatenate([b.min(1), b.max(1)], 1)
        if rng.random() < 0.3:
            b = np.round(b * 8) / 8
        for version in ("2s", "4s"):
            got, want = make_pixel_link_targets(b, 72, version), jax_targets(b, 72, version)
            assert all(np.array_equal(got[k], want[k]) for k in want)


def _batch_targets(boxes_list, size, version="4s"):
    maps = [make_pixel_link_targets(b, size, version) for b in boxes_list]
    return {k: np.stack([m[k] for m in maps]) for k in maps[0]}


def test_loss_matches_goldens_and_jax(goldens):
    size = int(goldens["size"])
    t = _batch_targets([goldens["tgt_two_boxes"], goldens["tgt_single_boxes"]], size)
    pix = goldens["loss_pixel_logits"].transpose(0, 2, 3, 1)
    lnk = goldens["loss_link_logits"].transpose(0, 2, 3, 1)
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    pp, pn = pixel_loss(torch.from_numpy(pix), tt["pixel_mask"], tt["neg_pixel_mask"],
                        tt["pixel_pos_weight"], 3)
    lp, ln = link_loss(torch.from_numpy(lnk), tt["link_mask"], tt["pixel_pos_weight"])
    for got, key in ((pp, "pixel_pos"), (pn, "pixel_neg"), (lp, "link_pos"), (ln, "link_neg")):
        np.testing.assert_allclose(float(got), float(goldens[f"loss_{key}"]), rtol=1e-5)


def test_loss_ties_mine_the_same_negatives():
    """Logits on a coarse grid: many background probabilities tie, and
    which of the tied negatives are mined decides the loss. Stable sorts
    on both sides pick the same ones (f32, 1e-6 relative)."""
    rng = np.random.default_rng(6)
    logits = (np.round(rng.normal(size=(3, 18, 18, 2)) * 2) / 2 * 20).astype(np.float32)
    t = _batch_targets([np.array([[0.2, 0.2, 0.5, 0.4]]), np.zeros((0, 4)),
                        np.array([[0.1, 0.6, 0.3, 0.9], [0.5, 0.5, 0.8, 0.7]])], 72)
    want = jloss.pixel_loss(jnp.asarray(logits), *(jnp.asarray(t[k]) for k in (
        "pixel_mask", "neg_pixel_mask", "pixel_pos_weight")))
    got = pixel_loss(torch.from_numpy(logits), *(torch.from_numpy(t[k]) for k in (
        "pixel_mask", "neg_pixel_mask", "pixel_pos_weight")))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # the case has ties: image 1 (no positive) has few distinct scores
    margin = np.clip(logits[..., 1] - logits[..., 0], -80, 80)
    assert len(np.unique(1 / (1 + np.exp(margin[1])))) < margin[1].size // 4


@pytest.mark.parametrize("name", ["two", "touching", "single"])
def test_decode_matches_goldens(goldens, name):
    size = int(goldens["size"])
    pix = goldens[f"dec_{name}_pixel_logits"][0].transpose(1, 2, 0)
    lnk = goldens[f"dec_{name}_link_logits"][0].transpose(1, 2, 0)
    ref = goldens[f"dec_{name}_detections"][0]  # [n, 5] score, x1, y1, x2, y2
    scores, boxes = mask_to_boxes(pix, lnk, size, PixelLinkConfig())
    assert len(scores) == len(ref)
    order = np.lexsort((boxes[:, 1], boxes[:, 0]))
    ref_order = np.lexsort((ref[:, 2], ref[:, 1]))
    np.testing.assert_allclose(boxes[order], ref[ref_order, 1:], atol=1e-4)
    np.testing.assert_allclose(scores[order], ref[ref_order, 0], rtol=1e-4, atol=1e-5)


def _instance_logits(labels, rng):
    """Pixel and link logits of an instance map: foreground where a label
    is set, links between 8-neighbours of the same instance (the
    decoder's neighbour order), with noise."""
    from gssd_torch.eval.pixellink_decode import DECODE_NEIGHBORS

    h, w = labels.shape
    pix = np.stack([np.where(labels > 0, -4.0, 4.0), np.where(labels > 0, 4.0, -4.0)], -1)
    lnk = np.zeros((h, w, 16))
    pad = np.pad(labels, 1)
    for j, (dy, dx) in enumerate(DECODE_NEIGHBORS):
        nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        on = (labels > 0) & (nb == labels)
        lnk[..., 2 * j] = np.where(on, -4.0, 4.0)
        lnk[..., 2 * j + 1] = np.where(on, 4.0, -4.0)
    return ((pix + rng.normal(0, 0.5, pix.shape)).astype(np.float32),
            (lnk + rng.normal(0, 0.5, lnk.shape)).astype(np.float32))


def _rect_instances(rng, hw):
    """Touching, border and holed rectangular instances on one map."""
    lab = np.zeros((hw, hw), np.int32)
    lab[0:5, 0:7] = 1                      # corner, on two borders
    lab[0:5, 7:12] = 2                     # touching 1
    lab[10:20, 3:15] = 3
    lab[13:17, 6:12] = 0                   # a hole in 3
    y, x = rng.integers(2, hw - 8, 2)
    lab[y:y + 6, hw - 4:] = 4              # on the right border
    lab[hw - 3:, x:x + 5] = 5              # on the bottom border
    return lab


def test_decode_matches_jax_on_rectangles():
    """Touching, border and holed components whose pixels form rectangles
    (the hull's minimum-area rectangle is axis-aligned and unique): the
    boxes equal cv2's exactly, scores to 1e-6."""
    rng = np.random.default_rng(7)
    for size, hw in ((300, 75), (96, 24), (100, 50)):
        pix, lnk = _instance_logits(_rect_instances(rng, hw), rng)
        want_s, want_b = jax_mask_to_boxes(pix, lnk, size, JaxPixelLinkConfig())
        got_s, got_b = mask_to_boxes(pix, lnk, size, PixelLinkConfig())
        assert len(got_s) == len(want_s) >= 4
        np.testing.assert_array_equal(got_b, want_b)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


def test_decode_against_jax_on_random_components():
    """Random blobs (staircase hulls, many rectangles of equal area): the
    same components, scores and boxes as cv2, exactly."""
    rng = np.random.default_rng(8)
    n_boxes = 0
    for _ in range(12):
        lab = (rng.random((24, 24)) < 0.45).astype(np.int32)
        lab *= rng.integers(1, 4, lab.shape)
        pix, lnk = _instance_logits(lab, rng)
        want_s, want_b = jax_mask_to_boxes(pix, lnk, 96, JaxPixelLinkConfig())
        got_s, got_b = mask_to_boxes(pix, lnk, 96, PixelLinkConfig())
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_b, want_b)
        n_boxes += len(got_b)
    assert n_boxes > 100, n_boxes


def _train_inputs(rng, size=32):
    x = rng.uniform(0, 1, (2, size, size, 12)).astype(np.float32)
    t = _batch_targets([np.array([[0.1, 0.2, 0.45, 0.6], [0.5, 0.5, 0.9, 0.8]]),
                        np.array([[0.3, 0.1, 0.7, 0.4]])], size)
    return {"image": x, **t}


def test_train_step_matches_jax_with_and_without_remat():
    """One PixelLink++ step (f32, lr 1, x0.1 on dcn_*) of the port with
    attention remat on and off: identical losses, gradients and spectral
    vectors (the power iteration runs once either way); both equal JAX's
    make_pixellink_train_step (remat on) in f32 within summation order."""
    rng = np.random.default_rng(9)
    cfg = JaxPixelLinkConfig(**PLUSPLUS)
    jmodel = JaxPixelLink(cfg, dtype=jnp.float32, dcn_impl="xla")
    batch = _train_inputs(rng)
    variables = _seeded_variables(jmodel, batch["image"], rng)
    optim = dict(lr=1.0, stepvalues=(), modify_dcn_lr=True)
    tx = jax_make_optimizer(JaxOptimConfig(**optim))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], spectral=variables["spectral"],
                       opt_state=tx.init(params), tx=tx)
    step = jax.jit(make_pixellink_train_step(jmodel, cfg, JaxOptimConfig(**optim)))
    new_state, want = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    want_after = from_jax_variables(jax.tree_util.tree_map(np.asarray, new_state.variables()))

    runs = {}
    for remat in (True, False):
        plc = PixelLinkConfig(**PLUSPLUS, remat_attention=remat)
        model = PixelLink(plc, compute_dtype="float32", dcn_impl="xla")
        load_jax_variables(model, variables)
        opt = make_optimizer(model, OptimConfig(**optim))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        model.train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        metrics = pixellink_train_step(model, opt, tb, plc, OptimConfig(**optim), 0)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        runs[remat] = (metrics, grads, model.state_dict(), before)

    (m_on, g_on, sd_on, before), (m_off, g_off, sd_off, _) = runs[True], runs[False]
    for key in ("loss", "pixel_loss", "link_loss", "grad_norm"):
        assert float(m_on[key]) == float(m_off[key]), key
    assert all(torch.equal(g_on[n], g_off[n]) for n in g_on)
    assert all(torch.equal(sd_on[n], sd_off[n]) for n in sd_on)

    for key in ("loss", "pixel_loss", "link_loss"):
        np.testing.assert_allclose(float(m_on[key]), float(want[key]), rtol=1e-4)
    np.testing.assert_allclose(float(m_on["grad_norm"]), float(want["grad_norm"]), rtol=2e-3)
    assert set(sd_on) == set(want_after)
    updates = {}
    for name, w in want_after.items():
        if name.endswith("num_batches_tracked"):
            continue
        w, a, b = w.numpy(), sd_on[name].numpy(), before[name].numpy()
        if name.endswith(("running_mean", "running_var", ".u", ".v")):
            # BN statistics and spectral vectors: forward quantities
            np.testing.assert_allclose(a, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        else:
            updates[name] = (a - b, w - b)
    top = max(np.abs(want_u).max() for _, want_u in updates.values())
    for name, (got_u, want_u) in updates.items():
        # f32 gradients in another summation order, through BatchNorm at
        # batch 2: single entries may move by ~1% of the largest update
        np.testing.assert_allclose(got_u, want_u, atol=2e-2 * top, rtol=0, err_msg=name)
        if np.abs(want_u).max() > 1e-3 * top:
            cos = np.sum(got_u * want_u) / np.sqrt(np.sum(got_u ** 2) * np.sum(want_u ** 2))
            assert cos >= 0.999, (name, cos)


def test_config_guards():
    with pytest.raises(ValueError, match="detach_sab"):
        PixelLinkConfig(detach_sab=True)
    with pytest.raises(ValueError, match="use_self_attention_base"):
        PixelLinkConfig(dcn_cat_sab=True, num_dcn_layers=1)
    assert dataclasses.replace(PixelLinkConfig(), version="2s").scale_factor == 2


def _cli(data, out, *extra):
    from gssd_torch import train_pixellink

    return train_pixellink.main([
        "--reference_recipe", "pixellink++", "--datapath", str(data), "--num_test_subjects",
        "1", "--batch_size", "2", "--ssd_dim", "64", "--compute_dtype", "float32",
        "--dcn_impl", "xla", "--device", "cpu", "--output", str(out), *extra])


def test_trainer_cli_trains_evaluates_resumes_and_tests(tmp_path, capsys, monkeypatch):
    """python -m gssd_torch.train_pixellink at a 64 x 64 input on the CPU:
    two steps with the validation loss, AP/IoBB and a checkpoint at each;
    --resume continues at the stored step; --test evaluates a checkpoint."""
    from gssd_torch.data import make_synthetic_dataset

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    first = _cli(data, tmp_path / "run", "--max_iter", "2", "--val_every", "1",
                 "--speedrun", "0")
    text = capsys.readouterr().out
    assert [r["iter"] for r in first["records"]] == [0, 1] and first["step"] == 2
    for r in first["records"]:
        assert all(np.isfinite(r[k]) for k in ("loss", "pixel_loss", "link_loss", "grad_norm"))
        assert r["lr"] == pytest.approx(5e-4)
    assert "iter 1: loss=" in text and "(pixel=" in text and "valid: loss=" in text
    assert [e["iter"] for e in first["evals"]] == [1]
    for split in ("valid", "test"):
        res = first["evals"][0][split]
        assert set(res) == {"ap50", "iobb50"} and all(0 <= v <= 1 for v in res.values())
    assert first["weights"].endswith("pixellink_plusplus_1_CV0.pt")

    resumed = _cli(data, tmp_path / "run", "--max_iter", "3", "--val_every", "5",
                   "--speedrun", "5", "--resume", "1")
    assert [r["iter"] for r in resumed["records"]] == [1, 2] and resumed["step"] == 4
    tested = _cli(data, tmp_path / "run", "--test", "True", "--checkpoint", "1")["test"]
    assert tested == first["evals"][0]["test"]


@pytest.mark.parametrize("flag", [["--num_workers", "2"],
                                  ["--num_workers", "2", "--version", "2s"]])
def test_trainer_cli_takes_the_input_paths(tmp_path, capsys, monkeypatch, flag):
    """--num_workers 2: the worker processes' stream (the host augmentation
    with the target maps, at 1/4 of the input or, with --version 2s, 1/2),
    two steps with a checkpoint at iteration 1; --resume 1 continues the
    stream exactly: its batch is the first run's iteration-1 batch, bit
    for bit."""
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.train import steps

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []
    real = steps.pixellink_train_step

    def recording(model, opt, batch, *a):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(model, opt, batch, *a)

    monkeypatch.setattr(steps, "pixellink_train_step", recording)
    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    first = _cli(data, tmp_path / "run", *flag, "--max_iter", "2", "--val_every", "1",
                 "--speedrun", "1")
    resumed = _cli(data, tmp_path / "run", *flag, "--max_iter", "2", "--speedrun", "5",
                   "--resume", "1")
    assert "input: host: 2 worker processes, from batch 1" in capsys.readouterr().out
    assert [r["iter"] for r in first["records"] + resumed["records"]] == [0, 1, 1]
    assert len(seen) == 3 and set(seen[2]) >= {"image", "pixel_mask", "link_mask", "valid"}
    factor = 2 if "2s" in flag else 4
    assert tuple(seen[2]["pixel_mask"].shape[1:3]) == (64 // factor, 64 // factor)
    for key, value in seen[2].items():
        assert torch.equal(value, seen[1][key]), key
    assert not torch.equal(seen[0]["image"], seen[1]["image"])


def _check_visualize(data, out, flag):
    from gssd_torch import train_pixellink
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.models.pixellink import build_pixellink
    from gssd_torch.train.checkpoint import save_checkpoint
    from gssd_torch.train.steps import make_pixellink_forward
    from gssd_torch.utils.visualize import dump_names

    argv = ["--reference_recipe", "pixellink++", "--datapath", str(data), "--num_test_subjects",
            "1", "--ssd_dim", "64", "--dcn_impl", "xla", "--compute_dtype", "float32",
            "--device", "cpu", "--output", str(out)]
    args = train_pixellink.parse_args(argv)
    model = build_pixellink(train_pixellink.pixellink_config(args), args.cascade_fuse,
                            args.batch_norm, "float32", "xla", device="cpu", seed=3)
    save_checkpoint(model, make_optimizer(model, OptimConfig()), 0, str(out / "checkpoints"),
                    args.model_name, 0)
    res = train_pixellink.main(argv + ["--test", "True", "--checkpoint", "0", *flag])
    vis = res["visualized"]
    assert sorted(os.listdir(vis["dir"])) == sorted(dump_names(0, True, True, True))
    shapes = {name: np.load(os.path.join(vis["dir"], f"00000_{name}.npy")).shape
              for name in ("x", "offsets", "attention", "attention_base")}
    assert shapes == {"x": (64, 64, 12), "offsets": (16, 16, 4, 9, 2),
                      "attention": (256, 256), "attention_base": (256, 256)}
    test_set = LesionDataset(str(data), DataSplitter(str(data), 1, 1).data_test)
    x, _, _ = BaseTransform(64)(test_set.pull_image(0))
    img = np.transpose(x, (1, 2, 0, 3)).reshape(64, 64, 12)[None].astype(np.float32)
    pix, lnk = make_pixellink_forward(model, torch.device("cpu"))(img)
    scores, boxes = mask_to_boxes(pix[0], lnk[0], 64, PixelLinkConfig())
    det = vis["detections"][0]
    assert det.shape == (2, max(len(scores), 1), 5) and not det[0].any()
    np.testing.assert_array_equal(det[1, :len(scores), 0], scores.astype(np.float32))
    np.testing.assert_array_equal(det[1, :len(scores), 1:], (boxes / 64).astype(np.float32))


@pytest.mark.parametrize("flag", [["--cross_validation", "2"], ["--visualize", "True"]])
def test_trainer_cli_refuses_what_is_not_ported(flag, tmp_path, capsys, monkeypatch):
    """--test --visualize dumps fold 0's checkpoint over the test set at a
    64 x 64 input: every file of the JAX package's dump set, the offsets
    [16, 16, 4, 9, 2] and the first attention maps [256, 256], and the
    decoded boxes packed as detections (those of the evaluation's decode
    of the same logits). --cross_validation 2 trains two
    folds side by side at a 64 x 64 input: one step each, an evaluation
    and a checkpoint a fold, the logged AP/IoBB the means of the folds'."""
    from gssd_torch import train_pixellink
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.parallel.folds import fold_mean

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    if flag[0] == "--visualize":
        _check_visualize(data, tmp_path / "run", flag)
        return
    res = _cli(data, tmp_path / "run", *flag, "--max_iter", "1", "--speedrun", "0")
    (rec,) = res["records"]
    assert len(rec["folds"]) == 2 and all(np.isfinite(f["loss"]) for f in rec["folds"])
    assert rec["loss"] == pytest.approx(np.mean([f["loss"] for f in rec["folds"]]), rel=1e-12)
    (ev,) = res["evals"]
    assert [p["checkpoint"].rsplit("_", 1)[1] for p in ev["folds"]] == ["CV0.pt", "CV1.pt"]
    assert all(os.path.exists(p["checkpoint"]) for p in ev["folds"])
    for split in ("valid", "test"):
        assert ev[split] == fold_mean([p[split] for p in ev["folds"]])
    assert "iter 0 fold 1 valid:" in capsys.readouterr().out


def test_recipe_sets_the_published_flags():
    from gssd_torch.train_pixellink import parse_args, pixellink_config

    args = parse_args(["--reference_recipe", "pixellink++", "--lr", "1e-3"])
    assert (args.batch_size, args.lr, args.stepvalues, args.modify_dcn_lr) == (16, 1e-3, [], True)
    plc = pixellink_config(args)
    assert plc.remat_attention and plc.dcn_cat_sab and plc.groups_dcn == 4
    assert plc.version == "4s" and args.model_name == "pixellink_plusplus"
