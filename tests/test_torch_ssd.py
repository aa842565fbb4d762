"""The whole serving slice: the full-width GSSD++ forward of the port
against gssd_tpu's, and the port's serving CLI end to end, on the CPU.

Variables come from ``jax.eval_shape`` plus seeded numpy (a jitted
``model.init`` of the full model costs tens of seconds on a CPU), with
sigma != 0, a non-zero offset predictor and positive BN variances so
that every path of the model contributes.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.config import ModelConfig as JaxModelConfig
from gssd_tpu.models import build_model as jax_build_model
from gssd_torch.config import ModelConfig
from gssd_torch.models import build_model
from gssd_torch.params import load_jax_variables

GSSD_PP = dict(ssd_type="gssd", batch_norm=True, use_fuseconv=True,
               use_self_attention=True, use_self_attention_base=True,
               num_dcn_layers=1, groups_dcn=4, dcn_cat_sab=True,
               compute_dtype="float32", dcn_impl="xla")


def _seeded_variables(model, rng, size=300):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 12)),
                           train=False))

    def draw(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        leaf, shape = keys[-1], s.shape
        if leaf == "kernel" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.normal(0, 1 / np.sqrt(fan_in), shape)
        if leaf == "kernel":  # SNDense [in, out]
            return rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        if leaf == "weight" and len(shape) == 3:  # DCN [K, C, Cout]
            b = 1 / np.sqrt(shape[0] * shape[1])
            return rng.uniform(-b, b, shape)
        if leaf in ("u", "v"):
            a = rng.normal(size=shape)
            return a / np.linalg.norm(a)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        if leaf == "sigma":
            return np.full(shape, 0.5)
        if leaf == "weight":  # l2norm
            return rng.uniform(15, 25, shape)
        return rng.normal(0, 0.1, shape)  # biases, BN means

    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax.tree_util.tree_map_with_path(draw, shapes))
    # frozen power-iteration vectors at the top singular pair, as after
    # training, so that sigma is the spectral norm and W / sigma is tame
    for attn, sub in v["spectral"].items():
        for name, uv in sub.items():
            w = v["params"][attn][name]["kernel"].T  # [out, in]
            u, _, vt = np.linalg.svd(w, full_matrices=False)
            uv["u"], uv["v"] = u[:, 0].copy(), vt[0].copy()
    return v


@pytest.fixture(scope="module")
def gssd_pp():
    model, _ = jax_build_model(JaxModelConfig(**GSSD_PP))
    return model, _seeded_variables(model, np.random.default_rng(7))


# input size -> (priors, the DCN site's side): v2 at 300, v2_512 at 512
SIZES = {300: (8732, 38), 512: (24564, 64)}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_full_width_forward_matches_jax(gssd_pp, size):
    if size == 300:
        jmodel, variables = gssd_pp
    else:
        jmodel, jpriors = jax_build_model(JaxModelConfig(**GSSD_PP, size=size))
        variables = _seeded_variables(jmodel, np.random.default_rng(7), size)
    x = np.random.default_rng(0).uniform(0, 1, (1, size, size, 12)).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))

    model, priors = build_model(ModelConfig(**GSSD_PP, size=size), device="cpu")
    load_jax_variables(model, variables)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), return_attn=True)

    n_priors, side = SIZES[size]
    assert got["loc"].shape == (1, priors.shape[0], 4) == (1, n_priors, 4)
    assert got["conf"].shape == (1, n_priors, 2)
    if size != 300:  # the port's anchors are JAX's v2_512 table
        np.testing.assert_allclose(priors, np.asarray(jpriors), rtol=0, atol=1e-7)
    offs_want = np.asarray(want["offsets"][0])
    assert got["offsets"][0].shape == offs_want.shape == (1, side, side, 4, 9, 2)
    assert np.abs(offs_want).max() > 0.5  # the DCN samples off-grid
    # f32 on both sides; only the summation order of the convolutions
    # differs (including the JAX package's default pair-mode grouped
    # lowering), which grows through ~25 layers
    # the attention maps too (--visualize dumps the first of each list)
    maps = [(f"{key}[{i}]", a, b) for key in ("attn", "attn_base")
            for i, (a, b) in enumerate(zip(got[key], want[key]))]
    assert len(maps) == 2 * len(got["attn"]) == 2 * len(want["attn"]) > 0
    for name, a, b in (("loc", got["loc"], want["loc"]),
                       ("conf", got["conf"], want["conf"]),
                       ("offsets", got["offsets"][0], offs_want), *maps):
        ref = np.asarray(b)
        err = np.abs(a.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_serving_cli_on_cpu(gssd_pp, tmp_path, capsys):
    from gssd_torch import infer
    from gssd_torch.data import make_synthetic_dataset

    _, variables = gssd_pp
    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=4, slices_per_subject=1,
                           image_size=64)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): a for path, a in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    weights = tmp_path / "gssd_pp.npz"
    np.savez(weights, **flat)
    det_path = tmp_path / "dets.json"
    infer.main([
        "--reference_recipe", "gssd++", "--datapath", str(data),
        "--cross_validation", "2", "--num_test_subjects", "2",
        "--eval_batch", "1", "--compute_dtype", "float32", "--dcn_impl", "xla",
        "--confidence_threshold", "0.0", "--weights", str(weights),
        "--device", "cpu", "--det_output", str(det_path)])
    text = capsys.readouterr().out

    dets = json.loads(det_path.read_text())
    assert [d["id"] for d in dets] == ["synth002_0", "synth003_0"]
    for row in dets:
        assert set(row) == {"id", "scores", "boxes"}
        assert len(row["scores"]) == len(row["boxes"]) > 0
        assert all(len(b) == 4 for b in row["boxes"])
        assert row["scores"] == sorted(row["scores"], reverse=True)
    assert re.search(r"im_detect: 2/2 [\d.]+ ms/image", text), text
    assert re.search(r"latency: mean [\d.]+ ms/image", text), text
