"""The whole training slice on the CPU: one full-width GSSD++ train step
of the port (f32, dcn_impl='xla', batch 1) against
gssd_tpu.train.make_train_step, and the trainer CLI end to end, whose
saved weights the serving CLI then loads.

Variables come from ``jax.eval_shape`` plus seeded numpy, as in
tests/test_torch_ssd.py, and the optax state is built from them (a
jitted ``create_train_state`` would cost another half minute).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ssd import GSSD_PP, _seeded_variables

from gssd_tpu.config import LossConfig as JaxLossConfig
from gssd_tpu.config import ModelConfig as JaxModelConfig
from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.models import build_model as jax_build_model
from gssd_tpu.train import make_train_step
from gssd_tpu.train.state import TrainState, make_optimizer as jax_make_optimizer
from gssd_torch.config import DetectConfig, LossConfig, ModelConfig, OptimConfig
from gssd_torch.models import build_model
from gssd_torch.params import from_jax_variables, load_jax_variables
from gssd_torch.train import make_optimizer, train_step

OPTIM = dict(lr=1.0, momentum=0.9, weight_decay=5e-4, gamma=0.1,
             stepvalues=(30000, 50000), modify_dcn_lr=True)


def _batch(rng):
    x = rng.uniform(0, 1, (1, 300, 300, 12)).astype(np.float32)
    boxes = np.zeros((1, 16, 4), np.float32)
    boxes[0, 0] = [0.30, 0.35, 0.45, 0.52]
    boxes[0, 1] = [0.55, 0.40, 0.62, 0.47]
    labels = np.zeros((1, 16), np.int32)
    valid = np.zeros((1, 16), bool)
    valid[0, :2] = True
    return {"image": x, "boxes": boxes, "labels": labels, "valid": valid}


def test_full_width_train_step_matches_jax():
    rng = np.random.default_rng(7)
    jmodel, priors = jax_build_model(JaxModelConfig(**GSSD_PP))
    variables = _seeded_variables(jmodel, rng)
    batch = _batch(rng)

    tx = jax_make_optimizer(JaxOptimConfig(**OPTIM))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], spectral=variables["spectral"],
                       opt_state=tx.init(params), tx=tx)
    step = jax.jit(make_train_step(jmodel, priors, JaxLossConfig(), JaxOptimConfig(**OPTIM)))
    new_state, want = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    want_after = from_jax_variables(jax.tree_util.tree_map(np.asarray, new_state.variables()))

    model, tpriors = build_model(ModelConfig(**GSSD_PP), device="cpu")
    load_jax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, OptimConfig(**OPTIM))
    got = train_step(model, opt, torch.from_numpy(tpriors),
                     {k: torch.from_numpy(v) for k, v in batch.items()}, LossConfig(),
                     OptimConfig(**OPTIM), 0)

    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    assert got["lr"] == float(want["lr"]) == 1.0
    # f32 on both sides through ~25 layers and back; only the summation
    # order differs (the forward alone agrees to 1e-3 of its scale)
    for name in ("loss", "loss_l", "loss_c"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=2e-3)

    after = model.state_dict()
    assert set(after) == set(want_after)
    updates = {}
    for name, w in want_after.items():
        if name.endswith("num_batches_tracked"):
            continue
        w, a, b = w.numpy(), after[name].numpy(), before[name].numpy()
        if name.endswith(("running_mean", "running_var", ".u", ".v")):
            # BN statistics and spectral vectors: forward quantities
            np.testing.assert_allclose(a, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        else:
            # parameters: the SGD update lr * (grad + wd * p) itself (lr 1,
            # so that it stands well above the f32 rounding of p)
            updates[name] = (a - b, w - b)
    top = max(np.abs(want).max() for _, want in updates.values())
    for name, (got_u, want_u) in updates.items():
        # f32 gradients through the whole detector in another sum order;
        # BatchNorm at batch 1 subtracts nearly equal terms, so single
        # entries move by up to ~10% of their tensor's largest update
        # while the direction holds (cosine >= 0.9999 where measured)
        np.testing.assert_allclose(got_u, want_u, atol=2e-2 * top, rtol=0, err_msg=name)
        if np.abs(want_u).max() > 1e-3 * top:
            # (skips the conv biases in front of a BatchNorm: their
            # gradient is 0 in exact arithmetic, the update weight decay
            # plus rounding)
            cos = np.sum(got_u * want_u) / np.sqrt(np.sum(got_u ** 2) * np.sum(want_u ** 2))
            assert cos >= 0.999, (name, cos)


def test_trainer_cli_then_serving_cli(tmp_path, capsys, monkeypatch):
    from gssd_torch import infer
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.train import main

    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    out = tmp_path / "run"
    # text logs only: where TensorBoard is installed its import can pull in
    # TensorFlow (tens of seconds); the logger runs without it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = main([
        "--reference_recipe", "gssd++", "--synthetic", "True", "--datapath", str(data),
        "--num_test_subjects", "1", "--batch_size", "2", "--max_iter", "2",
        "--val_every", "1", "--speedrun", "0", "--compute_dtype", "float32",
        "--device", "cpu", "--output", str(out), "--model_name", "gssd_pp"])
    text = capsys.readouterr().out
    assert [r["iter"] for r in res["records"]] == [0, 1]
    for r in res["records"]:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_l", "loss_c", "grad_norm"))
        assert r["lr"] == pytest.approx(1e-3) and r["ms"] > 0
    assert [v["iter"] for v in res["valid"]] == [1]
    assert "iter 1: loss=" in text and "ms/step" in text and "valid: loss=" in text
    # the evaluation at the last iteration: the recipe's AP/IoBB keys
    assert [e["iter"] for e in res["evals"]] == [1]
    keys = {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}
    assert set(res["evals"][0]["valid"]) == set(res["evals"][0]["test"]) == keys
    weights = out / "checkpoints" / "gssd_pp" / "gssd_pp_1_CV0.pt"
    assert res["weights"] == str(weights) and weights.exists()

    det_path = tmp_path / "dets.json"
    infer.main([
        "--reference_recipe", "gssd++", "--datapath", str(data), "--num_test_subjects", "1",
        "--eval_batch", "1", "--compute_dtype", "float32", "--confidence_threshold", "0.0",
        "--weights", str(weights), "--device", "cpu", "--det_output", str(det_path)])
    dets = json.loads(det_path.read_text())
    assert [d["id"] for d in dets] == ["synth005_0"]
    assert len(dets[0]["scores"]) == len(dets[0]["boxes"]) > 0


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    from gssd_torch.data import make_synthetic_dataset

    data = tmp_path_factory.mktemp("ml_small")
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    return str(data)


@pytest.mark.parametrize("flag", [["--cross_validation", "2"], ["--visualize", "True"]])
def test_trainer_refuses_what_is_not_ported(flag, small_data, tmp_path, monkeypatch):
    """--test --visualize dumps fold 0's checkpoint over the test set: every
    file of the JAX package's dump set, the offsets [38, 38, 4, 9, 2] and
    the first maps of both attention lists [1444, 1444], and the
    detections the inference step gives. --cross_validation 2 runs:
    one iteration steps two folds, each its own model (fold 1's built
    from fold_seed(seed, 1)) and optimizer, on its own batch; the record
    holds the mean of the two folds' losses."""
    from gssd_torch.parallel.folds import fold_seed
    from gssd_torch.train import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    if flag[0] == "--visualize":
        _check_visualize(small_data, tmp_path, flag)
        return
    res = main(["--reference_recipe", "gssd", "--datapath", small_data, "--num_test_subjects",
                "1", "--batch_size", "1", "--max_iter", "1", "--speedrun", "5",
                "--compute_dtype", "float32", "--device", "cpu", "--output", str(tmp_path),
                *flag])
    (rec,) = res["records"]
    losses = [f["loss"] for f in rec["folds"]]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[0] != losses[1]
    assert rec["loss"] == pytest.approx(np.mean(losses), rel=1e-12)
    folds = res["folds"]
    assert [m.fold for m in folds] == [0, 1] and [m.step for m in folds] == [1, 1]
    assert folds[0].optimizer is not folds[1].optimizer
    # after one step each fold's weights still lie far nearer their own
    # initialisation than the other fold's
    name = "vgg_1.conv.weight"
    init = [build_model(m.model.cfg, device="cpu", seed=fold_seed(1111, m.fold))[0]
            .state_dict()[name] for m in folds]
    for m in folds:
        dist = [(m.model.state_dict()[name] - w).norm() for w in init]
        assert dist[m.fold] < dist[1 - m.fold] / 3, dist


def _check_visualize(data, out, flag):
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.train import trainer
    from gssd_torch.train.checkpoint import save_checkpoint
    from gssd_torch.train.steps import make_infer_step
    from gssd_torch.utils.visualize import dump_names

    argv = ["--reference_recipe", "gssd++", "--datapath", data, "--num_test_subjects", "1",
            "--compute_dtype", "float32", "--device", "cpu", "--output", str(out)]
    args = trainer.parse_args(argv)
    model, priors = build_model(trainer.model_config(args), device="cpu", seed=3)
    save_checkpoint(model, make_optimizer(model, OptimConfig()), 0, str(out / "checkpoints"),
                    args.model_name, 0)
    res = trainer.main(argv + ["--test", "True", "--checkpoint", "0", *flag])
    vis = res["visualized"]
    assert vis["dir"] == str(out / "visualize" / args.model_name)
    assert sorted(os.listdir(vis["dir"])) == sorted(dump_names(0, True, True, True))
    shapes = {name: np.load(os.path.join(vis["dir"], f"00000_{name}.npy")).shape
              for name in ("x", "offsets", "attention", "attention_base")}
    assert shapes == {"x": (300, 300, 12), "offsets": (38, 38, 4, 9, 2),
                      "attention": (1444, 1444), "attention_base": (1444, 1444)}
    # the dumped detections: the inference step's on the same slice
    test_set = LesionDataset(data, DataSplitter(data, 1, 1).data_test)
    x, _, _ = BaseTransform(300)(test_set.pull_image(0))
    img = np.transpose(x, (1, 2, 0, 3)).reshape(300, 300, 12)[None].astype(np.float32)
    want = make_infer_step(model.eval(), torch.tensor(priors), DetectConfig())(img)
    np.testing.assert_array_equal(vis["detections"][0], want[0].numpy())
    assert set(res["test"]) == {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}


def _one_step(data, out, *extra):
    """One f32 GSSD++ step of the trainer CLI on the CPU at batch 1, no
    evaluation (--speedrun past the run)."""
    from gssd_torch.train import main

    return main(["--reference_recipe", "gssd++", "--datapath", data, "--num_test_subjects", "1",
                 "--batch_size", "1", "--max_iter", "1", "--speedrun", "5",
                 "--compute_dtype", "float32", "--device", "cpu", "--output", str(out), *extra])


@pytest.mark.parametrize("flag,stream", [
    (["--num_workers", "2"], "host: 2 worker processes, from batch 0"),
    (["--aug_method", "device_cached"], "device_cached: 4 slices"),
    (["--aug_method", "device"], "device: one thread")])
def test_trainer_takes_the_input_paths(small_data, tmp_path, capsys, monkeypatch, flag, stream):
    """The JAX trainer's input paths: each flag runs one step through the
    stream it names (a full-size batch of f32 images)."""
    from gssd_torch.train import steps

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []
    real = steps.train_step

    def recording(model, opt, priors, batch, *a):
        seen.append({k: (v.shape, v.dtype) for k, v in batch.items()})
        return real(model, opt, priors, batch, *a)

    monkeypatch.setattr(steps, "train_step", recording)
    res = _one_step(small_data, tmp_path, *flag)
    assert f"input: {stream}" in capsys.readouterr().out
    assert len(res["records"]) == 1 and np.isfinite(res["records"][0]["loss"])
    assert seen == [{"image": ((1, 300, 300, 12), torch.float32),
                     "boxes": ((1, 16, 4), torch.float32), "labels": ((1, 16), torch.int32),
                     "valid": ((1, 16), torch.bool)}]


@pytest.mark.parametrize("cli,flag,default", [
    ("train", ["--profile_dir", "trace"], None), ("train", ["--warmup_eval", "True"], False),
    ("train_pixellink", ["--profile_dir", "trace"], None),
    ("train_pixellink", ["--warmup_eval", "True"], False),
    ("infer", ["--fold", "1"], 0)])
def test_cli_takes_the_reference_flags_and_refuses_them(cli, flag, default, small_data,
                                                        tmp_path, capsys, monkeypatch):
    # the JAX CLIs' flags (train.py --profile_dir, --warmup_eval; infer.py
    # --fold) parse with their defaults. The GSSD++ trainer runs the first
    # two: a trace file of the traced iteration, the warm-up line. The
    # PixelLink++ trainer (whose JAX counterpart has neither) refuses them.
    # infer --fold 1 serves the trainer's checkpoint of fold 1 (_CV1) and
    # refuses a fold beyond --cross_validation.
    import importlib

    mod = importlib.import_module("gssd_torch.train.trainer" if cli == "train"
                                  else f"gssd_torch.{cli}")
    assert getattr(mod.build_parser().parse_args([]), flag[0][2:]) == default
    if cli == "train":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        monkeypatch.setattr(mod, "PROFILE_WINDOW", (0, 1))
        if flag[0] == "--profile_dir":
            res = _one_step(small_data, tmp_path / "run", "--profile_dir", str(tmp_path / "tr"))
            assert res["traces"] == [str(tmp_path / "tr" / "trace_iter0-0.json")]
            trace = json.loads((tmp_path / "tr" / "trace_iter0-0.json").read_text())
            names = {e.get("name") for e in trace["traceEvents"]}
            assert "train_iteration" in names
        else:
            _one_step(small_data, tmp_path / "run", *flag, "--speedrun", "1",
                      "--val_every", "1", "--eval_batch", "1")
            assert "eval executables warmed" in capsys.readouterr().out
        return
    if cli == "infer":
        from gssd_torch.train.checkpoint import save_checkpoint

        model, _ = build_model(mod.model_config(mod.parse_args(
            ["--reference_recipe", "gssd", "--weights", "w.pt"])), device="cpu", seed=5)
        opt = make_optimizer(model, OptimConfig())
        ckpts = str(tmp_path / "run" / "checkpoints")
        saved = [save_checkpoint(model, opt, 0, ckpts, "GSSD", 7, f) for f in (0, 1)]
        with torch.no_grad():  # fold 0's checkpoint holds other weights
            for p in model.parameters():
                p.mul_(0.5)
        save_checkpoint(model, opt, 0, ckpts, "GSSD", 7, 0)
        argv = ["--reference_recipe", "gssd", "--datapath", small_data, "--device", "cpu",
                "--num_test_subjects", "1", "--compute_dtype", "float32", "--eval_batch", "1",
                "--confidence_threshold", "0.0", "--output", str(tmp_path / "run"),
                "--checkpoint", "7", "--cross_validation", "2"]
        dets = []
        for fold in ("1", "0"):
            out = tmp_path / f"dets{fold}.json"
            mod.main(argv + ["--fold", fold, "--det_output", str(out)])
            dets.append(json.loads(out.read_text()))
        assert f"weights: {saved[1]}" in capsys.readouterr().out
        assert [d["id"] for d in dets[0]] == ["synth005_0"] and len(dets[0][0]["scores"]) > 0
        assert dets[0] != dets[1]
        with pytest.raises(ValueError, match="--fold 2"):
            mod.main(argv + ["--fold", "2"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mod.main(["--device", "cpu", *flag])


def test_remat_attention_step_equals_plain_step():
    """--remat_attention recomputes each attention block in the backward;
    its spectral power iterations run once, before the checkpointed part.
    One full-width GSSD++ step (f32, batch 1) with it on and off gives
    the same loss, gradients, BN statistics and u/v, bit for bit."""
    from gssd_torch.train.trainer import model_config, parse_args

    assert model_config(parse_args(["--remat_attention", "True"])).remat_attention
    assert not model_config(parse_args([])).remat_attention
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(8)).items()}
    runs = []
    for remat in (True, False):
        model, priors = build_model(ModelConfig(**GSSD_PP, remat_attention=remat),
                                    device="cpu", seed=3)
        with torch.no_grad():  # sigma != 0: the attention reaches the loss
            for name, p in model.named_parameters():
                if name.endswith("sigma"):
                    p.fill_(0.5)
        opt = make_optimizer(model, OptimConfig(**OPTIM))
        m = train_step(model, opt, torch.from_numpy(priors), batch, LossConfig(),
                       OptimConfig(**OPTIM), 0)
        grads = {n: p.grad for n, p in model.named_parameters()}
        runs.append((m, grads, model.state_dict()))
    (m_on, g_on, sd_on), (m_off, g_off, sd_off) = runs
    assert float(m_on["loss"]) == float(m_off["loss"])
    assert all(torch.equal(g_on[n], g_off[n]) for n in g_on)
    assert any(g_on[n].abs().max() > 0 for n in g_on if n.startswith("attn"))
    assert all(torch.equal(sd_on[n], sd_off[n]) for n in sd_on)
