"""k-fold cross-validation of the port (``gssd_torch.parallel.folds`` in
the trainers) against the JAX package's, on the CPU.

- The folds' data: the splitter's ids, and fold 1's first training and
  validation batches as the trainer draws them against JAX's loaders
  seeded ``seed + 1`` and ``seed + 101`` (boxes, labels, valid the same
  bits; images within 1e-5, torch's resize against OpenCV's, as in
  tests/test_torch_augment.py).
- The fold machinery against ``vmap_train_step``: three folds of
  tests/mini_model.py's detector, stacked by JAX's ``stack_states`` and
  carried into a torch twin with ``load_jax_fold``, two steps; each
  fold's losses and parameters within 1e-5 of JAX's (the tolerance of
  tests/test_train_step.py's ``test_vmapped_folds``: f32 on both sides,
  convolutions summed in another order).
- Two folds stepped together are, bit for bit, each fold stepped alone.
- The trainer CLI with two folds: per-fold checkpoints, the logged means,
  ``--test`` and ``--resume``.
"""

import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mini_model import build_mini, mini_batch
from torch_ranks import MiniTwin, _Stage  # noqa: F401 (the twin, also imported from here)

from gssd_torch.config import LossConfig, OptimConfig
from gssd_torch.parallel.folds import FoldMember, fold_mean, fold_seed, fold_train_step
from gssd_torch.params import load_jax_fold
from gssd_torch.train import make_optimizer, train_step
from gssd_tpu.config import LossConfig as JaxLossConfig
from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.parallel.folds import stack_states, unstack_state, vmap_train_step
from gssd_tpu.train import create_train_state, make_train_step

IMG_TOL = 1e-5
FOLD_TOL = 1e-5
OPTIM = dict(lr=1e-3, stepvalues=(100,))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    from gssd_torch.data import make_synthetic_dataset

    data = tmp_path_factory.mktemp("ml_folds")
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    return str(data)


def _quiet(monkeypatch):
    # text logs only: a TensorBoard import can pull in TensorFlow
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_fold_splits_match_jax(small_data):
    from gssd_torch.data import DataSplitter
    from gssd_tpu.data import DataSplitter as JaxDataSplitter

    got, want = DataSplitter(small_data, 3, 1), JaxDataSplitter(small_data, 3, 1)
    assert got.data_cv_train == want.data_cv_train and len(got.data_cv_train) == 3
    assert got.data_cv_eval == want.data_cv_eval and got.data_test == want.data_test
    assert fold_seed(1111, 0) == 1111 and len({fold_seed(1111, f) for f in range(5)}) == 5


def _as_numpy(batch):
    return {k: v.detach().cpu().numpy().copy() for k, v in batch.items()}


def _assert_batch(got, want):
    assert set(got) >= {"image", "boxes", "labels", "valid"}
    for key in ("boxes", "labels", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("workers", [1, 2])
def test_fold_streams_match_jax(small_data, tmp_path, monkeypatch, workers):
    """The trainer with three folds, one iteration and its evaluation:
    fold 1's training batch (host augmentation, one thread or two worker
    processes) and validation-loss batch are those of JAX's loaders with
    seeds seed + 1 and seed + 101. The steps, the validation loss and the
    AP/IoBB sweep record their batches and return constants."""
    import gssd_torch.eval
    from gssd_torch.train import steps, trainer
    from gssd_tpu.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_tpu.data import dataset as jdata
    from gssd_tpu.data.augment import SSDAugmentation

    _quiet(monkeypatch)
    trained, validated, one = [], [], torch.tensor(1.0)

    def recording(model, opt, priors, batch, *a):
        trained.append(_as_numpy(batch))
        return {"loss": one, "loss_l": one, "loss_c": one, "grad_norm": one, "lr": 1e-3}

    def valid_recording(model, priors, batch, *a):
        validated.append(_as_numpy(batch))
        return {"loss": one, "loss_l": one, "loss_c": one}

    def no_sweep(*args, score_sink, **kw):
        score_sink.update(raw=np.zeros(1), filtered=np.zeros(1))
        return {"ap50": 0.0}

    monkeypatch.setattr(steps, "train_step", recording)
    monkeypatch.setattr(steps, "eval_step", valid_recording)
    monkeypatch.setattr(gssd_torch.eval, "run_detection_eval", no_sweep)
    seed, batch = 1111, 2
    trainer.main(["--reference_recipe", "gssd++", "--datapath", small_data,
                  "--num_test_subjects", "1", "--cross_validation", "3", "--batch_size",
                  str(batch), "--max_iter", "1", "--speedrun", "0", "--seed", str(seed),
                  "--num_workers", str(workers), "--compute_dtype", "float32",
                  "--device", "cpu", "--output", str(tmp_path)])
    assert len(trained) == len(validated) == 3

    split = DataSplitter(small_data, 3, 1)
    aug = SSDAugmentation(pixeljitter=0.0, seed=seed + 1)
    ds = LesionDataset(small_data, split.data_cv_train[1], transform=aug)
    loader = (jdata.MPBatchLoader(ds, batch, seed=seed + 1, num_workers=2) if workers > 1
              else jdata.BatchLoader(ds, batch, seed=seed + 1))
    want = {k: np.array(v) for k, v in next(iter(loader)).items()}
    getattr(loader, "shutdown", getattr(loader, "close", lambda: None))()
    _assert_batch(trained[1], want)
    assert not np.array_equal(trained[0]["image"], trained[1]["image"])

    vloader = jdata.BatchLoader(LesionDataset(small_data, split.data_cv_eval[1],
                                              transform=BaseTransform(300)),
                                batch, seed=seed + 101)
    _assert_batch(validated[1], {k: np.array(v) for k, v in next(iter(vloader)).items()})


# flax module of MiniDetector -> (the twin's submodule, its flax name)
_TWIN_NAMES = {"Conv_0": "s0", "BatchNorm_0": "s0", "Conv_1": "s1", "BatchNorm_1": "s1",
               "Conv_2": "s2", "BatchNorm_2": "s2", "Conv_3": "loc", "Conv_4": "conf"}


def _twin_tree(variables):
    """MiniDetector's variables renamed to the twin's layout (each conv
    and BatchNorm under its stage), leaves as numpy."""
    out = {}
    for col, tree in variables.items():
        out[col] = {}
        for name, leaves in tree.items():
            kind = "Conv_0" if name.startswith("Conv") else "BatchNorm_0"
            out[col].setdefault(_TWIN_NAMES[name], {})[kind] = jax.tree_util.tree_map(
                np.asarray, leaves)
    return out


def _twin_member(fold, stacked_np, priors):
    model = MiniTwin()
    load_jax_fold(model, stacked_np, fold)
    opt = make_optimizer(model, OptimConfig(**OPTIM))
    loss_cfg, optim_cfg = LossConfig(max_gt_boxes=4), OptimConfig(**OPTIM)
    return FoldMember(
        fold, model, opt,
        lambda batch, step: train_step(model, opt, priors, batch, loss_cfg, optim_cfg, step),
        None, None, None, None)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def mini_folds():
    """Three folds of the mini detector (JAX init from fold_in(0, f)),
    stacked; per fold two batches; JAX's vmapped step run twice."""
    model, priors = build_mini()
    jopt = JaxOptimConfig(**OPTIM)
    states = [create_train_state(model, jax.random.fold_in(jax.random.PRNGKey(0), f),
                                 jnp.zeros((1, 64, 64, 12)), jopt) for f in range(3)]
    stacked = stack_states(states)
    rng = np.random.default_rng(3)
    batches = [[mini_batch(rng, 2) for _ in range(3)] for _ in range(2)]
    vstep = jax.jit(vmap_train_step(make_train_step(model, priors, JaxLossConfig(max_gt_boxes=4),
                                                    jopt)))
    losses, new = [], stacked
    for step_batches in batches:
        folded = {k: np.stack([b[k] for b in step_batches]) for k in step_batches[0]}
        new, metrics = vstep(new, folded)
        losses.append(np.asarray(metrics["loss"]))
    return (_twin_tree(stacked.variables()), torch.from_numpy(np.asarray(priors)), batches,
            np.stack(losses, 1), new)


def test_fold_steps_match_vmap_train_step(mini_folds):
    """fold_train_step over three twins, two steps: each fold's losses and
    parameters within FOLD_TOL of JAX's vmapped step (unstack_state)."""
    stacked_np, priors, batches, want_losses, want_state = mini_folds
    members = [_twin_member(f, stacked_np, priors) for f in range(3)]
    losses = [[float(m["loss"]) for m in fold_train_step(members, [_tensors(b) for b in bs])]
              for bs in batches]
    assert [m.step for m in members] == [2, 2, 2]
    np.testing.assert_allclose(np.asarray(losses).T, want_losses, rtol=FOLD_TOL)
    assert not np.allclose(want_losses[0], want_losses[1])  # the folds differ
    for m in members:
        want = _twin_tree(unstack_state(want_state, m.fold).variables())
        got = m.model.state_dict()
        for name, value in want["params"].items():
            conv = value["Conv_0"]
            np.testing.assert_allclose(
                got[f"{name}.conv.weight"].numpy(), conv["kernel"].transpose(3, 2, 0, 1),
                rtol=0, atol=FOLD_TOL)
            np.testing.assert_allclose(got[f"{name}.conv.bias"].numpy(), conv["bias"],
                                       rtol=0, atol=FOLD_TOL)
            if "BatchNorm_0" in value:
                bn = value["BatchNorm_0"]
                np.testing.assert_allclose(got[f"{name}.bn.weight"].numpy(), bn["scale"],
                                           rtol=0, atol=FOLD_TOL)
                stats = want["batch_stats"][name]["BatchNorm_0"]
                np.testing.assert_allclose(got[f"{name}.bn.running_mean"].numpy(),
                                           stats["mean"], rtol=0, atol=FOLD_TOL)
                np.testing.assert_allclose(got[f"{name}.bn.running_var"].numpy(),
                                           stats["var"], rtol=0, atol=FOLD_TOL)


def test_folds_stepped_together_equal_each_alone(mini_folds):
    """Folds 0 and 2 advanced together by fold_train_step and each on its
    own, two steps: the same losses, state and momenta, bit for bit."""
    stacked_np, priors, batches, _, _ = mini_folds
    together = [_twin_member(f, stacked_np, priors) for f in (0, 2)]
    both = [fold_train_step(together, [_tensors(bs[0]), _tensors(bs[2])]) for bs in batches]
    for i, f in enumerate((0, 2)):
        alone = _twin_member(f, stacked_np, priors)
        for n, bs in enumerate(batches):
            m = fold_train_step([alone], [_tensors(bs[f])])[0]
            assert float(m["loss"]) == float(both[n][i]["loss"])
        got, want = together[i].model.state_dict(), alone.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        mom = [together[i].optimizer.state[p]["momentum_buffer"]
               for p in together[i].model.parameters()]
        assert all(torch.equal(a, alone.optimizer.state[p]["momentum_buffer"])
                   for a, p in zip(mom, alone.model.parameters()))


def test_two_fold_cli_means_checkpoints_test_and_resume(small_data, tmp_path, capsys,
                                                        monkeypatch):
    """python -m gssd_torch.train --cross_validation 2 on the CPU (the GSSD
    recipe, f32, batch 1, the device cache): two iterations with an
    evaluation at the second; a checkpoint a fold; the logged means are
    the means of the folds; --test evaluates both folds' checkpoints and
    prints their mean; --resume restores both folds (state and batch
    stream) exactly."""
    from gssd_torch.train import main, steps

    _quiet(monkeypatch)
    seen, states = [], []
    real = steps.train_step

    def recording(model, opt, priors, batch, *a):
        seen.append({k: v.clone() for k, v in batch.items()})
        if states is not None:
            states.append({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, opt, priors, batch, *a)

    monkeypatch.setattr(steps, "train_step", recording)
    argv = ["--reference_recipe", "gssd", "--datapath", small_data, "--num_test_subjects", "1",
            "--cross_validation", "2", "--batch_size", "1", "--eval_batch", "2",
            "--aug_method", "device_cached", "--compute_dtype", "float32", "--device", "cpu",
            "--output", str(tmp_path)]
    states = None
    first = main(argv + ["--max_iter", "2", "--val_every", "1", "--speedrun", "1"])
    text = capsys.readouterr().out
    assert [r["iter"] for r in first["records"]] == [0, 1] and first["step"] == 2
    for r in first["records"]:
        assert len(r["folds"]) == 2 and all(np.isfinite(f["loss"]) for f in r["folds"])
        assert r["loss"] == pytest.approx(np.mean([f["loss"] for f in r["folds"]]), rel=1e-12)
    assert "iter 1: loss=" in text and "ms/iteration (2 steps)" in text
    ev = first["evals"][0]
    paths = [p["checkpoint"] for p in ev["folds"]]
    assert [p.rsplit("_", 1)[1] for p in paths] == ["CV0.pt", "CV1.pt"]
    assert all(tmp_path.joinpath("checkpoints", "GSSD", f"GSSD_1_CV{f}.pt").exists()
               for f in (0, 1))
    for split in ("valid", "test"):
        assert ev[split] == fold_mean([p[split] for p in ev["folds"]])
        logged = re.search(rf"iter 1 {split}: +(\{{.*\}})", text).group(1)
        assert json.loads(logged) == ev[split]
    assert "iter 1 fold 0 valid:" in text and "iter 1 fold 1 valid:" in text
    assert first["folds"][0].model is not first["folds"][1].model

    tested = main(argv + ["--test", "True", "--checkpoint", "1"])
    text = capsys.readouterr().out
    assert tested["folds"] == [p["test"] for p in ev["folds"]]
    assert tested["test"] == fold_mean(tested["folds"])
    assert "[fold 0]" in text and "[fold 1]" in text
    assert json.loads(text.split("test mean over folds:")[1].splitlines()[0]) == tested["test"]

    states = []
    resumed = main(argv + ["--max_iter", "2", "--speedrun", "5", "--resume", "1"])
    assert "resumed from iteration 1 (step [2, 2])" in capsys.readouterr().out
    assert [r["iter"] for r in resumed["records"]] == [1] and resumed["step"] == 3
    assert [m.step for m in resumed["folds"]] == [3, 3] and len(seen) == 6
    for f in (0, 1):
        want = first["folds"][f].model.state_dict()
        assert all(torch.equal(states[f][k], want[k]) for k in want), f
        for key in ("image", "boxes", "valid"):
            assert torch.equal(seen[4 + f][key], seen[2 + f][key]), (f, key)
    assert not torch.equal(seen[4]["image"], seen[5]["image"])
