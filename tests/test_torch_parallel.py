"""Data parallelism of the port (``gssd_torch.parallel.mesh``,
``launch``, ``collectives``) against the JAX package's, on the CPU.

- The plan: layout, ``describe()``, each rank's folds and rows equal to
  those of JAX's ``plan_parallelism`` over the 8 virtual CPU devices, on
  a grid of fold counts, batches and device counts.
- The steps: tests/mini_model.py's detector (it has BatchNorm) carried
  into the torch twin, two steps through the launcher on gloo ranks
  against JAX's sharded step (``jit_plan_train_step`` of the vmapped
  step): ``data`` (2 ranks x 2 rows) and ``fold_data`` (2 folds x 2
  ranks). Every rank's losses, parameters, BatchNorm running statistics
  and momenta within FOLD_TOL of JAX's (f32 on both sides, sums in
  another order: tests/test_torch_folds.py's tolerance); the ranks of a
  fold bit-equal.
- The shares: one step on 2 ranks against the same step unsplit in the
  port: the MultiBox loss and gradients, the PixelLink loss and its
  logits' gradients, a BatchNorm's output and input gradient.
- The trainer CLI on 2 and 4 gloo ranks (``GSSD_DP_DEVICES``), and the
  launcher failing fast; the VOC trainer's evaluation split over 2 ranks
  against a one-rank ``--test`` of its checkpoint.

The ranks run tests/torch_ranks.py's bodies: a spawned rank imports
neither JAX nor gssd_tpu. Every launch has a deadline.
"""

import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch
from mini_model import MINI_ANCHORS, build_mini, mini_batch
from test_torch_folds import OPTIM, _twin_tree
from torch_ranks import (MINI_PRIORS_PER_CELL, MiniTwin, build_mini_voc, fails, mini_voc, shares,
                         twin_steps)

from gssd_torch.parallel.launch import launch
from gssd_torch.parallel.mesh import plan_parallelism, usable_devices
from gssd_tpu.config import LossConfig as JaxLossConfig
from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.parallel.folds import stack_states, unstack_state, vmap_train_step
from gssd_tpu.parallel.mesh import jit_plan_train_step
from gssd_tpu.parallel.mesh import plan_parallelism as jax_plan_parallelism
from gssd_tpu.train import create_train_state, make_train_step

FOLD_TOL = 1e-5
SHARE_TOL = 1e-5
# seconds a launch of mini-size ranks may take (spawn, imports, two steps),
# and a trainer run at the CLI tests' size, with six test workers beside it
DEADLINE_S = 240
CLI_DEADLINE_S = 600
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_ranks(plan, n_folds, batch):
    """{rank: (folds, rows)} of a JAX plan: rank r is the r-th device of
    the mesh in row-major order, its part of a [K, B] fold batch."""
    if plan.mesh is None:
        return {0: (list(range(n_folds)), list(range(batch)))}
    index = plan.batch_sharding().devices_indices_map((n_folds, batch))
    return {r: (list(range(n_folds))[index[d][0]], list(range(batch))[index[d][1]])
            for r, d in enumerate(plan.mesh.devices.reshape(-1))}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 4, 6, 8, 32])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_plan_matches_jax(k, batch, n):
    want = jax_plan_parallelism(k, batch, devices=jax.devices()[:n])
    got = plan_parallelism(k, batch, devices=["cpu"] * n)
    assert (got.layout, got.describe()) == (want.layout, want.describe())
    ranks = _jax_ranks(want, k, batch)
    assert got.world_size == len(ranks)
    for r, (folds, rows) in ranks.items():
        assert got.folds(r) == folds, r
        assert list(range(batch))[got.rows(r)] == rows, r
        # the fold's group: the ranks with the same folds
        assert got.fold_ranks(r) == [q for q, (f, _) in ranks.items() if f == folds]


def test_device_count_and_cap(monkeypatch):
    monkeypatch.delenv("GSSD_DP_DEVICES", raising=False)
    assert usable_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("GSSD_DP_DEVICES", "3")
    assert usable_devices("cpu") == [torch.device("cpu")] * 3
    assert plan_parallelism(1, 6, device="cpu").describe() == "mesh(data=3)"
    # an explicit list is taken as given
    plan = plan_parallelism(1, 8, devices=["cpu"] * 4)
    assert (plan.describe(), plan.backend) == ("mesh(data=4)", "gloo")
    assert MINI_PRIORS_PER_CELL == MINI_ANCHORS.num_priors_per_cell[0]


def _trace(state):
    """The momentum tree (optax ``trace``) of a JAX state."""
    found = [leaf.trace for leaf in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(leaf, optax.TraceState)]
    assert len(found) == 1
    return found[0]


def _flat(params):
    """Twin-layout flax params -> {torch parameter name: numpy value}."""
    out = {}
    for name, value in params.items():
        conv = value["Conv_0"]
        out[f"{name}.conv.weight"] = conv["kernel"].transpose(3, 2, 0, 1)
        out[f"{name}.conv.bias"] = conv["bias"]
        if "BatchNorm_0" in value:
            out[f"{name}.bn.weight"] = value["BatchNorm_0"]["scale"]
            out[f"{name}.bn.bias"] = value["BatchNorm_0"]["bias"]
    return out


def _want(state):
    """A JAX fold state as the twin's state_dict and momenta (numpy)."""
    tree = _twin_tree(state.variables())
    want = _flat(tree["params"])
    for name, stats in tree["batch_stats"].items():
        want[f"{name}.bn.running_mean"] = stats["BatchNorm_0"]["mean"]
        want[f"{name}.bn.running_var"] = stats["BatchNorm_0"]["var"]
    return want, _flat(_twin_tree({"params": _trace(state)})["params"])


@pytest.mark.parametrize("k,n", [(1, 2), (2, 4)], ids=["data", "fold_data"])
def test_ranks_match_jax_sharded_step(k, n):
    """k folds at batch 4 over n devices: JAX's sharded vmapped step
    against the port's n gloo ranks, two steps."""
    model, priors = build_mini()
    jopt = JaxOptimConfig(**OPTIM)
    states = [create_train_state(model, jax.random.fold_in(jax.random.PRNGKey(0), f),
                                 np.zeros((1, 64, 64, 12), np.float32), jopt) for f in range(k)]
    stacked = stack_states(states)
    stacked_np = _twin_tree(stacked.variables())
    rng = np.random.default_rng(7)
    batches = [[mini_batch(rng, 4) for _ in range(k)] for _ in range(2)]

    jplan = jax_plan_parallelism(k, 4, devices=jax.devices()[:n])
    assert jplan.layout == ("data" if k == 1 else "fold_data")
    step = jit_plan_train_step(vmap_train_step(make_train_step(
        model, priors, JaxLossConfig(max_gt_boxes=4), jopt)), jplan, donate=False)
    new, want_losses = jplan.put_state(stacked), []
    for step_batches in batches:
        new, metrics = step(new, {key: np.stack([b[key] for b in step_batches])
                                  for key in step_batches[0]})
        want_losses.append(np.asarray(metrics["loss"]))

    plan = plan_parallelism(k, 4, devices=["cpu"] * n)
    assert (plan.layout, plan.describe()) == (jplan.layout, jplan.describe())
    got = launch(twin_steps, plan, stacked_np, batches, np.asarray(priors), OPTIM,
                 deadline=DEADLINE_S)
    for f in range(k):
        want, want_mom = _want(unstack_state(new, f))
        ranks = [r for r in range(n) if f in plan.folds(r)]
        assert len(ranks) == 2
        for r in ranks:
            np.testing.assert_allclose(got[r]["losses"][f], np.asarray(want_losses)[:, f],
                                       rtol=FOLD_TOL)
            state, mom = got[r]["state"][f], got[r]["momenta"][f]
            for name, value in want.items():
                np.testing.assert_allclose(state[name].numpy(), value, rtol=0, atol=FOLD_TOL,
                                           err_msg=f"rank {r} {name}")
            for name, value in want_mom.items():
                np.testing.assert_allclose(mom[name].numpy(), value, rtol=0, atol=FOLD_TOL,
                                           err_msg=f"rank {r} momentum {name}")
        first, other = got[ranks[0]], got[ranks[1]]
        assert first["losses"][f] == other["losses"][f]
        assert all(torch.equal(first["state"][f][key], other["state"][f][key])
                   for key in first["state"][f])
        assert all(torch.equal(first["momenta"][f][key], other["momenta"][f][key])
                   for key in first["momenta"][f])


def test_shares_equal_the_unsplit_step():
    """One step at batch 4 on 2 ranks of 2 rows against the same step
    unsplit: the MultiBox loss and the summed gradients, the PixelLink
    loss and its logits' gradient, and a BatchNorm's output and input
    gradient, each within SHARE_TOL (of the largest value for arrays). A
    loss normalised over the rank's rows or a BatchNorm backward without
    the other rank's terms reads far above it."""
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    state = MiniTwin().state_dict()
    _, priors = build_mini()
    B, H = 4, 8
    batch = mini_batch(rng, B)
    bn_x = rng.normal(1.0, 2.0, (B, 6, 5, 5)).astype(np.float32)
    bn_w = rng.normal(size=bn_x.shape).astype(np.float32)
    logits = {"pixel": rng.normal(size=(B, H, H, 2)).astype(np.float32),
              "link": rng.normal(size=(B, H, H, 16)).astype(np.float32)}
    pos = (rng.uniform(size=(B, H, H)) < 0.2).astype(np.int32)
    pos[0] = 0  # an image with no positive: the 10000-negative budget
    targets = {"pixel_mask": pos, "neg_pixel_mask": 1 - pos,
               "pixel_pos_weight": pos * rng.uniform(0.5, 2.0, pos.shape).astype(np.float32),
               "link_mask": (rng.uniform(size=(B, 8, H, H)) < 0.5).astype(np.int32)}
    args = (state, batch, np.asarray(priors), bn_x, bn_w, logits, targets)
    one = launch(shares, plan_parallelism(1, B, devices=["cpu"]), *args)[0]
    two = launch(shares, plan_parallelism(1, B, devices=["cpu"] * 2), *args,
                 deadline=DEADLINE_S)

    for part in ("multibox", "pixellink"):
        for key, value in one[part].items():
            assert two[0][part][key] == two[1][part][key]
            assert two[0][part][key] == pytest.approx(value, rel=SHARE_TOL), (part, key)
    scale = max(float(g.abs().max()) for g in one["grads"])
    for g1, g2, g3 in zip(one["grads"], two[0]["grads"], two[1]["grads"]):
        assert torch.equal(g2, g3)
        np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=0, atol=SHARE_TOL * scale)
    for key in ("pixel_grad", "link_grad", "bn_y", "bn_dx"):
        joined = torch.cat([two[0][key], two[1][key]]).numpy()
        np.testing.assert_allclose(joined, one[key].numpy(), rtol=0,
                                   atol=SHARE_TOL * float(one[key].abs().max()), err_msg=key)
    for got, want in zip(two[0]["bn_running"], one["bn_running"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SHARE_TOL, atol=1e-7)


@pytest.fixture(scope="module")
def dp_data(tmp_path_factory):
    from gssd_torch.data import make_synthetic_dataset

    data = tmp_path_factory.mktemp("ml_dp")
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    return str(data)


def _argv(data, out, *extra):
    return ["--reference_recipe", "gssd", "--datapath", data, "--num_test_subjects", "1",
            "--batch_size", "2", "--eval_batch", "2", "--aug_method", "device_cached",
            "--compute_dtype", "float32", "--device", "cpu", "--output", str(out), *extra]


def test_trainer_cli_two_ranks_equal_one(dp_data, tmp_path, monkeypatch, capfd):
    """gssd_torch.train on 2 gloo ranks (GSSD_DP_DEVICES=2) at batch 2:
    the parallelism line, the losses of the one-rank run within 1e-5
    relative, the ranks' states bit-equal, the evaluation split over the
    ranks with the AP/IoBB of the one-rank run, and a checkpoint that a
    one-rank --resume and gssd_torch.infer load."""
    from gssd_torch import infer
    from gssd_torch.train import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    steps = ["--max_iter", "2", "--val_every", "1", "--speedrun", "1"]
    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    one = main(_argv(dp_data, tmp_path / "one", *steps))
    assert "parallelism: single-device layout=single" in capfd.readouterr().out
    monkeypatch.setenv("GSSD_DP_DEVICES", "2")
    t0 = time.monotonic()
    two = main(_argv(dp_data, tmp_path / "two", *steps))
    assert time.monotonic() - t0 < CLI_DEADLINE_S
    text = capfd.readouterr().out
    assert "parallelism: mesh(data=2) layout=data" in text and "2 ranks" in text
    assert len(two["ranks"]) == 2 and "model" not in two
    assert two["ranks"][0]["state_digests"] == two["ranks"][1]["state_digests"]
    for r1, r2 in zip(one["records"], two["records"]):
        for key in ("loss", "loss_l", "loss_c"):
            assert r2[key] == pytest.approx(r1[key], rel=1e-5), (r1["iter"], key)
    assert two["valid"][0]["loss"] == pytest.approx(one["valid"][0]["loss"], rel=1e-5)
    # the evaluation split over the two ranks: the AP/IoBB of one rank
    assert "evaluation: each batch of 2 split over 2 ranks" in text
    for key in ("valid", "test"):
        assert two["evals"][0][key] == one["evals"][0][key], key
    ckpt = two["evals"][0]["checkpoint"]
    assert ckpt.endswith("GSSD_1_CV0.pt") and os.path.exists(ckpt)

    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    resumed = main(_argv(dp_data, tmp_path / "two", "--max_iter", "2", "--speedrun", "5",
                         "--resume", "1"))
    assert resumed["step"] == 3 and np.isfinite(resumed["records"][0]["loss"])
    det_path = tmp_path / "dets.json"
    infer.main(["--reference_recipe", "gssd", "--datapath", dp_data, "--num_test_subjects", "1",
                "--eval_batch", "1", "--compute_dtype", "float32", "--weights", ckpt,
                "--device", "cpu", "--det_output", str(det_path)])
    assert det_path.exists()


def test_trainer_cli_fold_data_four_ranks(dp_data, tmp_path):
    """python -m gssd_torch.train --cross_validation 2 on 4 gloo ranks:
    the fold_data line, finite losses and both folds' checkpoints."""
    env = dict(os.environ, GSSD_DP_DEVICES="4")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-m", "gssd_torch.train",
                          *_argv(dp_data, tmp_path, "--cross_validation", "2", "--max_iter", "1",
                                 "--speedrun", "0")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=CLI_DEADLINE_S)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "parallelism: mesh(fold=2, data=2) layout=fold_data" in res.stdout
    losses = [float(x) for x in re.findall(r"iter 0: loss=([-\d.naif]+)", res.stdout)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert all((tmp_path / "checkpoints" / "GSSD" / f"GSSD_0_CV{f}.pt").exists()
               for f in (0, 1))
    assert "iter 0 fold 0 valid:" in res.stdout and "iter 0 fold 1 valid:" in res.stdout


@pytest.mark.parametrize("when", ["before", "after"])
def test_launcher_fails_fast(when, tmp_path):
    """A rank that raises before its first collective, or after one,
    makes the launcher raise its error within seconds, with the other
    rank (waiting in a collective) stopped: no process is left."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"rank 1 of 2 failed first:\n(.|\n)*rank 1 fails {when}"):
        launch(fails, plan_parallelism(1, 2, devices=["cpu"] * 2), when, str(tmp_path),
               deadline=DEADLINE_S)
    assert time.monotonic() - t0 < 60
    pids = [int((tmp_path / f"{r}.pid").read_text()) for r in range(2)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("module", ["train_pixellink", "train_voc"])
def test_trainer_prints_the_plan_and_raises_a_rank_error(module, tmp_path, monkeypatch, capfd):
    """The PixelLink++ and VOC trainers on 2 gloo ranks print JAX's
    parallelism line, and a rank that fails (no data where the flags point)
    makes main raise that rank's error."""
    import importlib

    main = importlib.import_module(f"gssd_torch.{module}").main
    monkeypatch.setenv("GSSD_DP_DEVICES", "2")
    data = ["--datapath", str(tmp_path / "none")] if module == "train_pixellink" else [
        "--voc_root", str(tmp_path / "none")]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed first:(.|\n)*(FileNotFound|No such)"):
        main([*data, "--batch_size", "2", "--max_iter", "1", "--compute_dtype", "float32",
              "--device", "cpu", "--output", str(tmp_path / "out")])
    assert time.monotonic() - t0 < DEADLINE_S
    assert "parallelism: mesh(data=2) layout=data" in capfd.readouterr().out


def test_voc_split_evaluation_equals_one_rank(tmp_path, monkeypatch, capfd):
    """gssd_torch.train_voc on 2 gloo ranks (tests/test_torch_voc.py's
    tree, its mini detector at 64) trained 13 steps, evaluated at the last
    split over the ranks: the mAP of a one-rank --test of the checkpoint
    it wrote, on both ranks."""
    from mini_model import MINI_ANCHORS as JAX_MINI_ANCHORS
    from test_torch_voc import OBJECTS
    from torch_ranks import MINI_ANCHORS

    import gssd_torch.models as models_pkg
    from gssd_torch import train_voc
    from gssd_torch.data.voc import write_voc_tree
    from gssd_torch.train.trainer import launch_trainer

    assert all(getattr(MINI_ANCHORS, f) == getattr(JAX_MINI_ANCHORS, f)
               for f in ("feature_maps", "min_dim", "steps", "min_sizes", "max_sizes"))
    write_voc_tree(str(tmp_path / "voc"), OBJECTS)
    argv = ["--voc_root", str(tmp_path / "voc"), "--eval_sets", "2007:trainval", "--ssd_dim",
            "64", "--batch_size", "2", "--max_gt", "8", "--eval_batch", "2",
            "--compute_dtype", "float32", "--device", "cpu", "--output", str(tmp_path / "out")]
    t0 = time.monotonic()
    two = launch_trainer(mini_voc, train_voc.parse_args(argv + ["--max_iter", "13",
                                                               "--val_every", "100"]),
                         devices=["cpu"] * 2)
    assert time.monotonic() - t0 < DEADLINE_S
    assert "evaluation: each batch of 2 split over 2 ranks" in capfd.readouterr().out
    assert [e["iter"] for e in two["evals"]] == [12]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(models_pkg, "build_model", build_mini_voc)
    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    tested = train_voc.main(argv + ["--test", "True", "--checkpoint", "12"])
    assert {"ap_dog", "ap_cat", "ap_person"} <= set(tested["voc_map"])
    for rank in two["ranks"]:
        assert rank["voc_map"] == tested["voc_map"]
