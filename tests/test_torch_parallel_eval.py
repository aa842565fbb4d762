"""The evaluation forward split over the ranks (``gssd_torch.parallel.mesh``
``plan_infer_step``, JAX's ``jit_plan_infer_step``), on the CPU.

- tests/mini_model.py's detector, the same weights in both packages:
  JAX's ``jit_plan_infer_step`` over 2 virtual CPU devices against the
  port's step on 2 gloo ranks, at eval_batch 4 over 5 images (the tail
  chunk padded): every chunk's detections within SPLIT_TOL (f32 on both
  sides), ``run_detection_eval``'s dict equal. In the same launch: a
  tuple of outputs comes back in row order, no rank runs zero rows, and
  a batch the ranks do not divide is not split.
- The trainers: ``--test`` of gssd_torch.train and of
  gssd_torch.train_pixellink on 2 ranks equal to their one-rank
  ``--test`` (the tail chunk padded), with the line that says how the
  evaluation runs; ``--eval_batch 3`` on 2 ranks runs in one process and
  says so; the PixelLink++ trainer's evaluation on 2 ranks equal to one
  rank's. The spawned ranks take the parent's ``USE_WIDE_CONV_KERNEL``.

Four rank launches, each with a deadline; the ranks run
tests/torch_ranks.py's bodies, with TensorBoard's import blocked.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mini_model import build_mini
from test_torch_folds import OPTIM, _twin_tree
from torch_ranks import MiniTwin, pair, pair_input, quiet_pixellink, quiet_train, split_eval

from gssd_torch.parallel.launch import launch
from gssd_torch.parallel.mesh import plan_parallelism
from gssd_torch.params import load_jax_fold
from gssd_tpu.config import DetectConfig as JaxDetectConfig
from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.data import BaseTransform as JaxBaseTransform
from gssd_tpu.data import LesionDataset as JaxLesionDataset
from gssd_tpu.eval import run_detection_eval as jax_run_detection_eval
from gssd_tpu.parallel.folds import stack_states
from gssd_tpu.parallel.mesh import jit_plan_infer_step
from gssd_tpu.parallel.mesh import plan_parallelism as jax_plan_parallelism
from gssd_tpu.train import create_train_state
from gssd_tpu.train.steps import make_infer_step

SPLIT_TOL = 1e-5
# seconds a launch of two ranks may take (spawn, imports, the evaluation),
# with six test workers beside it
DEADLINE_S = 300


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    from gssd_torch.data import make_synthetic_dataset

    data = tmp_path_factory.mktemp("ml_split_eval")
    make_synthetic_dataset(str(data), num_subjects=10, slices_per_subject=1, image_size=64)
    return str(data)


def test_split_forward_matches_jax(eval_data):
    from gssd_torch.data import DataSplitter

    ids = DataSplitter(eval_data, 1, 5).data_test
    assert len(ids) == 5
    model, priors = build_mini()
    state = create_train_state(model, jax.random.PRNGKey(3), np.zeros((1, 64, 64, 12), np.float32),
                               JaxOptimConfig(**OPTIM))
    jplan = jax_plan_parallelism(1, 4, devices=jax.devices()[:2])
    assert jplan.n_shards == 2
    jstep = jit_plan_infer_step(make_infer_step(model, priors, JaxDetectConfig()), jplan, 4)
    chunks = []

    def jax_infer(batch):
        chunks.append(np.asarray(jstep(state, jnp.asarray(batch))))
        return chunks[-1]

    want_ap = jax_run_detection_eval(jax_infer, JaxLesionDataset(eval_data, ids),
                                     JaxBaseTransform(64, 0.0, False, True), batch_size=4)
    # JAX pads the tail chunk to 4 rows; the port pads it to the rank count
    want = np.concatenate([chunks[0], chunks[1][:1]])

    twin = MiniTwin()
    load_jax_fold(twin, _twin_tree(stack_states([state]).variables()), 0)
    got = launch(split_eval, plan_parallelism(1, 4, devices=["cpu"] * 2), twin.state_dict(),
                 np.asarray(priors), eval_data, ids, 64, 4, deadline=DEADLINE_S)
    assert want.shape == got[0]["detections"].shape == (5, 2, 200, 5)
    assert (want[:, 1, :, 0] > 0.2).sum() > 100  # detections to rank
    for r in got:
        np.testing.assert_allclose(r["detections"], want, rtol=0, atol=SPLIT_TOL)
        assert r["ap"] == want_ap
        assert r["not_split"]
        # 4 rows split 2 + 2; 1 row padded to 2, one a rank
        assert r["rows_seen"] == [2, 1]
    assert np.array_equal(got[0]["detections"], got[1]["detections"])
    x = pair_input()
    for r in got:
        for chunk, (a, b) in zip((x[:4], x[4:]), r["pairs"]):
            want_a, want_b = pair(chunk)
            assert torch.equal(a, want_a) and torch.equal(b, want_b)


@pytest.mark.parametrize("n,eval_batch,split,line", [
    (1, 16, False, "evaluation: each fold on the one rank that holds it"),
    (2, 16, True, "evaluation: each batch of 16 split over 2 ranks"),
    (4, 6, False, "evaluation: on one rank: --eval_batch 6 does not divide by 4 ranks"),
    (3, 6, True, "evaluation: each batch of 6 split over 3 ranks")])
def test_split_rule_and_its_line(n, eval_batch, split, line):
    """JAX's rule: split only when the rank count divides the batch; the
    --test plan splits over every device of the training plan, or runs
    on the first alone."""
    from gssd_torch.parallel.mesh import describe_eval, eval_splits, evaluation_plan

    assert eval_splits(n, eval_batch) == split and describe_eval(n, eval_batch) == line
    jplan = jax_plan_parallelism(2, 4, devices=jax.devices()[:n])
    want = jplan.n_shards if eval_batch % jplan.n_shards == 0 else 1
    plan = evaluation_plan(plan_parallelism(2, 4, devices=["cpu"] * n), eval_batch)
    assert plan.world_size == want
    assert all(plan.folds(r) == [0, 1] for r in range(plan.world_size))


def _argv(data, out, *extra):
    return ["--datapath", data, "--num_test_subjects", "3", "--batch_size", "2",
            "--eval_batch", "2", "--compute_dtype", "float32", "--device", "cpu",
            "--output", str(out), *extra]


GSSD = ("--reference_recipe", "gssd", "--aug_method", "device_cached")
PIXELLINK = ("--reference_recipe", "pixellink++", "--ssd_dim", "64", "--dcn_impl", "xla")
ONE_STEP = ("--max_iter", "1", "--val_every", "1", "--speedrun", "0")


def _two_ranks(body, args):
    """``body`` (a trainer's rank body) through ``launch_trainer`` on 2
    gloo ranks, within the deadline."""
    from gssd_torch.train.trainer import launch_trainer

    t0 = time.monotonic()
    res = launch_trainer(body, args, devices=["cpu"] * 2)
    assert time.monotonic() - t0 < DEADLINE_S
    return res


def test_gssd_test_two_ranks_equal_one(eval_data, tmp_path, monkeypatch, capfd):
    """gssd_torch.train --test on 2 ranks (each batch of 2 split 1 + 1,
    the 3rd image padded) equals its one-rank --test; at --eval_batch 3
    the 2 ranks' --test runs in one process and says so."""
    from gssd_torch.train import main
    from gssd_torch.train.trainer import parse_args

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    main(_argv(eval_data, tmp_path, *GSSD, *ONE_STEP))
    test = ("--test", "True", "--checkpoint", "0")
    one = main(_argv(eval_data, tmp_path, *GSSD, *test))
    capfd.readouterr()
    two = _two_ranks(quiet_train, parse_args(_argv(eval_data, tmp_path, *GSSD, *test)))
    assert "--test evaluation: each batch of 2 split over 2 ranks" in capfd.readouterr().out
    assert len(two["ranks"]) == 2 and two["ranks"][0]["state_digests"] == []
    assert set(one["test"]) == {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}
    for r in two["ranks"]:
        assert r["test"] == one["test"] and r["folds"] == one["folds"]

    monkeypatch.setenv("GSSD_DP_DEVICES", "2")
    alone = main(_argv(eval_data, tmp_path, *GSSD, *test, "--eval_batch", "3"))
    text = capfd.readouterr().out
    assert "parallelism: mesh(data=2) layout=data" in text
    assert "--test evaluation: on one rank: --eval_batch 3 does not divide by 2 ranks" in text
    assert "ranks" not in alone and alone["test"] == one["test"]


def test_pixellink_test_two_ranks_equal_one(eval_data, tmp_path, monkeypatch, capfd):
    """gssd_torch.train_pixellink --test on 2 ranks (the pixel and link
    logits gathered in row order) equals its one-rank --test, a non-zero
    IoBB included."""
    from gssd_torch.train_pixellink import main, parse_args

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    main(_argv(eval_data, tmp_path, *PIXELLINK, *ONE_STEP))
    test = ("--test", "True", "--checkpoint", "0")
    one = main(_argv(eval_data, tmp_path, *PIXELLINK, *test))
    assert one["test"]["iobb50"] > 0  # boxes to rank
    capfd.readouterr()
    two = _two_ranks(quiet_pixellink, parse_args(_argv(eval_data, tmp_path, *PIXELLINK, *test)))
    assert "--test evaluation: each batch of 2 split over 2 ranks" in capfd.readouterr().out
    for r in two["ranks"]:
        assert r["test"] == one["test"]


def test_pixellink_evaluation_two_ranks_equal_one(eval_data, tmp_path, monkeypatch, capfd):
    """gssd_torch.train_pixellink trained one step on 2 ranks, evaluated
    split over them, against the same run on one rank: the AP/IoBB of the
    validation and test sets equal (the two ranks' weights agree with one
    rank's to f32 rounding), the ranks' states bit-equal."""
    from gssd_torch.train_pixellink import main, parse_args

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("GSSD_DP_DEVICES", "1")
    one = main(_argv(eval_data, tmp_path / "one", *PIXELLINK, *ONE_STEP))
    capfd.readouterr()
    two = _two_ranks(quiet_pixellink,
                     parse_args(_argv(eval_data, tmp_path / "two", *PIXELLINK, *ONE_STEP)))
    assert "evaluation: each batch of 2 split over 2 ranks" in capfd.readouterr().out
    assert two["ranks"][0]["state_digests"] == two["ranks"][1]["state_digests"]
    assert one["evals"][0]["test"]["iobb50"] > 0
    for key in ("valid", "test"):
        assert two["evals"][0][key] == one["evals"][0][key], key


def test_spawned_ranks_take_the_wide_conv_switch(monkeypatch):
    """A rank's run (``_spawned_run``) sets ``USE_WIDE_CONV_KERNEL`` to the
    launching process's value: a spawned process would start from the
    module's default, and PixelLink++'s stem kernels would not run there."""
    import argparse

    from gssd_torch.ops import layers
    from gssd_torch.parallel.launch import Rank
    from gssd_torch.train.trainer import _spawned_run

    monkeypatch.setattr(layers, "USE_WIDE_CONV_KERNEL", False)
    args = argparse.Namespace(test=True, device="cpu")
    rank = Rank(plan_parallelism(1, 2, devices=["cpu"]))
    for wide in (True, False):
        res = _spawned_run(rank, lambda r, a: {"wide": layers.USE_WIDE_CONV_KERNEL}, args, wide)
        assert res["wide"] is wide and res["state_digests"] == []
