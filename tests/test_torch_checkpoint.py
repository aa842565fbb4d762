"""The port's checkpoints (gssd_torch.train.checkpoint) and the trainer's
evaluation half on the CPU: an exact save/restore round trip of
parameters, BatchNorm statistics, spectral-norm vectors, momenta and
step; a shape-filtered partial load; and ``python -m gssd_torch.train``
end to end: 2 steps with evaluation and a checkpoint, ``--resume`` from
it at the stored step's LR, then ``--test --checkpoint``. The CLI runs
the GSSD recipe (no attention, no DCN) to stay cheap on a CPU; the
GSSD++ recipe's evaluation runs in tests/test_torch_train.py."""

import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from gssd_torch.config import OptimConfig
from gssd_torch.ops.deform_conv import DCN
from gssd_torch.ops.layers import ConvBNRelu, SelfAttention
from gssd_torch.train import make_optimizer
from gssd_torch.train.checkpoint import (checkpoint_path, load_weights_partial,
                                         restore_checkpoint, save_checkpoint)

KEYS = {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}


class _Tiny(nn.Module):
    """A conv with BatchNorm, an attention block (four spectral-norm
    layers) and a DCN: every kind of state a GSSD++ checkpoint holds."""

    def __init__(self, c_out=8, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = ConvBNRelu(4, 8, 3, padding=1, use_bn=True, generator=gen)
        self.attn = SelfAttention(8, generator=gen)
        self.dcn_0 = DCN(8, c_out, deformable_groups=2, impl="xla", generator=gen)

    def forward(self, x):
        x = self.attn(self.conv(x))[0]
        return self.dcn_0(x)[0]


def _trained(seed):
    torch.manual_seed(seed)
    model = _Tiny(seed=seed).train()
    with torch.no_grad():
        model.attn.sigma.fill_(0.5)
    opt = make_optimizer(model, OptimConfig(modify_dcn_lr=True))
    for _ in range(2):
        opt.zero_grad()
        model(torch.randn(2, 4, 6, 6)).square().mean().backward()
        opt.step()
    return model, opt


def test_checkpoint_round_trip_is_exact(tmp_path):
    model, opt = _trained(0)
    path = save_checkpoint(model, opt, 7, str(tmp_path), "tiny", 5, 0)
    assert path == checkpoint_path(str(tmp_path), "tiny", 5, 0)
    assert path.endswith("tiny/tiny_5_CV0.pt")

    fresh = _Tiny(seed=1)
    fresh_opt = make_optimizer(fresh, OptimConfig(modify_dcn_lr=True))
    assert not torch.equal(fresh.attn.theta.u, model.attn.theta.u)
    step = restore_checkpoint(fresh, fresh_opt, str(tmp_path), "tiny", 5, 0)
    assert step == 7
    want, got = model.state_dict(), fresh.state_dict()
    assert set(got) == set(want)
    assert {"conv.bn.running_mean", "conv.bn.running_var", "attn.theta.u",
            "attn.out.v", "dcn_0.weight"} <= set(got)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    ws, gs = opt.state_dict(), fresh_opt.state_dict()
    assert len(gs["state"]) == len(ws["state"]) == len(list(model.parameters()))
    for i, st in ws["state"].items():
        assert torch.equal(gs["state"][i]["momentum_buffer"], st["momentum_buffer"])
    assert [g["lr_scale"] for g in gs["param_groups"]] == [1.0, 0.1]
    with pytest.raises(FileNotFoundError, match="tiny_5_CV0.pt"):
        restore_checkpoint(fresh, fresh_opt, str(tmp_path), "tiny", 6, 0)


def test_partial_load_skips_mismatched_shapes(tmp_path, capsys):
    model, opt = _trained(0)
    path = save_checkpoint(model, opt, 2, str(tmp_path), "tiny", 1)
    other = _Tiny(c_out=4, seed=3)  # another DCN width: its weight and bias differ
    other.extra = nn.Linear(2, 2)  # not in the checkpoint
    before = {k: v.clone() for k, v in other.state_dict().items()}
    load_weights_partial(other, path)
    text = capsys.readouterr().out
    got, stored = other.state_dict(), model.state_dict()
    skipped = {"dcn_0.weight", "dcn_0.bias", "extra.weight", "extra.bias"}
    for name in got:
        if name in skipped:
            assert torch.equal(got[name], before[name]), name
            assert f"WARNING: {'shape of stored ' if 'dcn' in name else ''}{name}" in text
        else:
            assert torch.equal(got[name], stored[name]), name
    assert text.count("WARNING") == len(skipped)


def test_trainer_eval_checkpoint_resume_and_test(tmp_path, capsys, monkeypatch):
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.train import main

    data = tmp_path / "ml"
    make_synthetic_dataset(str(data), num_subjects=6, slices_per_subject=1, image_size=64)
    out = tmp_path / "run"
    # text logs only: where TensorBoard is installed its import can pull in
    # TensorFlow (tens of seconds); the logger runs without it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    common = ["--reference_recipe", "gssd", "--datapath", str(data),
              "--num_test_subjects", "1", "--batch_size", "1", "--val_every", "1",
              "--speedrun", "0", "--compute_dtype", "float32", "--device", "cpu",
              "--output", str(out), "--model_name", "gssd",
              "--stepvalues", "2", "--eval_batch", "2"]
    first = main(common + ["--max_iter", "2"])
    assert [e["iter"] for e in first["evals"]] == [1] and first["step"] == 2
    ev = first["evals"][0]
    assert set(ev["valid"]) == set(ev["test"]) == KEYS
    assert all(0.0 <= v <= 1.0 for v in (*ev["valid"].values(), *ev["test"].values()))
    ckpt = out / "checkpoints" / "gssd" / "gssd_1_CV0.pt"
    assert ev["checkpoint"] == str(ckpt) == first["weights"]
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 2
    for name, t in first["model"].state_dict().items():
        assert torch.equal(saved["model"][name], t), name
    logs = out / "logs" / "gssd"
    assert "ap50=" in (logs / "test_log.txt").read_text()
    assert "eval_loss" in (logs / "valid_log.txt").read_text()

    # resume from iteration 1: the state after 2 steps, so the next step
    # is step 2, past the --stepvalues boundary (lr x0.1)
    second = main(common + ["--max_iter", "2", "--resume", "1"])
    assert "resumed from iteration 1 (step 2)" in capsys.readouterr().out
    assert [r["iter"] for r in second["records"]] == [1]
    assert second["records"][0]["lr"] == pytest.approx(1e-4)
    assert second["step"] == 3 and torch.load(ckpt, weights_only=True)["step"] == 3

    res = main(common + ["--test", "True", "--checkpoint", "1"])
    text = capsys.readouterr().out
    assert set(res["test"]) == KEYS and "test mean over folds:" in text
    assert np.all([0.0 <= v <= 1.0 for v in res["test"].values()])
    with pytest.raises(ValueError, match="--checkpoint"):
        main(common + ["--test", "True"])
