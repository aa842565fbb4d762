"""The comparison that decides ``correct`` sees a broken timed path.

Each test skips the harness's look for a card and drives the rest of a
run (``run.run_cell`` on the CPU, at a small size, with the program in
float32 on its plain paths) with the program broken underneath: a step
that leaves its state unchanged, half of the batch left out, an answer
altered where it is produced. A sound run at the same size passes. Each
is held to the cell's own limits (``benchmark/limits/``). Training runs
at batch 4: at batch 2 the BatchNorm of the 1x1 maps normalises two
values, so that rounding alone flips its outputs.
"""

import json
import os

import pytest
import torch

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN, INFER = "gssdpp-300.train-b32", "gssdpp-512.infer-b16"


def small(workload):
    bench = run.load_json("BENCHMARK.json")
    cell = run.cell_of(bench, workload)
    config = run.load_json("benchmark", "configs", f"{cell['config']}.json")
    traffic = run.load_json("benchmark", "traffic", f"{cell['traffic']}.json")
    config["model"].update(compute_dtype="float32", dcn_impl="xla")
    if traffic["kind"] == "train":
        config["slices"] = 8
        traffic.update(batch=4, source_size=96, check_steps=2, warm_steps=0)
    else:
        config["slices"] = 8
        traffic.update(batch=4, warm_requests=0, check_requests=1)
    return dict(bench=bench, config=config, traffic=traffic)


def run_small(workload, seed=2**32 + 5):
    return run.run_cell(workload, seed, 0.01, False, device="cpu", **small(workload))


def test_sound_training_run_is_correct():
    res = run_small(TRAIN)
    assert res["correct"], res["checks"]


def _state_unchanged(model, optimizer, priors, batch, loss_cfg, optim_cfg, step):
    from gssd_torch.train.steps import forward_loss

    model.train()
    loss_l, loss_c, aux = forward_loss(model, priors, batch, loss_cfg)
    loss = (loss_l + loss_c).detach()
    return {"loss": loss, "loss_l": loss_l.detach(), "loss_c": loss_c.detach(),
            "grad_norm": torch.zeros(()), "num_pos": aux["num_pos"], "lr": 0.0}


def _half_batch(real):
    def step(model, optimizer, priors, batch, *args):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        return real(model, optimizer, priors, half, *args)
    return step


def _update_doubled(real):
    def step(model, optimizer, *args):
        before = [p.detach().clone() for p in model.parameters()]
        out = real(model, optimizer, *args)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.add_(p - b)
        return out
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    from gssd_torch.train import steps

    real = steps.train_step
    broken = {"state_unchanged": _state_unchanged, "half_batch": _half_batch(real),
              "answer_altered": _update_doubled(real)}[fault]
    monkeypatch.setattr(steps, "train_step", broken)
    res = run_small(TRAIN)
    assert not res["correct"], res["checks"]


def test_sound_serving_run_is_correct():
    res = run_small(INFER)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    from gssd_torch.train import steps

    real = steps.make_infer_step

    def make(model, priors, cfg):
        step = real(model, priors, cfg)

        def broken(images):
            det = step(images).clone()
            if fault == "half_batch":
                det[len(det) // 2:] = 0
            else:
                det[0, 1, 0, 1:] += 0.5  # the best detection's box moved
            return det
        return broken

    monkeypatch.setattr(steps, "make_infer_step", make)
    res = run_small(INFER)
    assert not res["correct"], res["checks"]
