"""Training traffic: the recipe's closed training loop, steps back to back.

Set-up makes the synthetic training set and the weights from the seed,
builds the port's model, SGD and ``device_cached`` input path
(``DeviceCacheLoader`` through ``device_prefetch``, as the trainer does),
and drives that one object through its first ``check_steps`` steps, which
the reference then follows, and ``warm_steps`` more. The window and the
traced stretch go on with the same object. A step is the trainer's
iteration: ``next()`` of the stream (the input wait), ``fold_train_step``
of one ``FoldMember`` over ``train_step``, and the step's scalars read to
the host.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict

import torch

from benchmark import check, data, program
from benchmark.reference import augment, train as ref_train
from benchmark.reference.model import param_spec
from benchmark.reference.quant import bf16, fp8
from benchmark.trace import Trace, capture
from benchmark.weights import make_weights


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.window_stats: Dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from gssd_torch.data import DeviceCacheLoader, device_prefetch
        from gssd_torch.parallel.folds import FoldMember, fold_train_step
        from gssd_torch.train import steps as port_steps
        from gssd_torch.train.optim import make_optimizer

        cfg, tr, dev = self.config, self.traffic, self.device
        ct, self.bboxes = data.lesion_slices(cfg["slices"], tr["source_size"], self.seed, dev,
                                             tr["max_lesions"])
        self.raw = data.to_uint8(ct)
        del ct
        self.w0 = make_weights(param_spec(cfg["model"]), self.seed, dev)
        model, priors = program.model_and_priors(cfg, self.w0, dev)
        optimizer = make_optimizer(model, program.optim_config(cfg))
        loss_cfg, optim_cfg = program.loss_config(cfg), program.optim_config(cfg)
        train_step = port_steps.train_step

        self.member = FoldMember(
            0, model, optimizer,
            lambda batch, step: train_step(model, optimizer, priors, batch, loss_cfg,
                                           optim_cfg, step),
            None, None, None, None)
        self._fold_train_step = fold_train_step
        aug = cfg["augment"]
        loader = DeviceCacheLoader(
            data.SliceSet(self.raw.cpu().numpy(), self.bboxes), self.batch,
            size=cfg["model"]["size"], max_gt=cfg["loss"]["max_gt"], seed=self.seed,
            pixeljitter=aug["pixel_jitter"], ratio=aug["expand_ratio"], mean=aug["mean"],
            use_normalize=True, start_batch=0, device=dev)
        self.stream = device_prefetch(loader, dev)

        # the steps the reference follows, then the warm-up
        self.prog = {"losses": []}
        for s in range(tr["check_steps"]):
            out, _ = self.step()
            self.prog["losses"].append(out["loss"])
            if s == 0:
                self.prog["first"] = self._momenta()
        self.prog["change"] = {k: p.detach() - self.w0[k] for k, p in model.named_parameters()}
        for _ in range(tr["warm_steps"]):
            self.step()

    def _momenta(self) -> Dict[str, torch.Tensor]:
        opt = self.member.optimizer
        out = {}
        for k, p in self.member.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            out[k] = (torch.zeros_like(p) if buf is None else buf).detach().clone()
        return out

    # -- the loop -----------------------------------------------------------

    def step(self):
        t0 = time.perf_counter()
        batch = next(self.stream)
        wait = time.perf_counter() - t0
        out = self._fold_train_step([self.member], [batch])[0]
        vals = {k: (v if isinstance(v, float) else float(v.item())) for k, v in out.items()}
        return vals, wait

    def window(self, seconds: float) -> Dict[str, float]:
        steps, failed, waits = 0, 0, []
        t0 = time.perf_counter()
        while True:
            vals, wait = self.step()
            steps += 1
            waits.append(wait)
            failed += not math.isfinite(vals["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.window_stats = {"steps": steps, "wall_s": wall, "waits_s": waits,
                             "slices": steps * self.batch}
        return {"train_slices_per_s": steps * self.batch / wall,
                "attempted": steps, "failed": failed}

    def traced(self) -> Trace:
        return capture(lambda i: self.step(), self.traffic["trace_steps"],
                       program.kernel_counters())

    # -- the comparison -----------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.member = self.stream = self._fold_train_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rows: slice = slice(None), quant=None) -> Dict:
        """The reference's first steps (float64, TF32 off) on ``rows`` of
        each batch, with ``quant`` rounding its products."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return ref_train.run_steps(self.config["model"], self.w0, reference_batches(self, rows),
                                   len(self.prog["losses"]), self.config["loss"],
                                   self.config["optim"], quant)

    def check(self) -> Dict[str, float]:
        self.ref = self.reference()
        self.yard = self.reference(quant=bf16)
        leaves = check.moving_leaves(self.ref["grad0"])
        print(f"step losses: program {self.prog['losses']}, reference {self.ref['losses']}, "
              f"gaps {check.loss_gaps(self.prog, self.ref)}; worst leaves (not compared): "
              f"first {check.worst_leaf(self.prog['first'], self.ref['first'], leaves)}, "
              f"change {check.worst_leaf(self.prog['change'], self.ref['change'], leaves)}",
              file=sys.stderr)
        return check.train_numbers(self.prog, self.ref, self.yard)

    def control(self) -> Dict[str, Dict]:
        """After ``check``: the numbers of the reference put in the
        program's place in fp8 (the control) and with half of each batch
        left out (a fault); each step's losses."""
        ctl = self.reference(quant=fp8)
        half = self.reference(rows=slice(0, self.batch // 2))
        return {"fp8": check.train_numbers(ctl, self.ref, self.yard),
                "half_batch": check.train_numbers(half, self.ref, self.yard),
                "losses": {"program": self.prog["losses"], "reference": self.ref["losses"],
                           "bf16": self.yard["losses"], "fp8": ctl["losses"]}}


def reference_batches(driver: "Driver", rows: slice = slice(None)):
    """The reference's batch j (``rows`` of it) for ``driver``'s data."""
    cfg = driver.config
    aug = {**cfg["augment"], "size": cfg["model"]["size"], "max_gt": cfg["loss"]["max_gt"]}

    def batch_of(j: int) -> Dict[str, torch.Tensor]:
        b = augment.make_batch(driver.raw, driver.bboxes, driver.seed, j, driver.batch, aug)
        return {k: v[rows] for k, v in b.items()}

    return batch_of
