"""The reference's first training steps: the recipe's SGD on the batches
of the ``device_cached`` input path, from the benchmark's weights.

SGD as the recipe runs it: momentum 0.9, dampening 0, weight decay added
to the gradient before the momentum, learning rate ``lr * gamma ** #{step
boundaries <= step}``, x0.1 on the parameters of the ``dcn_*`` modules;
a parameter that the loss does not reach gets a zero gradient, so decay
and momentum still move it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.reference.boxes import multibox_loss, priors
from benchmark.reference.model import GSSD

BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked", ".u", ".v")


def is_parameter(name: str) -> bool:
    return not name.endswith(BUFFER_SUFFIXES)


def lr_of(name: str, step: int, optim: Dict) -> float:
    passed = sum(1 for s in optim["stepvalues"] if s <= step)
    lr = optim["lr"] * optim["gamma"] ** passed
    if optim["modify_dcn_lr"] and any(p.startswith("dcn_") for p in name.split(".")):
        lr *= 0.1
    return lr


def run_steps(model_cfg: Dict, w0: Dict[str, torch.Tensor], batch_of: Callable[[int], Dict],
              steps: int, loss_cfg: Dict, optim: Dict, quant: Optional[Callable] = None,
              dtype: torch.dtype = torch.float64) -> Dict:
    """``steps`` SGD steps in ``dtype`` from ``w0`` on ``batch_of(0)``,
    ``batch_of(1)``, ... -> {"losses": [float], "first": {name: the
    momentum after step 1}, "grad0": {name: step 1's gradient}, "change":
    {name: parameter after the last step minus w0}}."""
    def cast(v):
        return v.detach().to(dtype) if v.is_floating_point() else v

    params = {k: cast(v).clone().requires_grad_(True) for k, v in w0.items() if is_parameter(k)}
    buffers = {k: cast(v) for k, v in w0.items() if not is_parameter(k)}
    net = GSSD(model_cfg, {**params, **buffers}, quant)
    dev = next(iter(params.values())).device
    pri = torch.as_tensor(priors(model_cfg["anchors"]), device=dev).to(dtype)
    names = list(params)
    mom: Dict[str, torch.Tensor] = {}
    out: Dict = {"losses": []}
    for s in range(steps):
        batch = batch_of(s)
        loc, conf = net.forward(batch["image"], train=True)
        loss_l, loss_c = multibox_loss(loc, conf, pri, batch["boxes"].to(dtype), batch["labels"],
                                       batch["valid"], loss_cfg)
        loss = loss_l + loss_c
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                g = torch.zeros_like(p) if g is None else g
                d = g + optim["weight_decay"] * p
                mom[k] = d if s == 0 else optim["momentum"] * mom[k] + d
                p.sub_(lr_of(k, s, optim) * mom[k])
                if s == 0:
                    out.setdefault("grad0", {})[k] = g
        out["losses"].append(float(loss.detach()))
        if s == 0:
            out["first"] = {k: v.clone() for k, v in mom.items()}
        del loc, conf, loss, grads
    out["change"] = {k: params[k].detach() - cast(w0[k]) for k in names}
    return out
