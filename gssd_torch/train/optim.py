"""SGD with the JAX package's optax chain semantics.

``torch.optim.SGD`` (momentum 0.9, weight decay added to the gradient
before the momentum trace, dampening 0, no Nesterov) in two parameter
groups: every parameter outside a ``dcn_*`` module, and (with
``modify_dcn_lr``) those inside one at x0.1 LR. The LR of step s is
``lr * gamma ** #{boundaries <= s}``, where boundaries past the int32
range (a "never" sentinel such as 9999999999999) are dropped as the JAX
schedule drops them. An optional clip scales every gradient by ``clip /
norm`` when the global norm over all parameters reaches ``clip``, before
the groups.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from gssd_torch.config import OptimConfig

DCN_LR_SCALE = 0.1


def step_lr(cfg: OptimConfig, step: int) -> float:
    """Base learning rate of (0-based) step ``step``."""
    passed = sum(1 for s in cfg.stepvalues if s < 2**31 - 1 and s <= step)
    return cfg.lr * cfg.gamma ** passed


def is_dcn_param(name: str) -> bool:
    return any(part.startswith("dcn_") for part in name.split("."))


def make_optimizer(model: torch.nn.Module, cfg: OptimConfig) -> torch.optim.SGD:
    rest, dcn = [], []
    for name, p in model.named_parameters():
        (dcn if cfg.modify_dcn_lr and is_dcn_param(name) else rest).append(p)
    groups = [{"params": rest, "lr_scale": 1.0}]
    if dcn:
        groups.append({"params": dcn, "lr_scale": DCN_LR_SCALE})
    return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0, nesterov=False)


def set_lr(optimizer: torch.optim.Optimizer, cfg: OptimConfig, step: int) -> float:
    lr = step_lr(cfg, step)
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_scale"]
    return lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def clip_by_global_norm_(grads: List[torch.Tensor], clip: float,
                         norm: torch.Tensor) -> None:
    """optax's clip_by_global_norm in place: g / norm * clip where
    norm >= clip, untouched otherwise."""
    keep = norm < clip
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * clip))
