"""The program under test, built from a configuration file: the port's
own objects (``gssd_torch``), as its trainer and serving CLI build them.
Imported only by the drivers, after the look for a card."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def model_and_priors(config: Dict, weights: Dict[str, torch.Tensor], device
                     ) -> Tuple[torch.nn.Module, torch.Tensor]:
    """The port's model with the benchmark's ``weights`` loaded (strict)
    and its prior table on ``device``."""
    from gssd_torch.config import ModelConfig
    from gssd_torch.models import build_model

    m = config["model"]
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in m.items() if k in names and k != "anchors"},
                      anchors=m["anchors"]["name"])
    model, priors = build_model(cfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model, torch.tensor(priors, device=device)


def loss_config(config: Dict):
    from gssd_torch.config import LossConfig

    lc = config["loss"]
    return LossConfig(num_classes=config["model"]["num_classes"],
                      overlap_thresh=lc["overlap_thresh"], neg_pos_ratio=lc["neg_pos_ratio"],
                      variance=tuple(lc["variance"]), max_gt_boxes=lc["max_gt"])


def optim_config(config: Dict):
    from gssd_torch.config import OptimConfig

    o = config["optim"]
    return OptimConfig(lr=o["lr"], momentum=o["momentum"], weight_decay=o["weight_decay"],
                       gamma=o["gamma"], stepvalues=tuple(o["stepvalues"]), clip=None,
                       modify_dcn_lr=o["modify_dcn_lr"])


def detect_config(config: Dict):
    from gssd_torch.config import DetectConfig

    d = config["detect"]
    return DetectConfig(num_classes=config["model"]["num_classes"], top_k=d["top_k"],
                        conf_thresh=d["conf_thresh"], nms_thresh=d["nms_thresh"],
                        variance=tuple(d["variance"]))


def kernel_counters() -> Dict[str, object]:
    """The port's launch counters, ``KERNELS``."""
    from gssd_torch.ops.kernels import KERNELS

    return dict(KERNELS)
