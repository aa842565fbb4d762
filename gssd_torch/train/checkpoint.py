"""Checkpoints: save, full restore (resume) and shape-filtered partial load.

The port of ``gssd_tpu/train/checkpoint.py``. One file per (model_name,
iteration, fold), ``<save_folder>/<model_name>/<model_name>_<iteration>_CV<fold>.pt``,
holding ``{"step", "model", "optimizer"}``: the number of SGD steps
taken, the model's state_dict (parameters, BatchNorm statistics and the
spectral-norm u/v vectors) and the optimizer's state_dict (the momenta).

- ``restore_checkpoint`` restores all three (``--resume``);
- ``load_weights_partial`` copies every stored model entry whose name
  and shape match the target and warns for each one it skips, so that
  GSSD weights can warm-start GSSD++ (``--test --checkpoint``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import torch


def checkpoint_path(save_folder: str, model_name: str, iteration: int, fold: int = 0) -> str:
    return os.path.join(os.path.abspath(save_folder), model_name,
                        f"{model_name}_{iteration}_CV{fold}.pt")


def save_checkpoint(model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int,
                    save_folder: str, model_name: str, iteration: int, fold: int = 0) -> str:
    path = checkpoint_path(save_folder, model_name, iteration, fold)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"step": int(step),
                "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict()}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _load(path: str) -> Dict:
    if not os.path.exists(path):
        sibs = sorted(glob.glob(os.path.join(os.path.dirname(path), "*_CV*.pt")))
        raise FileNotFoundError(
            f"no checkpoint at {path}; available: "
            f"{[os.path.basename(s) for s in sibs] or 'none'}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       save_folder: str, model_name: str, iteration: int,
                       fold: int = 0) -> int:
    """Full restore (resume): model and optimizer state in place, strict.
    Returns the stored step."""
    ckpt = _load(checkpoint_path(save_folder, model_name, iteration, fold))
    model.load_state_dict(ckpt["model"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["step"])


def load_weights_partial(model: torch.nn.Module, path: str, verbose: bool = True) -> None:
    """Shape-filtered partial load of the model entries of the checkpoint
    at ``path``: an entry missing from the file or stored with another
    shape keeps the model's value, with a warning. The optimizer state is
    not read."""
    stored = _load(path)["model"]
    target = model.state_dict()
    merged = {}
    for name, value in target.items():
        src = stored.get(name)
        if src is None:
            if verbose:
                print(f"WARNING: {name} missing in checkpoint; keeping initialization")
            merged[name] = value
        elif tuple(src.shape) != tuple(value.shape):
            if verbose:
                print(f"WARNING: shape of stored {name} {tuple(src.shape)} != model "
                      f"{tuple(value.shape)}; ignored")
            merged[name] = value
        else:
            merged[name] = src.to(value.dtype)
    model.load_state_dict(merged, strict=True)
