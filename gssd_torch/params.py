"""Carry weights from the JAX package's flax variables to the port.

``from_jax_variables`` maps the flax tree (collections ``params``,
``batch_stats`` and ``spectral``, nested dicts or flat ``/``-joined
keys, leaves as numpy arrays) onto the port's ``state_dict`` names:

- ``<layer>/Conv_0/kernel`` HWIO -> ``<layer>.conv.weight`` OIHW, and
  every other 4-D conv kernel (DCN ``conv_offset_mask``, heads
  ``loc_i``/``conf_i``) -> ``.weight`` OIHW; UNet's second conv of a
  block, ``Conv_1``, -> ``conv_1``;
- ``nn.ConvTranspose`` kernels [kh, kw, in, out] (FusedSSD's
  ``fuse_deconv_53``, UNet's ``up_<i>``: the layers named in
  ``transposed``) -> ``.weight`` [in, out, kh, kw] with both spatial
  axes flipped, ``torch.nn.ConvTranspose2d``'s layout: flax's transposed
  conv is the dilated input's correlation with the kernel as stored,
  torch's the one with the kernel flipped;
- ``BatchNorm_0`` (and UNet's ``BatchNorm_1``) ``scale``/``bias`` and
  ``mean``/``var`` -> ``bn.weight``/``bn.bias`` and
  ``bn.running_mean``/``bn.running_var`` (``bn_1.*``); so do the named
  BatchNorms (``bn_*``: PixelLink's ``bn_fuse_<i>``, FSSD's
  ``bn_fused``, FusedSSD's ``bn_fuse_deconv_53``) under their own name;
- PixelLink's 1x1 convs (``fuse_<i>``, ``out<i>_1/2``, ``final_1/2``)
  ``kernel`` HWIO -> ``.weight`` OIHW;
- SNDense ``kernel`` [in, out], ``bias`` and ``spectral`` ``u``/``v``
  keep their names; so do attention ``sigma``, DCN ``weight`` [K, C,
  Cout] / ``bias`` and ``l2norm/weight``.

Unknown leaves raise here; ``load_jax_variables`` loads strictly, so a
missing or surplus key or a wrong shape raises too. ``load_jax_fold``
loads one fold of a fold-stacked tree (``gssd_tpu.parallel.folds.
stack_states``: every leaf with a leading fold axis).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

_MODULE_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Conv_1": "conv_1",
                 "BatchNorm_1": "bn_1"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def from_jax_variables(variables: Mapping, transposed: Iterable[str] = ()
                       ) -> Dict[str, torch.Tensor]:
    """flax variables of a ``gssd_tpu`` model (``SSD``, ``FSSD``,
    ``FusedSSD``, ``PixelLink``, ``UNet``) -> state_dict of the port's
    model of the same name (f32 tensors on the CPU). ``transposed``: the
    port's names (``.``-joined) of the ``nn.ConvTranspose`` layers."""
    transposed = set(transposed)
    sd: Dict[str, torch.Tensor] = {}
    for key, val in _flatten(variables).items():
        col, *path, leaf = key.split("/")
        mods = [_MODULE_NAMES.get(p, p) for p in path]
        arr = np.asarray(val, np.float32)
        if col == "params":
            if leaf == "kernel" and arr.ndim == 4 and ".".join(mods) in transposed:
                # [kh, kw, in, out] -> [in, out, kh, kw], spatially flipped
                name, arr = "weight", arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif leaf == "kernel" and arr.ndim == 4:
                name, arr = "weight", arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif leaf == "kernel" and arr.ndim == 2:
                name = "kernel"  # SNDense keeps the flax [in, out] layout
            elif leaf == "scale" and path and path[-1].startswith(("BatchNorm_", "bn")):
                name = "weight"
            elif leaf in ("bias", "weight", "sigma"):
                name = leaf
            else:
                raise KeyError(f"unknown flax parameter {key!r}")
        elif col == "batch_stats" and leaf in _STATS:
            name = _STATS[leaf]
            sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
        elif col == "spectral" and leaf in ("u", "v"):
            name = leaf
        else:
            raise KeyError(f"unknown flax variable {key!r}")
        sd[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def transposed_layers(model: torch.nn.Module) -> List[str]:
    """The names of ``model``'s ``ConvTranspose2d`` layers."""
    return [name for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.ConvTranspose2d)]


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load flax variables into ``model`` strictly (missing, surplus or
    misshapen entries raise)."""
    model.load_state_dict(from_jax_variables(variables, transposed_layers(model)),
                          strict=True)


def load_jax_fold(model: torch.nn.Module, stacked: Mapping, fold: int) -> None:
    """Load fold ``fold`` of fold-stacked flax variables (each leaf
    [K, ...], the numpy tree of a ``stack_states`` state's variables)
    into ``model``, strictly."""
    def take(tree):
        return {k: take(v) if isinstance(v, Mapping) else np.array(np.asarray(v)[fold])
                for k, v in tree.items()}

    load_jax_variables(model, take(stacked))
