"""k-fold cross-validation as K independent fold members.

The port of ``gssd_tpu/parallel/folds.py``. The JAX package stacks the
K fold states along a leading axis and advances them with one vmapped
train step; what that step computes is K independent trainings (the
JAX tests hold the vmapped step equal to each fold stepped alone). Here
each fold is a ``FoldMember`` with its own model (parameters, BN
statistics, spectral u/v), optimizer (momenta), step counter, loaders
and augmentation generators, and ``fold_train_step`` steps the members
one after another, fold 0 first.

Seeds: fold 0's model is built from ``--seed`` itself, so a one-fold run
is the run it always was; fold f > 0 from ``fold_seed(seed, f)``, the
first word of ``numpy.random.SeedSequence([seed, f])`` (the JAX package's
``fold_in(PRNGKey(seed), f)`` bits cannot be reproduced in torch). The
data streams follow the JAX trainers: training loaders and augmentation
of fold f seeded with ``seed + f``, its validation loader with
``seed + 100 + f``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def fold_seed(seed: int, fold: int) -> int:
    """The model-init seed of ``fold``: ``seed`` for fold 0, else the
    first 32-bit word of ``SeedSequence([seed, fold])``."""
    if fold == 0:
        return seed
    return int(np.random.SeedSequence([seed, fold]).generate_state(1)[0])


@dataclasses.dataclass
class FoldMember:
    """One fold's training state and the closures over it.

    ``train_fn(batch, step)`` takes one SGD step of ``model`` and
    returns its metrics; ``valid_fn(batch)`` the validation losses;
    ``evaluate(dataset, tag, iteration)`` the AP/IoBB dict;
    ``train_tf``/``valid_tf`` are the transforms of its training and
    validation-loss loaders (each with its own generator); ``step``
    counts the SGD steps taken; ``infer(images)``, where the trainer
    has one, is the model's inference step (boxes after Detect/NMS);
    ``visualize(dataset, out_dir)`` writes the --visualize dumps of the
    model over ``dataset`` and returns {index: detections}."""

    fold: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    train_fn: Callable
    valid_fn: Callable
    evaluate: Callable
    train_tf: Any
    valid_tf: Any
    step: int = 0
    infer: Optional[Callable] = None
    visualize: Optional[Callable] = None


def fold_train_step(members: List[FoldMember], batches: List[Dict[str, Any]]) -> List[Dict]:
    """One SGD step of every member on its batch, fold 0 first: the
    members' metrics, each step counter advanced. The counterpart of
    ``vmap_train_step``."""
    if len(members) != len(batches):
        raise ValueError(f"{len(members)} folds, {len(batches)} batches")
    out = []
    for member, batch in zip(members, batches):
        out.append(member.train_fn(batch, member.step))
        member.step += 1
    return out


def fold_mean(metrics: List[Dict[str, float]]) -> Dict[str, float]:
    """The mean over folds of each key of fold 0's dict, as the JAX
    trainers log it."""
    return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
