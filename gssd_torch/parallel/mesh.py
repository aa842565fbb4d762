"""The trainers' parallel layout, chosen from the device count.

The port of ``gssd_tpu/parallel/mesh.py``'s ``plan_parallelism``. The
JAX package puts the stacked fold states and the batch on a device mesh
and runs one global program over it; the port runs one process per
device (a *rank*, ``gssd_torch.parallel.launch``) and sums across the
ranks what that program sums across the mesh
(``gssd_torch.parallel.collectives``). The layouts are JAX's:

- ``single``: one usable device, or no divisor of the batch above 1;
  one process trains every fold on the whole batch, as before;
- ``data``: d ranks, d the largest divisor of the batch B up to the
  device count n; every rank trains every fold on its rows
  ``[r * B/d, (r+1) * B/d)`` of the fold's batch (JAX's
  ``batch_spec=P(None, 'data')``);
- ``fold_data``: when n > 1, K > 1 folds, K divides n and n/K divides B:
  rank r trains fold ``r // (n/K)`` on rows block ``r % (n/K)``, each
  fold's batch split over its n/K ranks (``P('fold', 'data')``).

The evaluation forward splits too (``plan_infer_step``, JAX's
``jit_plan_infer_step``): the ranks that hold a fold's weights (the
fold's group) split each evaluation batch of the fold, when the group's
rank count divides ``--eval_batch``, and every rank receives all the
outputs in row order. Under ``fold_data`` each fold's ranks split its
batches, all folds at once (JAX flattens the mesh and evaluates the
folds one after another: the outputs are the same). A ``--test`` run
(``evaluation_plan``) evaluates every fold on every rank of the plan.

The usable devices: on CUDA every card (``torch.cuda.device_count()``),
capped by ``GSSD_DP_DEVICES``; on the CPU (``--device cpu``)
``GSSD_DP_DEVICES`` ranks (default 1), each a gloo process. An explicit
device list is taken as given, with no cap: it may name one card twice
(two gloo ranks sharing it).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from gssd_torch import resolve_device
from gssd_torch.parallel.collectives import all_gather, group_size

DP_DEVICES_ENV = "GSSD_DP_DEVICES"


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The layout, the device of each rank (``devices[r]``), and how the
    folds and the batch rows fall to the ranks."""

    layout: str  # 'single' | 'data' | 'fold_data'
    n_folds: int
    batch_size: int
    devices: Tuple[torch.device, ...]
    n_data: int  # ranks a fold's batch is split over

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def backend(self) -> str:
        """NCCL when every rank has a card of its own, else gloo."""
        if all(d.type == "cuda" for d in self.devices) and \
                len(set(self.devices)) == len(self.devices):
            return "nccl"
        return "gloo"

    def describe(self) -> str:
        if self.layout == "single":
            return "single-device"
        if self.layout == "data":
            return f"mesh(data={self.n_data})"
        return f"mesh(fold={self.n_folds}, data={self.n_data})"

    def folds(self, rank: int) -> List[int]:
        """The folds rank ``rank`` trains, in order."""
        if self.layout == "fold_data":
            return [rank // self.n_data]
        return list(range(self.n_folds))

    def rows(self, rank: int) -> slice:
        """Rank ``rank``'s rows of its folds' batches."""
        per = self.batch_size // self.n_data
        i = rank % self.n_data
        return slice(i * per, (i + 1) * per)

    def fold_ranks(self, rank: int) -> List[int]:
        """The ranks that share rank ``rank``'s folds (its sum group),
        the first of them writing the folds' evaluations and checkpoints."""
        if self.layout == "fold_data":
            first = rank - rank % self.n_data
            return list(range(first, first + self.n_data))
        return list(range(self.world_size))


def usable_devices(device="cuda") -> List[torch.device]:
    """The devices a run on ``device`` may spread over: every card (or the
    one named by an index), capped by GSSD_DP_DEVICES; on the CPU,
    GSSD_DP_DEVICES entries (default 1). Raises without a card unless
    the CPU is asked for."""
    dev = resolve_device(device)
    cap = os.environ.get(DP_DEVICES_ENV)
    if dev.type != "cuda":
        return [dev] * max(1, int(cap or 1))
    if dev.index is not None:
        return [dev]
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[: max(1, int(cap))] if cap else devs


def plan_parallelism(n_folds: int, batch_size: int,
                     devices: Optional[Sequence] = None, device="cuda") -> ParallelPlan:
    """JAX's layout choice for ``n_folds`` folds at batch ``batch_size``
    over ``devices`` (default: ``usable_devices(device)``)."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else usable_devices(device)
    n = len(devs)
    if n > 1 and n_folds > 1 and n % n_folds == 0 and batch_size % (n // n_folds) == 0:
        n_data = n // n_folds
        return ParallelPlan("fold_data", n_folds, batch_size,
                            tuple(devs[: n_folds * n_data]), n_data)
    # the largest device count that divides the per-fold batch
    d = max((x for x in range(2, n + 1) if batch_size % x == 0), default=1)
    if d > 1:
        return ParallelPlan("data", n_folds, batch_size, tuple(devs[:d]), d)
    return ParallelPlan("single", n_folds, batch_size, tuple(devs[:1]), 1)


def eval_splits(n_ranks: int, eval_batch: int) -> bool:
    """JAX's rule: an evaluation batch splits over ``n_ranks`` ranks only
    when their count divides it; else the first of them evaluates alone."""
    return n_ranks > 1 and eval_batch % n_ranks == 0


def describe_eval(n_ranks: int, eval_batch: int) -> str:
    """The line a run of several ranks prints: how the ``n_ranks`` ranks
    that hold a fold's weights run its evaluations."""
    if n_ranks == 1:
        return "evaluation: each fold on the one rank that holds it"
    if eval_splits(n_ranks, eval_batch):
        return f"evaluation: each batch of {eval_batch} split over {n_ranks} ranks"
    return (f"evaluation: on one rank: --eval_batch {eval_batch} does not divide by "
            f"{n_ranks} ranks")


def evaluation_plan(plan: ParallelPlan, eval_batch: int) -> ParallelPlan:
    """The plan of a ``--test`` run from the training plan ``plan``: every
    rank loads each fold's checkpoint in turn, so all of them split each
    batch of ``eval_batch`` (a ``data`` plan over the same devices, rank r
    on rows ``rows(r)`` of a batch); one rank where their count does not
    divide ``eval_batch``."""
    n = plan.world_size
    if eval_splits(n, eval_batch):
        return ParallelPlan("data", plan.n_folds, eval_batch, plan.devices, n)
    return ParallelPlan("single", plan.n_folds, eval_batch, plan.devices[:1], 1)


def plan_infer_step(infer_fn: Callable, rank, eval_batch: int) -> Callable:
    """JAX's ``jit_plan_infer_step``: ``infer_fn`` (a batch -> a tensor, or
    a tuple of them, each with a row per image) run over the ranks of the
    current group (``rank``'s fold group) when ``eval_splits`` holds,
    else ``infer_fn`` itself. The step takes a whole chunk of b <=
    ``eval_batch`` rows (numpy or tensor), pads it with zero rows to a
    multiple of the rank count (so that every rank runs at least one
    row), runs ``infer_fn`` on this rank's block of rows, gathers the
    blocks over the group in rank order and drops the padding: every rank
    returns the outputs of the whole chunk."""
    n = group_size()
    if not eval_splits(n, eval_batch):
        return infer_fn
    position = rank.plan.fold_ranks(rank.index).index(rank.index)

    def step(images):
        images = torch.as_tensor(images)
        b = images.shape[0]
        per = -(-b // n)
        if per * n > b:
            images = torch.cat([images, images.new_zeros((per * n - b, *images.shape[1:]))])
        out = infer_fn(images[position * per:(position + 1) * per])
        if isinstance(out, tuple):
            return tuple(all_gather(t)[:b] for t in out)
        return all_gather(out)[:b]

    return step
