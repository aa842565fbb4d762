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

The usable devices: on CUDA every card (``torch.cuda.device_count()``),
capped by ``GSSD_DP_DEVICES``; on the CPU (``--device cpu``)
``GSSD_DP_DEVICES`` ranks (default 1), each a gloo process. An explicit
device list is taken as given, with no cap: it may name one card twice
(two gloo ranks sharing it).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch

from gssd_torch import resolve_device

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
