"""One process per device: the launcher of a data-parallel run.

``launch(fn, plan, *args)`` runs ``fn(rank, *args)`` once per rank of
``plan`` (``gssd_torch.parallel.mesh``) and returns the ranks' results
in rank order. ``rank`` is a ``Rank``: the plan, the rank's index,
device and folds, its rows of each batch, whether it evaluates, and the
gathers the trainers use across ranks.

- A plan of one rank spawns nothing: ``fn`` runs in this process, as a
  run without the launcher would.
- Otherwise each rank is a process started with the ``spawn`` method
  (never ``fork``: the parent may hold a CUDA context). Rank r sets
  ``devices[r]`` as its card and joins the process group (NCCL when
  every rank has a card of its own, gloo otherwise) through a
  ``FileStore`` in a fresh temporary directory, so that concurrent runs
  never meet on a port. Under ``fold_data`` each fold's ranks form a
  subgroup. ``fn`` runs inside ``collectives.data_group`` of the rank's
  fold group; its result travels back through a file.
- Fail fast: when any rank exits non-zero, the others are stopped at
  once (SIGTERM, SIGKILL after ``GRACE_S``) and ``launch`` raises with
  the tracebacks of the ranks that failed, the first to fail first; a
  run that outlasts ``deadline`` is stopped the same way. The
  collectives time out after ``TIMEOUT_S``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from gssd_torch.parallel.collectives import data_group
from gssd_torch.parallel.mesh import ParallelPlan, eval_splits

# the collectives' timeout: longer than anything one rank runs while the
# others wait. The ranks of a fold split its evaluations, so that is a
# checkpoint its first rank writes, a slower rank's host part of an
# evaluation (the decode and the sweep, the same work on every rank), or,
# where --eval_batch does not divide by the fold's ranks, the whole
# evaluation its first rank runs alone (minutes for a clinical test set)
TIMEOUT_S = 900.0
# seconds a failed run's other ranks get between SIGTERM and SIGKILL
GRACE_S = 2.0


@dataclasses.dataclass
class Rank:
    """One rank of a plan, as ``fn`` sees it."""

    plan: ParallelPlan
    index: int = 0

    @property
    def device(self) -> torch.device:
        return self.plan.devices[self.index]

    @property
    def folds(self) -> List[int]:
        return self.plan.folds(self.index)

    @property
    def rows(self) -> Optional[slice]:
        """This rank's rows of a batch; None where it takes them all."""
        return None if self.plan.n_data == 1 else self.plan.rows(self.index)

    @property
    def first(self) -> bool:
        """Rank 0: prints and logs the run."""
        return self.index == 0

    @property
    def leader(self) -> bool:
        """The first rank of its fold group: logs and saves its folds."""
        return self.plan.fold_ranks(self.index)[0] == self.index

    def evaluates(self, eval_batch: int) -> bool:
        """Whether this rank runs its folds' evaluations at ``eval_batch``:
        every rank of the fold group where they split it
        (``mesh.plan_infer_step``), else the leader alone."""
        return self.leader or eval_splits(len(self.plan.fold_ranks(self.index)), eval_batch)

    def fold_values(self, local: Dict[int, Any], sync: bool = False) -> List[Any]:
        """The values of every fold, in fold order, from ``local`` ({fold:
        value}, this rank's folds or none of them). Gathered from all ranks
        where this rank lacks a fold, or always with ``sync`` (a barrier);
        a fold's first reporting rank wins."""
        if self.plan.world_size > 1 and (sync or len(local) < self.plan.n_folds):
            gathered: List[Optional[Dict[int, Any]]] = [None] * self.plan.world_size
            dist.all_gather_object(gathered, local)
            merged: Dict[int, Any] = {}
            for part in gathered:
                for fold, value in part.items():
                    merged.setdefault(fold, value)
            local = merged
        return [local[f] for f in range(self.plan.n_folds)]

    def barrier(self) -> None:
        if self.plan.world_size > 1:
            dist.barrier()


def _entry(index: int, plan: ParallelPlan, fn: Callable, args: tuple, tmp: str,
           threads: int) -> None:
    device = plan.devices[index]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(plan.backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=index, world_size=plan.world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        group, size = dist.group.WORLD, plan.world_size
        if plan.layout == "fold_data":
            # every rank creates every fold's group, in fold order
            for f in range(plan.n_folds):
                ranks = list(range(f * plan.n_data, (f + 1) * plan.n_data))
                g = dist.new_group(ranks) if plan.n_data > 1 else None
                if index in ranks:
                    group, size = g, plan.n_data
        try:
            with data_group(group, size):
                out = fn(Rank(plan, index), *args)
        except BaseException:
            # when this rank failed, for the launcher to tell the first
            with open(os.path.join(tmp, f"failed{index}"), "w") as fh:
                fh.write(str(time.time_ns()))
            raise
        torch.save(out, os.path.join(tmp, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def _stop(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.terminate()
    t0 = time.monotonic()
    for p in processes:
        p.join(max(0.0, GRACE_S - (time.monotonic() - t0)))
    for p in processes:
        if p.is_alive():
            p.kill()
        p.join()


def _failures(ctx, first, world: int, tmp: str) -> str:
    """Every failed rank's traceback, the first to fail first: a rank
    that dies takes its peers' collectives down after it."""
    failed = []
    for i, path in enumerate(ctx.error_files):
        if os.access(path, os.R_OK):
            with open(path, "rb") as fh:
                trace = pickle.load(fh)
            os.unlink(path)
            stamp = os.path.join(tmp, f"failed{i}")
            when = time.time_ns()
            if os.path.exists(stamp):
                with open(stamp) as fh:
                    when = int(fh.read())
            failed.append((when, i, trace))
    if not failed:
        return f"rank {first.error_index} of {world} failed: {first}"
    return "\n".join(f"rank {i} of {world} failed{' first' if n == 0 else ''}:\n{trace}"
                     for n, (_, i, trace) in enumerate(sorted(failed)))


def launch(fn: Callable, plan: ParallelPlan, *args,
           deadline: Optional[float] = None) -> List[Any]:
    """``fn(rank, *args)`` on every rank of ``plan`` -> the results in rank
    order. ``fn`` and ``args`` must pickle (a module-level function);
    ``deadline`` (seconds) bounds the whole run."""
    if plan.world_size == 1:
        return [fn(Rank(plan, 0), *args)]
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gssd_ranks_")
    ctx = None
    try:
        threads = max(1, torch.get_num_threads() // plan.world_size)
        ctx = mp.start_processes(_entry, args=(plan, fn, args, tmp, threads),
                                 nprocs=plan.world_size, join=False, start_method="spawn")
        t0 = time.monotonic()
        try:
            while not ctx.join(timeout=0.2, grace_period=GRACE_S):
                if deadline is not None and time.monotonic() - t0 > deadline:
                    raise TimeoutError(f"the {plan.world_size} ranks ran past their "
                                       f"{deadline:.0f} s deadline")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_failures(ctx, e, plan.world_size, tmp)) from None
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(plan.world_size)]
    finally:
        if ctx is not None:
            _stop(ctx.processes)
        shutil.rmtree(tmp, ignore_errors=True)
