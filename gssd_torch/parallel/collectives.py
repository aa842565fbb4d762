"""The process group a rank's training step sums over, and the sums.

Data parallelism in the port runs one process per card (a *rank*;
``gssd_torch.parallel.launch``). The ranks of a fold split its batch
into row blocks and together compute what one process computes at the
whole batch, as the JAX package's sharded step does
(``gssd_tpu/parallel/mesh.py``): BatchNorm statistics over the fold's
whole batch (``ops/layers.py``), the loss normalisers over it
(``ops/losses.py``, ``ops/pixellink_loss.py``), and the gradient of the
global loss, the sum of the ranks' shares (``train/steps.py``).

Those modules read the group from ``data_group``, a context the rank's
entry sets around the trainer: no model or loss takes it as an
argument. Outside the context, or in a group of one rank, every
function here is the identity and the modules run exactly as before.

The sharded evaluation forward (``mesh.plan_infer_step``) gathers each
rank's outputs over the same group (``all_gather``).

A gloo group on CUDA tensors (two ranks sharing one card) sums and
gathers through host copies; NCCL does both on the card. Every rank
receives the same bits from the collective, so the ranks' parameters
stay equal.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# (process group, its size) while a rank trains in a group of > 1 ranks
_GROUP: Optional[Tuple[Any, int]] = None


@contextlib.contextmanager
def data_group(group, size: int):
    """Within the block, BatchNorm, the losses and ``backward`` sum over
    ``group`` (``size`` ranks); a group of one rank sets nothing."""
    global _GROUP
    prev = _GROUP
    _GROUP = (group, size) if size > 1 else None
    try:
        yield
    finally:
        _GROUP = prev


def group_size() -> int:
    """The ranks the current step sums over (1 outside a group)."""
    return 1 if _GROUP is None else _GROUP[1]


def _via_host(t: torch.Tensor, group) -> bool:
    """gloo takes no CUDA tensor: its collectives go through host copies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the current group, in place, outside autograd;
    ``t`` itself outside a group."""
    if _GROUP is not None:
        _sum_(t, _GROUP[0])
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the output gradients over
    the same group (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the current group; ``x`` outside
    a group."""
    if _GROUP is None:
        return x
    return _AllReduceSum.apply(x, _GROUP[0])


def sum_grads_(grads: List[torch.Tensor]) -> None:
    """Each gradient summed over the current group, in place: one flat
    all-reduce of every gradient in parameter order."""
    if _GROUP is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _sum_(flat, _GROUP[0])
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    first dimension in the group's rank order, on ``t``'s device, outside
    autograd; ``t`` itself outside a group."""
    if _GROUP is None:
        return t
    group, size = _GROUP
    src = t.detach().contiguous()
    if _via_host(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
