"""Rank bodies of the data-parallel tests, and the mini detector twin.

Spawned ranks unpickle their function by module, so the bodies live
here, in a module that imports neither JAX nor ``gssd_tpu`` (nor
tests/mini_model.py, which does): a rank must not load them. The tests
compute their JAX references in the test process and pass numpy trees
and arrays in. ``quiet_train``, ``quiet_pixellink`` and ``mini_voc`` are the trainers'
rank bodies with TensorBoard's import blocked (it can drag TensorFlow
in), as the in-process tests block it; ``mini_voc`` also puts
``MiniVOC`` in place of the VOC trainer's SSD300.

``MiniTwin`` is the port's twin of tests/mini_model.py's
``MiniDetector`` (three conv + BatchNorm stages, loc and conf heads),
used by the fold, VOC, SNUH and data-parallel tests.
"""

import os
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.config import AnchorConfig, LossConfig, OptimConfig
from gssd_torch.ops.layers import BatchNorm
from gssd_torch.ops.pixellink_loss import pixellink_loss
from gssd_torch.params import load_jax_fold
from gssd_torch.train import make_optimizer, train_step
from gssd_torch.train.steps import backward, forward_loss, group_total

# priors per cell of tests/mini_model.py's MINI_ANCHORS (one aspect ratio:
# 2 + 2 * 1); tests/test_torch_parallel.py holds the two equal
MINI_PRIORS_PER_CELL = 4


class _Stage(nn.Module):
    """conv (flax SAME padding: stride 2 pads one row and column at the
    end) + optional BatchNorm, NCHW."""

    def __init__(self, cin, cout, stride, bn):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=0)
        self.bn = BatchNorm(cout) if bn else None

    def forward(self, x):
        x = self.conv(F.pad(x, (0, 1, 0, 1) if self.stride == 2 else (1, 1, 1, 1)))
        return x if self.bn is None else F.relu(self.bn(x))


class MiniTwin(nn.Module):
    """The port's twin of tests/mini_model.py's ``MiniDetector``."""

    def __init__(self, num_classes=2):
        super().__init__()
        nb = MINI_PRIORS_PER_CELL
        self.s0, self.s1, self.s2 = _Stage(12, 8, 2, True), _Stage(8, 16, 2, True), \
            _Stage(16, 32, 2, True)
        self.loc = _Stage(32, nb * 4, 1, False)
        self.conf = _Stage(32, nb * num_classes, 1, False)
        self.num_classes = num_classes

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.s2(self.s1(self.s0(x)))
        B = x.shape[0]
        return {"loc": self.loc(x).permute(0, 2, 3, 1).reshape(B, -1, 4),
                "conf": self.conf(x).permute(0, 2, 3, 1).reshape(B, -1, self.num_classes)}


# tests/mini_model.py's MINI_ANCHORS, for the port's make_anchors
MINI_ANCHORS = AnchorConfig(name="v2_mini", feature_maps=(8,), min_dim=64, steps=(8,),
                            min_sizes=(16,), max_sizes=(32,), aspect_ratios=((2,),))


class MiniVOC(MiniTwin):
    """The mini detector on 3 input channels (VOC images)."""

    def __init__(self, num_classes):
        super().__init__(num_classes)
        self.s0 = _Stage(3, 8, 2, True)


def build_mini_voc(cfg, device, seed):
    """``build_model``'s signature: ``MiniVOC`` (from ``seed``) and its
    priors."""
    from gssd_torch.ops.anchors import make_anchors

    torch.manual_seed(seed)
    return MiniVOC(cfg.num_classes), make_anchors(MINI_ANCHORS)


def _rows(batch, rows):
    return {k: torch.from_numpy(np.asarray(v)[rows if rows is not None else slice(None)])
            for k, v in batch.items()}


def momenta(model, optimizer):
    """{parameter name: its SGD momentum buffer}."""
    return {name: optimizer.state[p]["momentum_buffer"].clone()
            for name, p in model.named_parameters()}


def twin_steps(rank, stacked_np, batches, priors_np, optim):
    """Rank body: the twins of the rank's folds (fold f loaded from the
    stacked JAX init), stepped on the rank's rows of ``batches[s][f]``
    for every step s. -> {"losses": {fold: [loss a step]}, "state":
    {fold: state_dict}, "momenta": {fold: {name: buffer}}}."""
    priors = torch.from_numpy(priors_np)
    loss_cfg, optim_cfg = LossConfig(max_gt_boxes=4), OptimConfig(**optim)
    out = {"losses": {}, "state": {}, "momenta": {}}
    for f in rank.folds:
        model = MiniTwin()
        load_jax_fold(model, stacked_np, f)
        opt = make_optimizer(model, optim_cfg)
        losses = []
        for step, step_batches in enumerate(batches):
            m = train_step(model, opt, priors, _rows(step_batches[f], rank.rows), loss_cfg,
                           optim_cfg, step)
            losses.append(float(m["loss"]))
        out["losses"][f] = losses
        out["state"][f] = {k: v.clone() for k, v in model.state_dict().items()}
        out["momenta"][f] = momenta(model, opt)
    return out


def shares(rank, state, batch, priors_np, bn_x, bn_w, pl_logits, pl_targets):
    """Rank body (or the unsplit run, as one rank): on the rank's rows,
    (1) the MultiBox loss of the twin from ``state`` and its gradients
    summed over the ranks, (2) the PixelLink loss of fixed logits and
    the logits' gradient, (3) a train-mode BatchNorm's output and input
    gradient under the loss sum(y * bn_w). Losses are summed over the
    ranks; the gradients of inputs are the rank's rows."""
    rows = rank.rows if rank.rows is not None else slice(None)
    model = MiniTwin()
    model.load_state_dict(state)
    model.train()
    loss_l, loss_c, _ = forward_loss(model, torch.from_numpy(priors_np), _rows(batch, rows),
                                     LossConfig(max_gt_boxes=4))
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    grads = backward(model, opt, loss_l + loss_c)
    multibox = group_total({"loss_l": loss_l, "loss_c": loss_c})

    pix = torch.from_numpy(pl_logits["pixel"][rows]).requires_grad_()
    link = torch.from_numpy(pl_logits["link"][rows]).requires_grad_()
    loss, parts = pixellink_loss(pix, link, {k: torch.from_numpy(v[rows])
                                             for k, v in pl_targets.items()})
    loss.backward()
    pl = group_total({"loss": loss, **parts})

    bn = BatchNorm(bn_x.shape[1])
    bn.train()
    x = torch.from_numpy(bn_x[rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(bn_w[rows])).sum().backward()
    return {"multibox": {k: float(v.detach()) for k, v in multibox.items()},
            "grads": [g.clone() for g in grads],
            "pixellink": {k: float(v.detach()) for k, v in pl.items()},
            "pixel_grad": pix.grad, "link_grad": link.grad,
            "bn_y": y.detach(), "bn_dx": x.grad,
            "bn_running": (bn.running_mean.clone(), bn.running_var.clone())}


def fails(rank, when, pid_dir):
    """Rank body that fails: rank 1 raises ``when`` = "before" its first
    collective or "after" a summed step; rank 0 waits in the next
    collective. Each rank writes its pid to ``pid_dir`` first."""
    with open(os.path.join(pid_dir, f"{rank.index}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if rank.index == 1 and when == "before":
        raise ValueError("rank 1 fails before its first collective")
    from gssd_torch.parallel.collectives import all_reduce_

    all_reduce_(torch.ones(3))
    if rank.index == 1:
        raise ValueError("rank 1 fails after a step")
    all_reduce_(torch.ones(3))
    time.sleep(60)
    return None


def loaded_roots(rank):
    """Rank body: the root names of every module the rank has loaded."""
    import sys

    return sorted({name.split(".")[0] for name, mod in sys.modules.items() if mod is not None})


def split_eval(rank, state, priors_np, datapath, ids, image_size, eval_batch):
    """Rank body: the twin from ``state`` evaluated over ``ids`` with
    ``make_infer_step`` split by ``plan_infer_step`` at ``eval_batch`` ->
    {"ap": run_detection_eval's dict, "detections": every chunk's
    detections, concatenated, "pairs": a tuple-valued function's split
    outputs on a chunk of 4 rows and one of 1, "rows_seen": the rows each
    of its calls on this rank took, "not_split": whether the step at
    ``eval_batch - 1`` is the function itself}."""
    from gssd_torch.config import DetectConfig
    from gssd_torch.data import BaseTransform, LesionDataset
    from gssd_torch.eval import run_detection_eval
    from gssd_torch.parallel.mesh import plan_infer_step
    from gssd_torch.train.steps import make_infer_step

    model = MiniTwin()
    model.load_state_dict(state)
    step = plan_infer_step(make_infer_step(model, torch.from_numpy(priors_np), DetectConfig()),
                           rank, eval_batch)
    chunks = []

    def infer(batch):
        chunks.append(step(batch).cpu().numpy())
        return chunks[-1]

    ap = run_detection_eval(infer, LesionDataset(datapath, ids),
                            BaseTransform(image_size, 0.0, False, True), batch_size=eval_batch)
    seen = []
    split_pair = plan_infer_step(lambda x: pair(x, seen), rank, 4)
    x = pair_input()
    return {"ap": ap, "detections": np.concatenate(chunks),
            "pairs": [split_pair(x[:4]), split_pair(x[4:])], "rows_seen": seen,
            "not_split": plan_infer_step(pair, rank, eval_batch - 1) is pair}


def pair_input():
    return torch.arange(5 * 2 * 2 * 3, dtype=torch.float32).reshape(5, 2, 2, 3)


def pair(x, seen=None):
    """A two-output function with a row per image, as PixelLink's forward
    is; records the rows it took in ``seen``."""
    if seen is not None:
        seen.append(x.shape[0])
    return x[:, 0] * 2.0, x.sum(dim=(1, 2, 3))[:, None]


def _quiet():
    import sys

    sys.modules["torch.utils.tensorboard"] = None


def quiet_train(rank, args):
    """``gssd_torch.train``'s rank body, TensorBoard blocked."""
    from gssd_torch.train.trainer import _train

    _quiet()
    return _train(rank, args)


def quiet_pixellink(rank, args):
    """``gssd_torch.train_pixellink``'s rank body, TensorBoard blocked."""
    from gssd_torch.train_pixellink import _train

    _quiet()
    return _train(rank, args)


def mini_voc(rank, args):
    """``gssd_torch.train_voc``'s rank body with ``MiniVOC`` in place of
    the SSD300, TensorBoard blocked."""
    import gssd_torch.models as models
    from gssd_torch.train_voc import _train

    _quiet()
    models.build_model = build_mini_voc
    return _train(rank, args)
