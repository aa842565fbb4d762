"""Train, eval and inference steps of the port.

A train step runs the model in train mode (batch statistics and their
running update, one spectral-norm power iteration per SNDense), matches
the targets, takes the MultiBox loss, backpropagates, measures the
global gradient norm before any clip, and applies one SGD step at that
step's LR. The pieces (``forward_loss``, ``backward``, ``update``) are
separate so that a caller can time them one by one.

A batch is a dict of device tensors: ``image`` [B, H, W, 12] f32,
``boxes`` [B, G, 4] point form, ``labels`` [B, G] int, ``valid`` [B, G]
bool; a PixelLink batch also holds the target maps ``pixel_mask``,
``neg_pixel_mask``, ``pixel_pos_weight`` and ``link_mask``.

The PixelLink steps (``pixellink_train_step``, ``pixellink_eval_step``,
``make_pixellink_forward``) are those of the JAX package's
``make_pixellink_train_step`` and friends: the 2:1 weighted pixel and link
loss in place of MultiBox, the same backward and SGD update.

``make_infer_step_with_aux`` and ``make_pixellink_forward_with_aux`` are
the ``--visualize`` variants: the same outputs plus the aux lists of the
eval-mode forward (DCN offsets, attention maps), on the device.

Inside a data-parallel group (``parallel.collectives.data_group``) a
batch holds this rank's rows and the loss is its share of the fold's
loss; ``backward`` sums the gradients over the group (one flat
all-reduce, before the norm, the clip and the SGD step), so every rank
applies the gradient of the whole batch's loss, and the steps report
the losses summed over the group: the whole batch's.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Tuple

import torch

from gssd_torch.config import DetectConfig, LossConfig, OptimConfig, PixelLinkConfig
from gssd_torch.ops.losses import multibox_loss
from gssd_torch.ops.pixellink_loss import pixellink_loss
from gssd_torch.ops.nms import detect
from gssd_torch.parallel.collectives import all_reduce_, group_size, sum_grads_
from gssd_torch.train.optim import clip_by_global_norm_, global_norm, set_lr


def forward_loss(model, priors: torch.Tensor, batch: Dict[str, torch.Tensor],
                 loss_cfg: LossConfig) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Forward in the model's current mode plus the loss ->
    (loss_l, loss_c, aux)."""
    out = model(batch["image"])
    return multibox_loss(out["loc"], out["conf"], priors, batch["boxes"],
                         batch["labels"], batch["valid"], loss_cfg)


def backward(model, optimizer, loss: torch.Tensor) -> List[torch.Tensor]:
    """Gradients of ``loss`` into every parameter (zeros where a
    parameter does not reach the loss, so that weight decay and momentum
    still apply to it as in optax), summed over the data-parallel group.
    Returns them."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    sum_grads_(grads)
    return grads


def group_total(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each of the rank's loss shares summed over the data-parallel group
    (one all-reduce): the fold's losses. Unchanged outside a group."""
    if group_size() == 1:
        return values
    summed = all_reduce_(torch.stack([v.detach().float() for v in values.values()]))
    return dict(zip(values, summed.unbind()))


def update(optimizer, grads: List[torch.Tensor], optim_cfg: OptimConfig,
           step: int) -> Tuple[torch.Tensor, float]:
    """Global norm of ``grads`` (before the clip), the optional clip and
    the SGD step at step ``step``'s LR -> (grad_norm, base lr)."""
    norm = global_norm(grads)
    if optim_cfg.clip is not None:
        clip_by_global_norm_(grads, optim_cfg.clip, norm)
    lr = set_lr(optimizer, optim_cfg, step)
    optimizer.step()
    return norm, lr


def train_step(model, optimizer, priors, batch, loss_cfg: LossConfig,
               optim_cfg: OptimConfig, step: int) -> Dict[str, torch.Tensor]:
    """One step; returns loss, loss_l, loss_c, grad_norm, num_pos (device
    scalars) and lr (float)."""
    model.train()
    loss_l, loss_c, aux = forward_loss(model, priors, batch, loss_cfg)
    loss = loss_l + loss_c
    grads = backward(model, optimizer, loss)
    norm, lr = update(optimizer, grads, optim_cfg, step)
    losses = group_total({"loss": loss.detach(), "loss_l": loss_l.detach(),
                          "loss_c": loss_c.detach()})
    return {**losses, "grad_norm": norm, "num_pos": aux["num_pos"], "lr": lr}


def eval_step(model, priors, batch, loss_cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Validation loss: eval-mode forward (running BN statistics, stored
    spectral vectors) plus the same loss."""
    model.eval()
    with torch.no_grad():
        loss_l, loss_c, _ = forward_loss(model, priors, batch, loss_cfg)
    return group_total({"loss": loss_l + loss_c, "loss_l": loss_l, "loss_c": loss_c})


def make_infer_step(model, priors: torch.Tensor, detect_cfg: DetectConfig) -> Callable:
    """Test-phase forward: a [B, H, W, 12] float batch (numpy or tensor)
    -> eval-mode forward, softmax over the classes and Detect/NMS ->
    [B, C, top_k, 5] (score, x1, y1, x2, y2) on the model's device."""
    device = priors.device

    def infer_step(images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(images)
        model.eval()
        with torch.inference_mode():
            out = model(images.to(device))
            conf = torch.softmax(out["conf"], dim=-1)
            return detect(out["loc"], conf, priors, detect_cfg)

    return infer_step


AUX_KEYS = ("offsets", "attn", "attn_base")


def _forward_with_aux(model, images: torch.Tensor) -> Tuple[Dict, Dict[str, List]]:
    """The forward with its attention maps built (``return_attn``, where
    the model has attention) -> (outputs, the non-empty aux lists)."""
    if "return_attn" in inspect.signature(model.forward).parameters:
        out = model(images, return_attn=True)
    else:
        out = model(images)
    return out, {k: out[k] for k in AUX_KEYS if k in out}


def make_infer_step_with_aux(model, priors: torch.Tensor, detect_cfg: DetectConfig) -> Callable:
    """--visualize variant of ``make_infer_step``: a batch -> (detections
    [B, C, top_k, 5], {"offsets": [[B, Ho, Wo, G, K, 2] a DCN layer],
    "attn", "attn_base": [[B, N, M] a site]}), the aux lists those the
    forward gave, all on the model's device."""
    device = priors.device

    def infer_step(images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(images)
        model.eval()
        with torch.inference_mode():
            out, aux = _forward_with_aux(model, images.to(device))
            conf = torch.softmax(out["conf"], dim=-1)
            return detect(out["loc"], conf, priors, detect_cfg), aux

    return infer_step


PIXELLINK_TARGETS = ("pixel_mask", "neg_pixel_mask", "pixel_pos_weight", "link_mask")


def pixellink_forward_loss(model, batch: Dict[str, torch.Tensor], plc: PixelLinkConfig
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward in the model's current mode plus the weighted pixel and
    link loss -> (loss, {"pixel_loss", "link_loss"})."""
    out = model(batch["image"])
    return pixellink_loss(out["pixel"], out["link"], {k: batch[k] for k in PIXELLINK_TARGETS},
                          pixel_weight=plc.pixel_weight, link_weight=plc.link_weight,
                          neg_pos_ratio=plc.neg_pos_ratio)


def pixellink_train_step(model, optimizer, batch, plc: PixelLinkConfig,
                         optim_cfg: OptimConfig, step: int) -> Dict[str, torch.Tensor]:
    """One PixelLink step; returns loss, pixel_loss, link_loss, grad_norm
    (device scalars) and lr (float)."""
    model.train()
    loss, parts = pixellink_forward_loss(model, batch, plc)
    grads = backward(model, optimizer, loss)
    norm, lr = update(optimizer, grads, optim_cfg, step)
    losses = group_total({"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}})
    return {**losses, "grad_norm": norm, "lr": lr}


def pixellink_eval_step(model, batch, plc: PixelLinkConfig) -> Dict[str, torch.Tensor]:
    """Validation loss: eval-mode forward plus the same weighted loss."""
    model.eval()
    with torch.no_grad():
        loss, parts = pixellink_forward_loss(model, batch, plc)
    return group_total({"loss": loss, **parts})


def make_pixellink_forward(model, device, host: bool = True) -> Callable:
    """Eval-mode forward: a [B, H, W, 12] float batch (numpy or tensor)
    -> (pixel [B, h, w, 2], link [B, h, w, 16]) f32 logits on the host,
    for ``mask_to_boxes``; with ``host=False`` the two tensors on the
    device (for a gather over the ranks before the host copy)."""

    def forward(images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(images)
        model.eval()
        with torch.inference_mode():
            out = model(images.to(device))
            if not host:
                return out["pixel"], out["link"]
            return out["pixel"].cpu().numpy(), out["link"].cpu().numpy()

    return forward


def make_pixellink_forward_with_aux(model, device) -> Callable:
    """--visualize variant of ``make_pixellink_forward``: a batch ->
    (pixel, link logits on the host, the aux lists on the device)."""

    def forward(images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(images)
        model.eval()
        with torch.inference_mode():
            out, aux = _forward_with_aux(model, images.to(device))
            return out["pixel"].cpu().numpy(), out["link"].cpu().numpy(), aux

    return forward
