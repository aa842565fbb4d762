"""The UNet liver-segmentation model in PyTorch and its pixel loss.

The counterpart of ``gssd_tpu/models/unet.py`` (:23-110): a classic UNet
with ``feature_scale``-divided widths [64, 128, 256, 512, 1024] / fs,
double 3x3 conv (+ BatchNorm + ReLU) blocks, 2x2 max-pool downs, 2x2
stride-2 transposed-conv ups (``is_deconv``) or a 2x bilinear resize
(half-pixel centres, ``jax.image.resize``'s) and a 1x1 conv, skip
concatenations ([skip, up]; the skip centre-cropped where odd sides made
the shapes drift) and a 1x1 class head in f32.

``UNet.forward`` takes NHWC [B, H, W, in_channels] and returns f32 NHWC
logits [B, H, W, n_classes]; inside, activations are NCHW in the compute
dtype, BatchNorm in f32 (flax's semantics, ``ops.layers.BatchNorm``).
Submodules carry the flax names (``down_1``, ``center``, ``up_4``,
``upconv_4``, ``final``; a block's ``conv``, ``bn``, ``conv_1``,
``bn_1`` for flax's ``Conv_0``, ``BatchNorm_0``, ``Conv_1``,
``BatchNorm_1``), so ``gssd_torch.params`` maps one tree onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.models.ssd import _DTYPES
from gssd_torch.ops.layers import BatchNorm, max_pool, xavier_uniform_


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """The variance of flax's default kernel init (1 / fan_in),
    untruncated, from ``gen``."""
    with torch.no_grad():
        return w.normal_(0.0, fan_in ** -0.5, generator=gen)


def _apply(conv: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """A conv (or transposed conv) with its f32 parameters cast to x's
    dtype, as flax casts them to the compute dtype."""
    fn = F.conv_transpose2d if isinstance(conv, nn.ConvTranspose2d) else F.conv2d
    return fn(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)


class DoubleConv(nn.Module):
    """(3x3 same conv -> BatchNorm -> ReLU) twice."""

    def __init__(self, in_channels: int, features: int, use_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 3, padding=1)
        self.bn = BatchNorm(features) if use_bn else None
        self.conv_1 = nn.Conv2d(features, features, 3, padding=1)
        self.bn_1 = BatchNorm(features) if use_bn else None
        for c in (self.conv, self.conv_1):
            xavier_uniform_(c.weight, generator)
            nn.init.zeros_(c.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv, self.bn), (self.conv_1, self.bn_1)):
            x = _apply(conv, x, padding=1)
            if bn is not None:
                x = bn(x).to(x.dtype)
            x = F.relu(x)
        return x


class UNet(nn.Module):
    """See the module docstring."""

    def __init__(self, n_classes: int = 2, feature_scale: int = 4, is_deconv: bool = True,
                 use_bn: bool = True, compute_dtype: str = "float32", in_channels: int = 1,
                 seed: int = 0):
        super().__init__()
        self.is_deconv = is_deconv
        self.dtype = _DTYPES[compute_dtype]
        gen = torch.Generator().manual_seed(seed)
        filters = [f // feature_scale for f in (64, 128, 256, 512, 1024)]
        c = in_channels
        for i, f in enumerate(filters[:-1]):
            self.add_module(f"down_{i + 1}", DoubleConv(c, f, use_bn, gen))
            c = f
        self.center = DoubleConv(c, filters[-1], use_bn, gen)
        c = filters[-1]
        for i, f in reversed(list(enumerate(filters[:-1]))):
            up = nn.ConvTranspose2d(c, f, 2, stride=2) if is_deconv else nn.Conv2d(c, f, 1)
            _lecun_normal_(up.weight, c * (4 if is_deconv else 1), gen)
            nn.init.zeros_(up.bias)
            self.add_module(f"up_{i + 1}", up)
            self.add_module(f"upconv_{i + 1}", DoubleConv(2 * f, f, use_bn, gen))
            c = f
        self.final = nn.Conv2d(c, n_classes, 1)
        _lecun_normal_(self.final.weight, c, gen)
        nn.init.zeros_(self.final.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        skips = []
        for i in range(1, 5):
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
            x = max_pool(x, 2, 2)
        x = self.center(x)
        for i in reversed(range(4)):
            up = getattr(self, f"up_{i + 1}")
            if self.is_deconv:
                x = _apply(up, x, stride=2)
            else:
                x = _apply(up, F.interpolate(x, scale_factor=2, mode="bilinear",
                                             align_corners=False))
            skip = skips[i]
            dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
            if dh or dw:  # centre-crop the skip where odd sides made the shapes drift
                skip = skip[:, :, dh // 2:dh // 2 + x.shape[2], dw // 2:dw // 2 + x.shape[3]]
            x = getattr(self, f"upconv_{i + 1}")(torch.cat([skip, x], dim=1))
        # the class head in f32, as the JAX package's (dtype=jnp.float32)
        logits = F.conv2d(x.float(), self.final.weight, self.final.bias)
        return logits.permute(0, 2, 3, 1)


def segmentation_nll_loss(logits: torch.Tensor, labels: torch.Tensor,
                          valid: Optional[torch.Tensor] = None,
                          class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per-pixel negative log likelihood of NHWC ``logits`` [B, H, W,
    C] at integer ``labels`` [B, H, W], with torch NLLLoss's class-weight
    semantics: the weighted sum over the pixels divided by the summed
    weights of their targets (``class_weight`` [C]); ``valid`` [B, H, W]
    masks pixels out (weight 0)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.ones_like(nll) if class_weight is None else class_weight.to(nll)[labels]
    if valid is not None:
        w = w * valid.to(nll)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)
