"""The SSD detector family in PyTorch: SSD (multiphase), GSSD, GSSD++.

The counterpart of ``gssd_tpu/models/ssd.py``. ``SSD.forward`` takes
NHWC [B, H, W, 12] and returns f32 loc [B, P, 4] and conf [B, P, C]
logits with priors in (h, w, anchor) order, plus the 'offsets' aux list
when a DCN is on and, with ``return_attn``, the 'attn' / 'attn_base'
maps. Inside, activations are NCHW in the compute dtype.

Train behaviour follows ``module.training`` (flax's ``train=True``):
batch statistics in BatchNorm, a power iteration in each SNDense, and
``cfg.detach_sab`` cuts the gradient of the attention branch that feeds
the DCN.

Submodules carry the flax module names (vgg_1, attn_base_0, dcn_0,
fuse_1, loc_0, ...), so ``gssd_torch.params`` maps one tree onto the
other by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch import resolve_device
from gssd_torch.config import ModelConfig
from gssd_torch.ops.anchors import make_anchors
from gssd_torch.ops.deform_conv import DCN
from gssd_torch.ops.layers import (
    ConvBNRelu, L2Norm, SelfAttention, max_pool, xavier_uniform_)

# VGG-16 (reduced fc) channel plan; 'M' = 2x2/2 maxpool, 'C' = ceil-mode
# maxpool (75 -> 38)
VGG_STAGE1 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512]
VGG_STAGE2 = [512, 512, 512]  # conv5_x after an 'M'; then pool5/conv6/conv7

# extras: (out_1x1, out_3x3, stride, padding, kernel) per block; each
# block's 3x3 output is a source
EXTRAS = {
    300: [
        (256, 512, 2, 1, 3),
        (128, 256, 2, 1, 3),
        (128, 256, 1, 0, 3),
        (128, 256, 1, 0, 3),
    ],
    512: [
        (256, 512, 2, 1, 3),
        (128, 256, 2, 1, 3),
        (128, 256, 2, 1, 3),
        (128, 256, 2, 1, 3),
        (128, 256, 1, 1, 4),
    ],
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def slice_and_cat(a: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave two NCHW maps phase-group-wise on the channel axis:
    the output groups are [a_g, b_g] per phase, so the next grouped conv
    keeps per-phase context."""
    B, Ca, H, W = a.shape
    Cb = b.shape[1]
    ag = a.reshape(B, groups, Ca // groups, H, W)
    bg = b.reshape(B, groups, Cb // groups, H, W)
    return torch.cat([ag, bg], dim=2).reshape(B, Ca + Cb, H, W)


def add_heads(module: nn.Module, cfg: ModelConfig, channels: List[int],
              gen: torch.Generator) -> None:
    """The multibox heads on ``module``: per source i of ``channels[i]``
    channels, plain ungrouped 3x3 convs ``loc_i`` and ``conf_i``
    (Glorot-uniform weights from ``gen``, zero biases)."""
    mbox = cfg.anchor_config.num_priors_per_cell
    for i, (cs, nb) in enumerate(zip(channels, mbox)):
        for name, out in ((f"loc_{i}", nb * 4), (f"conf_{i}", nb * cfg.num_classes)):
            head = nn.Conv2d(cs, out, 3, padding=1)
            xavier_uniform_(head.weight, gen)
            nn.init.zeros_(head.bias)
            module.add_module(name, head)


def multibox(module: nn.Module, sources: List[torch.Tensor], num_classes: int
             ) -> Dict[str, torch.Tensor]:
    """The heads of ``add_heads`` over the NCHW sources -> f32 loc [B, P,
    4] and conf [B, P, num_classes], priors in (h, w, anchor) order."""
    B = sources[0].shape[0]
    locs, confs = [], []
    for i, src in enumerate(sources):
        for name, out, n in ((f"loc_{i}", locs, 4), (f"conf_{i}", confs, num_classes)):
            head = getattr(module, name)
            y = F.conv2d(src, head.weight.to(src.dtype), head.bias.to(src.dtype), padding=1)
            # NCHW -> NHWC before the flatten keeps prior order (h, w, anchor)
            out.append(y.permute(0, 2, 3, 1).reshape(B, -1, n))
    return {"loc": torch.cat(locs, dim=1).float(), "conf": torch.cat(confs, dim=1).float()}


class SSD(nn.Module):
    """See the module docstring."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        fs = cfg.feature_scale
        gen = torch.Generator().manual_seed(seed)
        n_attn = n_attn_base = 0

        def conv(name, cin, feats, k=3, s=1, p=1, d=1, groups=1):
            mod = ConvBNRelu(cin, feats * fs, k, s, p, d, groups,
                             use_bn=cfg.batch_norm, generator=gen)
            self.add_module(name, mod)
            return feats * fs

        def attn(prefix, c):
            nonlocal n_attn, n_attn_base
            i = n_attn_base if prefix == "attn_base" else n_attn
            self.add_module(f"{prefix}_{i}", SelfAttention(
                c, cfg.max_pool_factor, generator=gen))
            if prefix == "attn_base":
                n_attn_base += 1
            else:
                n_attn += 1

        # VGG stage 1 through conv4_3
        c, ci = cfg.in_channels, 0
        for v in VGG_STAGE1:
            if isinstance(v, int):
                ci += 1
                c = conv(f"vgg_{ci}", c, v, groups=cfg.groups_vgg)
        if cfg.use_self_attention_base:
            attn("attn_base", c)
        c_dcn = 2 * c if cfg.dcn_cat_sab else c  # + sigma * attn_g
        for i in range(cfg.num_dcn_layers):
            self.add_module(f"dcn_{i}", DCN(
                c_dcn, 512 * fs, deformable_groups=cfg.groups_dcn,
                impl=cfg.dcn_impl, generator=gen))
            c_dcn = 512 * fs
        c_src = c_dcn if cfg.num_dcn_layers else c
        src_channels = [c_src]
        self.l2norm = L2Norm(c_src, 20.0)
        if cfg.use_self_attention:
            attn("attn", c_src)
        if cfg.use_fuseconv:
            conv("fuse_1", c_src, 512, k=1, p=0)
            src_channels[-1] = 512 * fs

        # VGG stage 2: conv5_x, pool5, dilated conv6, conv7 (fc7)
        c = c_src
        for v in VGG_STAGE2:
            ci += 1
            c = conv(f"vgg_{ci}", c, v, groups=cfg.groups_vgg)
        c = conv("vgg_conv6", c, 1024, k=3, p=6, d=6, groups=cfg.groups_vgg)
        c = conv("vgg_conv7", c, 1024, k=1, p=0, groups=cfg.groups_vgg)
        if cfg.use_self_attention_base:
            attn("attn_base", c)
        if cfg.use_self_attention:
            attn("attn", c)
        src_channels.append(c)
        if cfg.use_fuseconv:
            conv("fuse_2", c, 1024, k=1, p=0)
            src_channels[-1] = 1024 * fs

        # extras
        for bi, (c1, c3, stride, pad, kk) in enumerate(EXTRAS[cfg.size]):
            c = conv(f"extra_{bi}_1", c, c1, k=1, p=0, groups=cfg.groups_extra)
            c = conv(f"extra_{bi}_3", c, c3, k=kk, s=stride, p=pad,
                     groups=cfg.groups_extra)
            if cfg.use_self_attention_base:
                attn("attn_base", c)
            if cfg.use_self_attention:
                attn("attn", c)
            src_channels.append(c)
            if cfg.use_fuseconv:
                conv(f"fuse_{bi + 3}", c, c3, k=1, p=0)
                src_channels[-1] = c3 * fs

        add_heads(self, cfg, src_channels, gen)

    def forward(self, x: torch.Tensor, return_attn: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        aux: Dict[str, List[torch.Tensor]] = {"offsets": [], "attn": [], "attn_base": []}
        counters = {"attn": 0, "attn_base": 0}

        def attn(prefix, t):
            i = counters[prefix]
            counters[prefix] += 1
            out, scaled, a = getattr(self, f"{prefix}_{i}")(t, return_attn,
                                                            remat=cfg.remat_attention)
            if return_attn:
                aux[prefix].append(a)
            return out, scaled

        def fuse(name, t):
            return getattr(self, name)(t) if cfg.use_fuseconv else t

        sources: List[torch.Tensor] = []
        # The JAX SSD runs a bf16 64-channel stem with even sides in its W-pair
        # packed layout (gssd_tpu/models/ssd.py:143-156, STEM_PACK on by
        # default), which never reaches the wide-conv gate and has the plain
        # conv's numbers; vgg_1 and vgg_2 keep the plain conv there, so the
        # SSD with USE_WIDE_CONV_KERNEL on gives the JAX numbers. The f32 SSD
        # takes the switch like any ConvBNRelu.
        packed_stem = (self.dtype == torch.bfloat16 and VGG_STAGE1[:3] == [64, 64, "M"]
                       and 64 * cfg.feature_scale <= 64
                       and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)
        ci = 0
        for v in VGG_STAGE1:
            if v == "M":
                x = max_pool(x, 2, 2)
            elif v == "C":
                x = max_pool(x, 2, 2, ceil_mode=True)
            else:
                ci += 1
                x = getattr(self, f"vgg_{ci}")(x, allow_wide=not (packed_stem and ci <= 2))

        attn_g = None
        if cfg.use_self_attention_base:
            x, attn_g = attn("attn_base", x)
        if cfg.dcn_cat_sab:
            sab = attn_g.detach() if cfg.detach_sab else attn_g
            x = slice_and_cat(x, sab, cfg.groups_vgg)
        for i in range(cfg.num_dcn_layers):
            x, offs = getattr(self, f"dcn_{i}")(x)
            aux["offsets"].append(offs)

        s = self.l2norm(x)
        if cfg.use_self_attention:
            s, _ = attn("attn", s)
        sources.append(fuse("fuse_1", s))

        x = max_pool(x, 2, 2)
        for _ in VGG_STAGE2:
            ci += 1
            x = getattr(self, f"vgg_{ci}")(x)
        x = max_pool(x, 3, 1, padding=1)  # pool5
        x = self.vgg_conv6(x)
        x = self.vgg_conv7(x)
        if cfg.use_self_attention_base:
            x, _ = attn("attn_base", x)
        s2 = x
        if cfg.use_self_attention:
            s2, _ = attn("attn", s2)
        sources.append(fuse("fuse_2", s2))

        for bi in range(len(EXTRAS[cfg.size])):
            x = getattr(self, f"extra_{bi}_1")(x)
            x = getattr(self, f"extra_{bi}_3")(x)
            if cfg.use_self_attention_base:
                x, _ = attn("attn_base", x)
            se = x
            if cfg.use_self_attention:
                se, _ = attn("attn", se)
            sources.append(fuse(f"fuse_{bi + 3}", se))

        result: Dict[str, Any] = multibox(self, sources, cfg.num_classes)
        for k, v in aux.items():
            if v:
                result[k] = v
        return result


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0
                ) -> Tuple[nn.Module, np.ndarray]:
    """Build the model on ``device`` (random weights drawn on the CPU
    from ``seed``) plus its constant anchor table [P, 4]. ``ssd_type``
    selects the variant, as in the JAX package's ``build_model``: 'ssd'
    (ungrouped, no fuse convs), 'gssd' (grouped + fuse convs, GSSD++ with
    the attention/DCN flags), 'fssd' / 'groupfssd' (the feature-fusion
    pyramid, ungrouped or with the configured groups) and 'fusedssd' (the
    deconv conv5_3 -> conv4_3 fusion); the FSSD family
    (``gssd_torch.models.fssd``) takes no attention or DCN flags."""
    if cfg.size == 512 and cfg.anchors == "v2":
        cfg = dataclasses.replace(cfg, anchors="v2_512")
    if cfg.ssd_type == "ssd":
        cfg = dataclasses.replace(cfg, groups_vgg=1, groups_extra=1,
                                  use_fuseconv=False)
    if cfg.ssd_type in ("fssd", "groupfssd", "fusedssd") and cfg.size != 300:
        raise ValueError(f"ssd_type={cfg.ssd_type!r} builds the 300 pyramid (38 ... 1); "
                         f"got size {cfg.size}")
    priors = make_anchors(cfg.anchor_config)
    if cfg.ssd_type in ("ssd", "gssd"):
        model: nn.Module = SSD(cfg, seed=seed)
    elif cfg.ssd_type in ("fssd", "groupfssd"):
        from gssd_torch.models.fssd import FSSD

        if cfg.ssd_type == "fssd":
            cfg = dataclasses.replace(cfg, groups_vgg=1, groups_extra=1)
        model = FSSD(cfg, seed=seed)
    elif cfg.ssd_type == "fusedssd":
        from gssd_torch.models.fssd import FusedSSD

        model = FusedSSD(cfg, seed=seed)
    else:
        raise NotImplementedError(f"ssd_type={cfg.ssd_type!r}")
    return model.to(resolve_device(device)), priors
