"""The FSSD family in PyTorch: FSSD, GroupFSSD and Fused-SSD.

The counterpart of ``gssd_tpu/models/fssd.py`` (:31-191), module for
module and name for name (``trunk``, ``conv8_1``, ``bn_fused``,
``fuse_deconv_53``, ``heads``, ...), so that ``gssd_torch.params`` maps
one tree onto the other:

- ``FSSD`` taps conv4_3, fc7 and an extra conv8_2 (1x1 1024 -> 256 + 3x3
  s2 256 -> 512), projects each to 256 channels with 1x1 convs,
  upsamples fc7's and conv8_2's bilinearly (align corners) to conv4_3's
  38x38, concatenates them to 768 channels, normalises the concat with
  ``bn_fused`` (in f32, cast back), builds a fresh 6-level pyramid
  conv9_1 .. conv14_1 (38, 19, 10, 5, 3, 1) from it, with the optional
  1x1 ``fuse_<i>`` convs before the heads. 'fssd' is it ungrouped,
  'groupfssd' with the configured groups (``build_model``).
- ``FusedSSD`` replaces the conv4_3 source with relu(L2Norm_20(conv3x3
  (conv4_3)) + L2Norm_10(conv3x3(BN(deconv2x2(conv5_3))))) (both convs
  with BN and no ReLU) and keeps the SSD's fc7 and extras pyramid.

Both share the grouped VGG-300 trunk (``_VGGTrunk``), built from plain
``ConvBNRelu``: unlike the SSD's stem it is not W-pair packed in the JAX
package, so conv1_1 and conv1_2 take the wide-conv switch
(``USE_WIDE_CONV_KERNEL``, the stem kernels) like any ``ConvBNRelu``.
``forward`` takes NHWC [B, 300, 300, 12] and returns f32 loc [B, 8732,
4] and conf [B, 8732, C]; the models take no attention or DCN flags.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.config import ModelConfig
from gssd_torch.models.pixellink import upsample_bilinear_ac
from gssd_torch.models.ssd import (_DTYPES, EXTRAS, VGG_STAGE1, VGG_STAGE2, add_heads,
                                   multibox)
from gssd_torch.ops.layers import BatchNorm, ConvBNRelu, L2Norm, max_pool, xavier_uniform_


class _Heads(nn.Module):
    """The multibox heads (``loc_i``, ``conf_i``) under their own name."""

    def __init__(self, cfg: ModelConfig, channels: List[int], gen: torch.Generator):
        super().__init__()
        self.num_classes = cfg.num_classes
        add_heads(self, cfg, channels, gen)

    def forward(self, sources: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        return multibox(self, sources, self.num_classes)


class _VGGTrunk(nn.Module):
    """The grouped VGG-300 trunk; returns conv4_3, conv5_3, fc7 (NCHW)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        fs = cfg.feature_scale
        c, ci = cfg.in_channels, 0

        def conv(name, cin, feats, k=3, p=1, d=1):
            self.add_module(name, ConvBNRelu(cin, feats * fs, k, 1, p, d, cfg.groups_vgg,
                                             use_bn=cfg.batch_norm, generator=gen))
            return feats * fs

        for v in VGG_STAGE1 + VGG_STAGE2:
            if isinstance(v, int):
                ci += 1
                c = conv(f"vgg_{ci}", c, v)
        c = conv("vgg_conv6", c, 1024, p=6, d=6)
        conv("vgg_conv7", c, 1024, k=1, p=0)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ci = 0
        for v in VGG_STAGE1:
            if v == "M":
                x = max_pool(x, 2, 2)
            elif v == "C":
                x = max_pool(x, 2, 2, ceil_mode=True)
            else:
                ci += 1
                x = getattr(self, f"vgg_{ci}")(x)
        conv4_3 = x
        x = max_pool(x, 2, 2)
        for _ in VGG_STAGE2:
            ci += 1
            x = getattr(self, f"vgg_{ci}")(x)
        conv5_3 = x
        x = max_pool(x, 3, 1, padding=1)
        x = self.vgg_conv6(x)
        return conv4_3, conv5_3, self.vgg_conv7(x)


class FSSD(nn.Module):
    """See the module docstring."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        fs, ge, g = cfg.feature_scale, cfg.groups_extra, cfg.groups_vgg
        gen = torch.Generator().manual_seed(seed)

        def conv(name, cin, feats, k=3, s=1, p=1, groups=1):
            self.add_module(name, ConvBNRelu(cin, feats * fs, k, s, p, 1, groups,
                                             use_bn=cfg.batch_norm, generator=gen))
            return feats * fs

        self.trunk = _VGGTrunk(cfg, gen)
        c81 = conv("conv8_1", 1024 * fs, 256, k=1, p=0, groups=ge)
        c82 = conv("conv8_2", c81, 512, s=2, groups=ge)
        conv("fuse_conv43", 512 * fs, 256, k=1, p=0, groups=g)
        conv("fuse_fc7", 1024 * fs, 256, k=1, p=0, groups=g)
        conv("fuse_conv82", c82, 256, k=1, p=0, groups=ge)
        self.bn_fused = BatchNorm(768 * fs) if cfg.batch_norm else None
        c, channels = 768 * fs, []
        for name, feats, s, p in (("conv9_1", 512, 1, 1), ("conv10_1", 512, 2, 1),
                                  ("conv11_1", 256, 2, 1), ("conv12_1", 256, 2, 1),
                                  ("conv13_1", 256, 1, 0), ("conv14_1", 256, 1, 0)):
            c = conv(name, c, feats, s=s, p=p, groups=ge)
            channels.append(c)
        if cfg.use_fuseconv:
            for i, c in enumerate(channels):
                conv(f"fuse_{i + 1}", c, c // fs, k=1, p=0)
        self.heads = _Heads(cfg, channels, gen)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        conv4_3, _, fc7 = self.trunk(x)
        c82 = self.conv8_2(self.conv8_1(fc7))
        size = conv4_3.shape[2]
        fused = torch.cat([self.fuse_conv43(conv4_3),
                           upsample_bilinear_ac(self.fuse_fc7(fc7), size, size),
                           upsample_bilinear_ac(self.fuse_conv82(c82), size, size)], dim=1)
        if self.bn_fused is not None:
            fused = self.bn_fused(fused).to(fused.dtype)
        sources, s = [], fused
        for name in ("conv9_1", "conv10_1", "conv11_1", "conv12_1", "conv13_1", "conv14_1"):
            s = getattr(self, name)(s)
            sources.append(s)
        if self.cfg.use_fuseconv:
            sources = [getattr(self, f"fuse_{i + 1}")(s) for i, s in enumerate(sources)]
        return self.heads(sources)


class FusedSSD(nn.Module):
    """See the module docstring."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        fs = cfg.feature_scale
        gen = torch.Generator().manual_seed(seed)

        def conv(name, cin, feats, k=3, s=1, p=1, groups=1, relu=True):
            self.add_module(name, ConvBNRelu(cin, feats * fs, k, s, p, 1, groups,
                                             use_bn=cfg.batch_norm, relu=relu, generator=gen))
            return feats * fs

        self.trunk = _VGGTrunk(cfg, gen)
        conv("fuse_conv_43", 512 * fs, 512, relu=False)
        self.l2norm_43 = L2Norm(512 * fs, 20.0)
        # the 2x2 stride-2 transposed conv of conv5_3 (19 -> 38), f32
        # parameters cast to the compute dtype at the call as flax does
        self.fuse_deconv_53 = nn.ConvTranspose2d(512 * fs, 512 * fs, 2, stride=2)
        xavier_uniform_(self.fuse_deconv_53.weight, gen)
        nn.init.zeros_(self.fuse_deconv_53.bias)
        self.bn_fuse_deconv_53 = BatchNorm(512 * fs) if cfg.batch_norm else None
        conv("fuse_conv_53", 512 * fs, 512, relu=False)
        self.l2norm_53 = L2Norm(512 * fs, 10.0)
        channels, c = [512 * fs, 1024 * fs], 1024 * fs
        for bi, (c1, c3, stride, pad, kk) in enumerate(EXTRAS[300]):
            c = conv(f"extra_{bi}_1", c, c1, k=1, p=0, groups=cfg.groups_extra)
            c = conv(f"extra_{bi}_3", c, c3, k=kk, s=stride, p=pad, groups=cfg.groups_extra)
            channels.append(c)
        self.heads = _Heads(cfg, channels, gen)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        conv4_3, conv5_3, fc7 = self.trunk(x)
        f43 = self.l2norm_43(self.fuse_conv_43(conv4_3))
        dc = self.fuse_deconv_53
        up = F.conv_transpose2d(conv5_3, dc.weight.to(conv5_3.dtype),
                                dc.bias.to(conv5_3.dtype), stride=2)
        if self.bn_fuse_deconv_53 is not None:
            up = self.bn_fuse_deconv_53(up).to(up.dtype)
        f53 = self.l2norm_53(self.fuse_conv_53(up))
        sources, xx = [F.relu(f43 + f53), fc7], fc7
        for bi in range(len(EXTRAS[300])):
            xx = getattr(self, f"extra_{bi}_3")(getattr(self, f"extra_{bi}_1")(xx))
            sources.append(xx)
        return self.heads(sources)
