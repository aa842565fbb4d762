"""PixelLink++ in PyTorch: the counterpart of ``gssd_tpu/models/pixellink.py``.

A grouped VGG16 trunk (conv1_1 .. conv7, no BatchNorm in the trunk,
ceil-mode pools 300 -> 150 -> 75 -> 38 -> 19, the 3/1/1 pool before
conv6, which has dilation 6 with ``cfg.dilation``), per-scale pixel (2
channels) and link (16) 1x1 heads, and a top-down sum of the heads with
bilinear (align_corners) upsampling to 1/2 ('2s') or 1/4 ('4s') of the
input; ``cascade_fuse`` concatenates every upsampled partial sum into
the final 1x1 convs. With the GSSD++ flags: fuse convs (+ BatchNorm, no
ReLU) before the heads, self-attention at every source and in the base,
and DCN phase alignment at conv2_2 ('2s') or conv3_3 ('4s') over
``slice_and_cat`` of the base attention's output. The attention blocks
are recomputed in the backward with ``cfg.remat_attention`` (the
default), as the JAX package does.

``PixelLink.forward`` takes NHWC [B, S, S, 12] and returns f32 NHWC
logits: "pixel" [B, S/f, S/f, 2] and "link" [B, S/f, S/f, 16] (f = 2 or
4), plus "offsets" when a DCN is on and, with ``return_attn``, the
attention maps "attn" and "attn_base" (one [B, N, M] map a site, in the
compute dtype), as the JAX model returns every non-empty aux list. Inside, activations are NCHW in the
compute dtype. Submodules carry the flax names (conv1_1, attn_base_0,
dcn_0, fuse_2, bn_fuse_2, out2_1, final_1, ...), so ``gssd_torch.params``
maps one tree onto the other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch import resolve_device
from gssd_torch.config import PixelLinkConfig
from gssd_torch.models.ssd import _DTYPES, slice_and_cat
from gssd_torch.ops.deform_conv import DCN
from gssd_torch.ops.layers import BatchNorm, ConvBNRelu, SelfAttention, max_pool, xavier_uniform_

# (name, output channels) of the trunk's 3x3 convs per stage; a ceil-mode
# 2x2 pool follows stages 1-4
STAGES = [
    [("conv1_1", 64), ("conv1_2", 64)],
    [("conv2_1", 128), ("conv2_2", 128)],
    [("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)],
    [("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)],
    [("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)],
]


def _interp_matrix(n: int, o: int) -> np.ndarray:
    """[o, n] align_corners bilinear interpolation weights."""
    m = np.zeros((o, n), np.float32)
    if o == 1 or n == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(o) * (n - 1) / (o - 1)
    i0 = np.floor(pos).astype(int)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = (pos - i0).astype(np.float32)
    m[np.arange(o), i0] += 1 - frac
    m[np.arange(o), i1] += frac
    return m


def upsample_bilinear_ac(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True semantics as two small
    matrix products whose weights are in x's dtype (bf16 weights in a
    bf16 model, as in the JAX package; ``F.interpolate`` keeps them in
    f32 and gives other numbers)."""
    h, w = x.shape[2], x.shape[3]
    if h == oh and w == ow:
        return x
    mh = torch.from_numpy(_interp_matrix(h, oh)).to(device=x.device, dtype=x.dtype)
    mw = torch.from_numpy(_interp_matrix(w, ow)).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,bchw->bcow", mh, x)
    return torch.einsum("pw,bcow->bcop", mw, x)


def _conv1x1(cin: int, cout: int, gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 1)
    xavier_uniform_(conv.weight, gen)
    nn.init.zeros_(conv.bias)
    return conv


def _apply1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


class PixelLink(nn.Module):
    """See the module docstring."""

    def __init__(self, cfg: PixelLinkConfig, cascade_fuse: bool = False,
                 batch_norm: bool = True, compute_dtype: str = "bfloat16",
                 dcn_impl: str = "hat", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.cascade_fuse = cascade_fuse
        self.batch_norm = batch_norm
        self.dtype = _DTYPES[compute_dtype]
        fs = cfg.feature_scale
        gen = torch.Generator().manual_seed(seed)
        two_s = cfg.version == "2s"
        count = {"attn": 0, "attn_base": 0}

        def attn(prefix, c):
            self.add_module(f"{prefix}_{count[prefix]}",
                            SelfAttention(c, cfg.max_pool_factor, generator=gen))
            count[prefix] += 1

        def source(c, idx):
            if cfg.use_self_attention:
                attn("attn", c)
            if cfg.use_fuseconv:
                self.add_module(f"fuse_{idx}", _conv1x1(c, c, gen))
                if batch_norm:
                    self.add_module(f"bn_fuse_{idx}", BatchNorm(c))
            self.add_module(f"out{idx}_1", _conv1x1(c, 2, gen))
            self.add_module(f"out{idx}_2", _conv1x1(c, 16, gen))

        c, n_heads = 12, 0
        for si, stage in enumerate(STAGES):
            for name, feats in stage:
                self.add_module(name, ConvBNRelu(c, feats * fs, 3, 1, 1, 1, cfg.vgg_groups,
                                                 generator=gen))
                c = feats * fs
            if si >= 2 or (two_s and si == 1):
                if cfg.use_self_attention_base:
                    attn("attn_base", c)
                if cfg.num_dcn_layers > 0 and si == (1 if two_s else 2):
                    c_in = 2 * c if cfg.dcn_cat_sab else c
                    for i in range(cfg.num_dcn_layers):
                        self.add_module(f"dcn_{i}", DCN(
                            c_in, c, deformable_groups=cfg.groups_dcn, impl=dcn_impl,
                            generator=gen))
                        c_in = c
                source(c, si)
                n_heads += 1
        p6 = 6 if cfg.dilation else 1
        self.conv6 = ConvBNRelu(c, 1024 * fs, 3, 1, p6, p6, cfg.vgg_groups, generator=gen)
        self.conv7 = ConvBNRelu(1024 * fs, 1024 * fs, 1, 1, 0, 1, cfg.vgg_groups, generator=gen)
        c = 1024 * fs
        if cfg.use_self_attention_base:
            attn("attn_base", c)
        source(c, 5)
        n_heads += 1
        # cascade_fuse: one upsampled partial sum per head
        self.final_1 = _conv1x1(2 * n_heads if cascade_fuse else 2, 2, gen)
        self.final_2 = _conv1x1(16 * n_heads if cascade_fuse else 16, 16, gen)

    def forward(self, x: torch.Tensor, return_attn: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        remat = cfg.remat_attention
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        aux: Dict[str, List[torch.Tensor]] = {"offsets": [], "attn": [], "attn_base": []}
        heads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        counters = {"attn": 0, "attn_base": 0}

        def attn(prefix, t):
            i = counters[prefix]
            counters[prefix] += 1
            out, scaled, a = getattr(self, f"{prefix}_{i}")(t, return_attn, remat=remat)
            if return_attn:
                aux[prefix].append(a)
            return out, scaled

        def base_attn(t):
            if not cfg.use_self_attention_base:
                return t, None
            return attn("attn_base", t)

        def source_block(s, idx):
            if cfg.use_self_attention:
                s, _ = attn("attn", s)
            if cfg.use_fuseconv:
                s = _apply1x1(getattr(self, f"fuse_{idx}"), s)
                if self.batch_norm:
                    s = getattr(self, f"bn_fuse_{idx}")(s).to(self.dtype)
            heads.append((_apply1x1(getattr(self, f"out{idx}_1"), s),
                          _apply1x1(getattr(self, f"out{idx}_2"), s)))

        def apply_dcn(t, attn_g):
            if cfg.dcn_cat_sab:
                sab = attn_g.detach() if cfg.detach_sab else attn_g
                t = slice_and_cat(t, sab, cfg.vgg_groups)
            for i in range(cfg.num_dcn_layers):
                t, offs = getattr(self, f"dcn_{i}")(t)
                aux["offsets"].append(offs)
            return t

        two_s = cfg.version == "2s"
        for si, stage in enumerate(STAGES):
            for name, _ in stage:
                x = getattr(self, name)(x)
            if si >= 2 or (two_s and si == 1):
                x, attn_g = base_attn(x)
                if cfg.num_dcn_layers > 0 and si == (1 if two_s else 2):
                    x = apply_dcn(x, attn_g)
                source_block(x, si)
            if si < 4:
                x = max_pool(x, 2, 2, ceil_mode=True)
        x = max_pool(x, 3, 1, padding=1)
        x = self.conv7(self.conv6(x))
        x, _ = base_attn(x)
        source_block(x, 5)

        def topdown(maps):
            c = maps[::-1]  # coarse -> fine: fc7, conv5_3, conv4_3, ...
            acc = c[0] + c[1]  # fc7 and conv5_3 share a resolution
            partials = [c[0], acc]
            for m in c[2:]:
                acc = upsample_bilinear_ac(acc, m.shape[2], m.shape[3]) + m
                partials.append(acc)
            return acc, partials

        out_pix, part_pix = topdown([h[0] for h in heads])
        out_lnk, part_lnk = topdown([h[1] for h in heads])
        if self.cascade_fuse:
            def fuse_final(acc, partials, conv):
                feats = [upsample_bilinear_ac(p, acc.shape[2], acc.shape[3]) for p in partials]
                return _apply1x1(conv, torch.cat(feats, dim=1))

            out_pix = fuse_final(out_pix, part_pix, self.final_1)
            out_lnk = fuse_final(out_lnk, part_lnk, self.final_2)
        else:
            out_pix = _apply1x1(self.final_1, out_pix)
            out_lnk = _apply1x1(self.final_2, out_lnk)
        out: Dict[str, Any] = {"pixel": out_pix.permute(0, 2, 3, 1).float(),
                               "link": out_lnk.permute(0, 2, 3, 1).float()}
        for k, v in aux.items():
            if v:
                out[k] = v
        return out


def build_pixellink(cfg: PixelLinkConfig, cascade_fuse: bool = False, batch_norm: bool = True,
                    compute_dtype: str = "bfloat16", dcn_impl: str = "hat",
                    device="cuda", seed: int = 0) -> PixelLink:
    """PixelLink++ on ``device`` with random weights drawn on the CPU from
    ``seed``."""
    return PixelLink(cfg, cascade_fuse, batch_norm, compute_dtype, dcn_impl,
                     seed=seed).to(resolve_device(device))
