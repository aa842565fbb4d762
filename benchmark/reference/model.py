"""GSSD++ in plain PyTorch: the reference the benchmark holds the port to.

Written from the published description (Lee et al., GSSD++, IEEE TETCI
2021, and the reference repository's ``train_lesion_multiphase_v2``
flags), with no kernel, cache or batching trick, in the dtype of the
parameters it is given (the benchmark gives it float64):

- VGG-16 with grouped 3x3 convs (``groups_vgg`` phase groups), BatchNorm
  and ReLU, SSD's extras (``groups_extra``) and 1x1 fuse convs at every
  source;
- SAGAN self-attention (spectrally normalised 1x1 projections, one power
  iteration a training forward, no 1/sqrt(d) scale) in the base after
  conv4_3, conv7 and each extra block, and again at every source;
- one DCNv2 (modulated deformable conv, ``groups_dcn`` offset groups,
  bilinear sampling, zeros outside the map) over conv4_3 interleaved
  phase-group-wise with the base attention's branch;
- L2Norm (scale 20) on the first source, and 3x3 multibox heads.

``forward`` takes NHWC [B, H, W, 12] and returns loc [B, P, 4] and
conf [B, P, C] logits with priors in (h, w, anchor) order. Parameters are
a flat dict keyed by the names ``param_spec`` lists; the benchmark makes
them from the seed and hands the same dict to the program.

``quant`` (default: none) rounds both operands of every convolution and
product, and their gradients, to a lower precision: that is the control
the comparison must reject (``benchmark/reference/quant.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

VGG_STAGE1 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512]
VGG_STAGE2 = [512, 512, 512]
# (1x1 out, kxk out, stride, padding, kernel) per extra block
EXTRAS = {
    300: [(256, 512, 2, 1, 3), (128, 256, 2, 1, 3), (128, 256, 1, 0, 3), (128, 256, 1, 0, 3)],
    512: [(256, 512, 2, 1, 3), (128, 256, 2, 1, 3), (128, 256, 2, 1, 3), (128, 256, 2, 1, 3),
          (128, 256, 1, 1, 4)],
}
BN_EPS = 1e-5
SN_EPS = 1e-12
L2_EPS = 1e-10


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def priors_per_cell(cfg: Dict) -> List[int]:
    return [2 + 2 * len(ars) for ars in cfg["anchors"]["aspect_ratios"]]


def param_spec(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """name -> (shape, kind, fan_in) of every parameter and buffer, named as
    the port's state_dict names them. ``kind`` tells ``benchmark.weights``
    how to draw it."""
    spec: Dict[str, Tuple[Tuple[int, ...], str, int]] = {}
    fs = cfg.get("feature_scale", 1)

    def conv(name, cin, feats, k=3, groups=1):
        cout = feats * fs
        spec[f"{name}.conv.weight"] = ((cout, cin // groups, k, k), "conv", cin // groups * k * k)
        spec[f"{name}.conv.bias"] = ((cout,), "bias", 0)
        if cfg["batch_norm"]:
            for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                               ("running_mean", "bn_mean"), ("running_var", "bn_var")):
                spec[f"{name}.bn.{leaf}"] = ((cout,), kind, 0)
            spec[f"{name}.bn.num_batches_tracked"] = ((), "count", 0)
        return cout

    def sn(name, cin, cout):
        spec[f"{name}.kernel"] = ((cin, cout), "sn_kernel", cin + cout)
        spec[f"{name}.bias"] = ((cout,), "bias", 0)
        spec[f"{name}.u"] = ((cout,), "unit", 0)
        spec[f"{name}.v"] = ((cin,), "unit", 0)

    def attn(name, c):
        sn(f"{name}.theta", c, c // 8)
        sn(f"{name}.phi", c, c // 8)
        sn(f"{name}.g", c, c // 2)
        sn(f"{name}.out", c // 2, c)
        spec[f"{name}.sigma"] = ((1,), "sigma", 0)

    n_base = n_attn = 0

    def both(c, base=True, src=True):
        nonlocal n_base, n_attn
        if base and cfg["use_self_attention_base"]:
            attn(f"attn_base_{n_base}", c)
            n_base += 1
        if src and cfg["use_self_attention"]:
            attn(f"attn_{n_attn}", c)
            n_attn += 1

    c, ci = cfg["in_channels"], 0
    for v in VGG_STAGE1:
        if isinstance(v, int):
            ci += 1
            c = conv(f"vgg_{ci}", c, v, groups=cfg["groups_vgg"])
    both(c, src=False)
    c_dcn = 2 * c if cfg["dcn_cat_sab"] else c
    G, K = cfg["groups_dcn"], 9
    for i in range(cfg["num_dcn_layers"]):
        spec[f"dcn_{i}.conv_offset_mask.weight"] = ((3 * G * K, c_dcn, 3, 3), "offset", c_dcn * 9)
        spec[f"dcn_{i}.conv_offset_mask.bias"] = ((3 * G * K,), "bias", 0)
        spec[f"dcn_{i}.weight"] = ((K, c_dcn, 512 * fs), "dcn", c_dcn * K)
        spec[f"dcn_{i}.bias"] = ((512 * fs,), "bias", 0)
        c_dcn = 512 * fs
    c_src = c_dcn if cfg["num_dcn_layers"] else c
    spec["l2norm.weight"] = ((c_src,), "l2norm", 0)
    sources = [c_src]
    both(c_src, base=False)
    if cfg["use_fuseconv"]:
        sources[-1] = conv("fuse_1", c_src, 512, k=1)
    c = c_src
    for v in VGG_STAGE2:
        ci += 1
        c = conv(f"vgg_{ci}", c, v, groups=cfg["groups_vgg"])
    c = conv("vgg_conv6", c, 1024, k=3, groups=cfg["groups_vgg"])
    c = conv("vgg_conv7", c, 1024, k=1, groups=cfg["groups_vgg"])
    both(c)
    sources.append(c)
    if cfg["use_fuseconv"]:
        sources[-1] = conv("fuse_2", c, 1024, k=1)
    for bi, (c1, c3, _, _, kk) in enumerate(EXTRAS[cfg["size"]]):
        c = conv(f"extra_{bi}_1", c, c1, k=1, groups=cfg["groups_extra"])
        c = conv(f"extra_{bi}_3", c, c3, k=kk, groups=cfg["groups_extra"])
        both(c)
        sources.append(c)
        if cfg["use_fuseconv"]:
            sources[-1] = conv(f"fuse_{bi + 3}", c, c3, k=1)
    for i, (cs, nb) in enumerate(zip(sources, priors_per_cell(cfg))):
        for head, out in ((f"loc_{i}", nb * 4), (f"conf_{i}", nb * cfg["num_classes"])):
            spec[f"{head}.weight"] = ((out, cs, 3, 3), "head", cs * 9)
            spec[f"{head}.bias"] = ((out,), "bias", 0)
    return spec


def _sample(xg, py, px, mask, H: int, W: int) -> torch.Tensor:
    """xg [B, H*W, G, Cg] sampled bilinearly at (py, px) [B, P, G] (a
    corner outside the map gives 0), times ``mask`` -> [B, P, G, Cg]."""
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[..., None], (px - x0)[..., None]

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
        vals = torch.gather(xg, 1, idx[..., None].expand(-1, -1, -1, xg.shape[-1]))
        return torch.where(inside[..., None], vals, 0.0)

    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    return (top * (1 - wy) + bot * wy) * mask[..., None]


class GSSD:
    """The functional model over a parameter dict ``w``. ``w`` is used as
    given: a training caller passes leaves that require grad. The
    spectral-norm vectors ``*.u`` and ``*.v`` are copied into ``self.sn``
    and advanced there by every training forward."""

    def __init__(self, cfg: Dict, w: Dict[str, torch.Tensor],
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.cfg = cfg
        self.w = w
        self.q = quant or _identity
        self.sn = {k: v.detach().clone() for k, v in w.items() if k.endswith((".u", ".v"))}
        # where a caller sets it, train mode records each BatchNorm's batch
        # statistics here: {conv name: (mean, var)}
        self.bn_stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None

    # -- layers -----------------------------------------------------------

    def conv_bn_relu(self, name, x, stride=1, pad=0, dil=1, groups=1, train=False):
        w = self.w
        y = F.conv2d(self.q(x), self.q(w[f"{name}.conv.weight"]), w[f"{name}.conv.bias"],
                     stride, pad, dil, groups)
        if self.cfg["batch_norm"]:
            # training: the batch's mean and biased variance; eval: the running ones
            if train:
                mean = y.mean(dim=(0, 2, 3))
                var = y.var(dim=(0, 2, 3), unbiased=False)
                if self.bn_stats is not None:
                    self.bn_stats[name] = (mean.detach(), var.detach())
            else:
                mean, var = w[f"{name}.bn.running_mean"], w[f"{name}.bn.running_var"]
            mul = torch.rsqrt(var + BN_EPS) * w[f"{name}.bn.weight"]
            # y * mul + shift keeps one full-size tensor for the backward
            y = y * mul[None, :, None, None] \
                + (w[f"{name}.bn.bias"] - mean * mul)[None, :, None, None]
        return F.relu(y)

    def sn_dense(self, name, x, train):
        kernel = self.w[f"{name}.kernel"]  # [in, out]
        u, v = self.sn[f"{name}.u"], self.sn[f"{name}.v"]
        if train:
            with torch.no_grad():
                v = kernel.detach() @ u
                v = v / (v.norm() + SN_EPS)
                u = kernel.detach().t() @ v
                u = u / (u.norm() + SN_EPS)
                self.sn[f"{name}.u"], self.sn[f"{name}.v"] = u, v
        sigma = torch.dot(u, kernel.t() @ v)
        return self.q(x) @ self.q(kernel / sigma) + self.w[f"{name}.bias"]

    def attention(self, name, x, train):
        """(x + sigma * attn_g, sigma * attn_g) over NCHW x."""
        b, c, h, wd = x.shape
        pool = max(h // self.cfg["max_pool_factor"], 1)
        tokens = x.flatten(2).transpose(1, 2)
        q = self.sn_dense(f"{name}.theta", tokens, train)

        def pooled(part):
            t = self.sn_dense(f"{name}.{part}", tokens, train).transpose(1, 2).reshape(b, -1, h, wd)
            if pool != h:
                t = F.adaptive_avg_pool2d(t, pool)
            return t.flatten(2).transpose(1, 2)

        k, v = pooled("phi"), pooled("g")
        attn = torch.softmax(self.q(q) @ self.q(k).transpose(1, 2), dim=-1)
        attn_g = self.q(attn) @ self.q(v)
        attn_g = self.sn_dense(f"{name}.out", attn_g, train).transpose(1, 2).reshape(b, c, h, wd)
        scaled = self.w[f"{name}.sigma"] * attn_g
        return x + scaled, scaled

    def dcn(self, name, x):
        """Modulated deformable 3x3 conv, stride 1, padding 1, NCHW. Each
        tap's bilinear samples are recomputed in the backward
        (``torch.utils.checkpoint``) rather than kept: at batch 32 in
        float64 they would take tens of GB."""
        w, G, K = self.w, self.cfg["groups_dcn"], 9
        B, C, H, W = x.shape
        om = F.conv2d(self.q(x), self.q(w[f"{name}.conv_offset_mask.weight"]),
                      w[f"{name}.conv_offset_mask.bias"], 1, 1)
        om = om.permute(0, 2, 3, 1).reshape(B, H, W, 3, G, K)
        oy, ox, mask = om[..., 0, :, :], om[..., 1, :, :], torch.sigmoid(om[..., 2, :, :])
        xg = x.permute(0, 2, 3, 1).reshape(B, H * W, G, C // G)
        base_y = (torch.arange(H, device=x.device, dtype=x.dtype) - 1)[:, None, None]
        base_x = (torch.arange(W, device=x.device, dtype=x.dtype) - 1)[None, :, None]
        weight = w[f"{name}.weight"]  # [K, C, Cout]
        acc = None
        for k in range(K):
            ky, kx = divmod(k, 3)
            py = (base_y + ky + oy[..., k]).reshape(B, H * W, G)
            px = (base_x + kx + ox[..., k]).reshape(B, H * W, G)
            mk = mask[..., k].reshape(B, H * W, G)
            if torch.is_grad_enabled():
                sampled = checkpoint(_sample, xg, py, px, mk, H, W, use_reentrant=False)
            else:
                sampled = _sample(xg, py, px, mk, H, W)
            tap = self.q(sampled.reshape(B, H * W, C)) @ self.q(weight[k])
            acc = tap if acc is None else acc + tap
        out = acc + w[f"{name}.bias"]
        return out.reshape(B, H, W, -1).permute(0, 3, 1, 2)

    # -- the network ------------------------------------------------------

    def forward(self, x: torch.Tensor, train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, w = self.cfg, self.w
        gv, ge = cfg["groups_vgg"], cfg["groups_extra"]
        x = x.to(w["l2norm.weight"].dtype).permute(0, 3, 1, 2)
        counters = {"attn_base": 0, "attn": 0}

        def attn(prefix, t):
            i = counters[prefix]
            counters[prefix] += 1
            return self.attention(f"{prefix}_{i}", t, train)

        def fuse(name, t):
            if not cfg["use_fuseconv"]:
                return t
            return self.conv_bn_relu(name, t, train=train)

        ci = 0
        for v in VGG_STAGE1:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            elif v == "C":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                ci += 1
                x = self.conv_bn_relu(f"vgg_{ci}", x, pad=1, groups=gv, train=train)
        sab = None
        if cfg["use_self_attention_base"]:
            x, sab = attn("attn_base", x)
        if cfg["dcn_cat_sab"]:
            B, Ca, H, W = x.shape
            x = torch.cat([x.reshape(B, gv, Ca // gv, H, W), sab.reshape(B, gv, -1, H, W)],
                          dim=2).reshape(B, -1, H, W)
        for i in range(cfg["num_dcn_layers"]):
            x = self.dcn(f"dcn_{i}", x)
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True)) + L2_EPS
        s = x / norm * w["l2norm.weight"][None, :, None, None]
        if cfg["use_self_attention"]:
            s, _ = attn("attn", s)
        sources = [fuse("fuse_1", s)]

        x = F.max_pool2d(x, 2, 2)
        for _ in VGG_STAGE2:
            ci += 1
            x = self.conv_bn_relu(f"vgg_{ci}", x, pad=1, groups=gv, train=train)
        x = F.max_pool2d(x, 3, 1, padding=1)
        x = self.conv_bn_relu("vgg_conv6", x, pad=6, dil=6, groups=gv, train=train)
        x = self.conv_bn_relu("vgg_conv7", x, groups=gv, train=train)
        if cfg["use_self_attention_base"]:
            x, _ = attn("attn_base", x)
        s2 = attn("attn", x)[0] if cfg["use_self_attention"] else x
        sources.append(fuse("fuse_2", s2))
        for bi, (_, _, stride, pad, _) in enumerate(EXTRAS[cfg["size"]]):
            x = self.conv_bn_relu(f"extra_{bi}_1", x, groups=ge, train=train)
            x = self.conv_bn_relu(f"extra_{bi}_3", x, stride=stride, pad=pad, groups=ge,
                                  train=train)
            if cfg["use_self_attention_base"]:
                x, _ = attn("attn_base", x)
            se = attn("attn", x)[0] if cfg["use_self_attention"] else x
            sources.append(fuse(f"fuse_{bi + 3}", se))

        B, locs, confs = x.shape[0], [], []
        for i, src in enumerate(sources):
            for head, out, n in ((f"loc_{i}", locs, 4), (f"conf_{i}", confs, cfg["num_classes"])):
                y = F.conv2d(self.q(src), self.q(w[f"{head}.weight"]), w[f"{head}.bias"],
                             padding=1)
                out.append(y.permute(0, 2, 3, 1).reshape(B, -1, n))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
