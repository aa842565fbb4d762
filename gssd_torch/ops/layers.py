"""Building blocks of the port, NCHW inside.

Counterparts of ``gssd_tpu/ops/layers.py`` on its plain lowerings:
grouped convs are grouped ``nn.Conv2d`` (the JAX package's
block-diagonal, pair-mode and W-pair packed lowerings compute the same
terms and are not ported). Parameters stay f32 and are cast to the
compute dtype (the dtype of the activations) at each call, as flax does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gssd_torch.ops.kernels.flash_attn import flash_attention, flash_eligible


def xavier_uniform_(w: torch.Tensor, generator: Optional[torch.Generator]):
    """Glorot-uniform init of a weight in place (fan-in/out from torch's
    [out, in, ...] layout), drawn from ``generator``."""
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)
    return w


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             ceil_mode: bool = False, padding: int = 0) -> torch.Tensor:
    """NCHW max pool with ceil mode (75 -> 38) and -inf padding."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NCHW adaptive average pool: segment i of an n -> t pool averages
    rows floor(i*n/t) .. ceil((i+1)*n/t). The identity when the map
    already has out_size^2 cells."""
    if x.shape[2] == out_size and x.shape[3] == out_size:
        return x
    return F.adaptive_avg_pool2d(x, out_size)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW in f32 with flax's semantics.

    Eval: the running statistics. Train (``self.training``): the batch
    mean and the biased variance E[x^2] - E[x]^2 (clamped at 0) over
    (N, H, W), and ``running = 0.9 * running + 0.1 * batch`` for both
    statistics, updated in place outside autograd. Unlike torch's own
    train mode it keeps the biased variance and takes a 1x1 map at batch
    1 (variance 0). Parameter and buffer names are torch's."""

    MOMENTUM = 0.9  # flax's convention: the weight of the running value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                mom = self.MOMENTUM
                self.running_mean.mul_(mom).add_((1 - mom) * mean)
                self.running_var.mul_(mom).add_((1 - mom) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] + \
            self.bias[None, :, None, None]


class ConvBNRelu(nn.Module):
    """Grouped conv + optional BatchNorm (in f32, cast back to the
    compute dtype; see ``BatchNorm``) + optional ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bn: bool = False, relu: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, padding,
                              dilation, groups)
        xavier_uniform_(self.conv.weight, generator)
        nn.init.zeros_(self.conv.bias)
        self.bn = BatchNorm(features) if use_bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride,
                     c.padding, c.dilation, c.groups)
        if self.bn is not None:
            x = self.bn(x.float()).to(x.dtype)
        return F.relu(x) if self.relu else x


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation then a learned per-channel scale:
    x / (||x|| + eps) * w, in f32 (the eps is added to the norm)."""

    def __init__(self, channels: int, scale: float = 20.0, eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True)) + self.eps
        return (x32 / norm * self.weight[None, :, None, None]).to(x.dtype)


class SNDense(nn.Module):
    """Spectral-normalised 1x1 conv over the last (channel) axis,
    W = kernel^T [out, in]; the kernel is stored [in, out] as in flax.

    Eval: sigma = u . (W v) from the stored power-iteration vectors.
    Train: one power iteration first, outside autograd (v = normalize(W^T
    u), u = normalize(W v), eps 1e-12 added to the norm), the new vectors
    stored, and sigma = u . (W v) from them: gradients reach the kernel
    through W but not through u and v."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        # [in, out] is the transpose of torch's [out, in]; xavier is symmetric
        xavier_uniform_(self.kernel, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        u = torch.randn(features, generator=generator)
        v = torch.randn(in_features, generator=generator)
        self.eps = 1e-12
        self.register_buffer("u", u / (u.norm() + self.eps))
        self.register_buffer("v", v / (v.norm() + self.eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, v = self.u, self.v
        if self.training:
            with torch.no_grad():
                w = self.kernel.t()
                v = w.t() @ u
                v = v / (v.norm() + self.eps)
                u = w @ v
                u = u / (u.norm() + self.eps)
                # the buffers get copies: the graph below reads u and v
                self.u.copy_(u)
                self.v.copy_(v)
        sigma = torch.dot(u, self.kernel.t() @ v)
        w_sn = (self.kernel / sigma).to(x.dtype)
        return x @ w_sn + self.bias.to(x.dtype)


class SelfAttention(nn.Module):
    """SAGAN self-attention over the spatial grid, NCHW in and out.

    theta: C -> C/8 queries at full resolution; phi/g: C/8 and C/2 keys
    and values, adaptively avg-pooled to (H // max_pool_factor)^2
    tokens; out: C/2 -> C. No 1/sqrt(d) scale. Returns
    (x + sigma * attn_g, sigma * attn_g, attn) where the attention map
    ``attn`` [B, N, M] is built only when ``return_attn`` is set (else
    None). bf16 activations go through the fused flash kernel.
    """

    def __init__(self, channels: int, max_pool_factor: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = channels
        self.max_pool_factor = max_pool_factor
        self.theta = SNDense(c, c // 8, generator)
        self.phi = SNDense(c, c // 8, generator)
        self.g = SNDense(c, c // 2, generator)
        self.out = SNDense(c // 2, c, generator)
        self.sigma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, return_attn: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        b, c, h, w = x.shape
        pool = max(h // self.max_pool_factor, 1)
        tokens = x.flatten(2).transpose(1, 2)  # [B, N, C]
        q = self.theta(tokens)

        def pooled(mod):
            t = mod(tokens).transpose(1, 2).reshape(b, -1, h, w)
            return adaptive_avg_pool(t, pool).flatten(2).transpose(1, 2)

        k, v = pooled(self.phi), pooled(self.g)  # [B, M, C/8], [B, M, C/2]
        attn = None
        if return_attn or not (q.dtype == torch.bfloat16 and flash_eligible(k.shape[1])):
            logits = torch.matmul(q.float(), k.float().transpose(1, 2))
            attn = torch.softmax(logits, dim=-1).to(x.dtype)
        if q.dtype == torch.bfloat16 and flash_eligible(k.shape[1]):
            attn_g = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            attn_g = torch.matmul(attn, v)
        attn_g = self.out(attn_g).transpose(1, 2).reshape(b, c, h, w)
        scaled = self.sigma.to(x.dtype) * attn_g
        return x + scaled, scaled, attn
