"""Building blocks of the port, NCHW inside.

Counterparts of ``gssd_tpu/ops/layers.py`` on its plain lowerings:
grouped convs are grouped ``nn.Conv2d`` (the JAX package's
block-diagonal, pair-mode and W-pair packed lowerings compute the same
terms and are not ported). Parameters stay f32 and are cast to the
compute dtype (the dtype of the activations) at each call, as flax does.

``USE_WIDE_CONV_KERNEL`` is the counterpart of the JAX package's
``USE_PALLAS_WIDE_CONV`` (off by default there and here; a module
constant in both, set in-process): with it on, ``ConvBNRelu`` sends the
stem-class sites (3x3 / stride 1 / same, >= 5000 output pixels, at most
64 channels in and out) through the stem conv kernels
(``ops/kernels/stem_conv.py``), whose rounding differs from the plain
grouped conv's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gssd_torch.ops.kernels.flash_attn import flash_attention, flash_eligible
from gssd_torch.ops.kernels.stem_conv import stem_conv
from gssd_torch.parallel.collectives import all_reduce_sum, group_size

# the wide-conv switch (gssd_tpu/ops/layers.py:279 USE_PALLAS_WIDE_CONV),
# read at every call
USE_WIDE_CONV_KERNEL = False
# the least output pixels of a wide-conv site (gssd_tpu/ops/layers.py
# DENSE_GROUPS_MIN_HW)
WIDE_CONV_MIN_HW = 5000


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
    1 (variance 0). Parameter and buffer names are torch's.

    Inside a data-parallel group (``parallel.collectives.data_group``)
    the train-mode statistics are those of the fold's whole batch: each
    rank's per-channel sums of x and x^2 and its element count go through
    one differentiable all-reduce of a [2C + 1] vector, whose backward
    sums the same terms' gradients over the ranks."""

    MOMENTUM = 0.9  # flax's convention: the weight of the running value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if group_size() == 1:
                mean = x.mean(dim=(0, 2, 3))
                var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            else:
                c = x.shape[1]
                count = x.new_full((1,), x.numel() // c)
                sums = all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                                 (x * x).sum(dim=(0, 2, 3)), count]))
                mean = sums[:c] / sums[2 * c]
                var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                mom = self.MOMENTUM
                self.running_mean.mul_(mom).add_((1 - mom) * mean)
                self.running_var.mul_(mom).add_((1 - mom) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] + \
            self.bias[None, :, None, None]


class ConvBNRelu(nn.Module):
    """Grouped conv + optional BatchNorm (in f32, cast back to the
    compute dtype; see ``BatchNorm``) + optional ReLU.

    With ``USE_WIDE_CONV_KERNEL`` on, the conv of a site that passes the
    JAX package's gate (gssd_tpu/ops/layers.py:490-495, without its
    TPU-backend test) runs through ``stem_conv``; ``allow_wide=False``
    keeps a site on the plain conv (the SSD's packed stem)."""

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

    def wide(self, x: torch.Tensor) -> bool:
        """Whether the wide-conv switch takes this call."""
        c = self.conv
        h, w = x.shape[2], x.shape[3]
        return (USE_WIDE_CONV_KERNEL and c.kernel_size == (3, 3) and c.stride == (1, 1)
                and c.dilation == (1, 1) and c.padding == (1, 1) and h * w >= WIDE_CONV_MIN_HW
                and c.in_channels <= 64 and c.out_channels <= 64 and h > 4)

    def forward(self, x: torch.Tensor, allow_wide: bool = True) -> torch.Tensor:
        c = self.conv
        if allow_wide and self.wide(x):
            x = stem_conv(x, c.weight, c.bias, c.groups)
        else:
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

    @torch.no_grad()
    def power_iteration(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One power-iteration step from the stored vectors; stores the
        new u, v and returns copies of them."""
        w = self.kernel.t()
        v = w.t() @ self.u
        v = v / (v.norm() + self.eps)
        u = w @ v
        u = u / (u.norm() + self.eps)
        # the buffers get copies: the graph below reads u and v
        self.u.copy_(u)
        self.v.copy_(v)
        return u, v

    def forward(self, x: torch.Tensor, update: Optional[bool] = None) -> torch.Tensor:
        """``update`` (default: train mode) runs ``power_iteration`` first;
        without it sigma comes from the stored vectors."""
        update = self.training if update is None else update
        u, v = self.power_iteration() if update else (self.u, self.v)
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
    None). bf16 activations go through the fused flash kernel, at every
    key count on the card and up to ``MAX_M`` keys on the CPU
    (``flash_eligible``).

    ``remat`` (flax's ``nn.remat``): while gradients are recorded, the
    block runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward instead of keeping its activations. The train-mode power
    iterations of its four SNDense run once, before the checkpointed
    part, which reads the stored vectors, so the recompute forms sigma
    from the same u, v as the forward and the buffers are written once,
    as flax commits the ``spectral`` update once.
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

    def forward(self, x: torch.Tensor, return_attn: bool = False, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        if not (remat and torch.is_grad_enabled()):
            return self._attend(x, return_attn, self.training)
        if self.training:
            for mod in (self.theta, self.phi, self.g, self.out):
                mod.power_iteration()
        return checkpoint(self._attend, x, return_attn, False, use_reentrant=False)

    def _attend(self, x: torch.Tensor, return_attn: bool, update: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        b, c, h, w = x.shape
        pool = max(h // self.max_pool_factor, 1)
        tokens = x.flatten(2).transpose(1, 2)  # [B, N, C]
        q = self.theta(tokens, update)

        def pooled(mod):
            t = mod(tokens, update).transpose(1, 2).reshape(b, -1, h, w)
            return adaptive_avg_pool(t, pool).flatten(2).transpose(1, 2)

        k, v = pooled(self.phi), pooled(self.g)  # [B, M, C/8], [B, M, C/2]
        attn = None
        fused = q.dtype == torch.bfloat16 and flash_eligible(k.shape[1], q.device)
        if return_attn or not fused:
            logits = torch.matmul(q.float(), k.float().transpose(1, 2))
            attn = torch.softmax(logits, dim=-1).to(x.dtype)
        if fused:
            attn_g = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            attn_g = torch.matmul(attn, v)
        attn_g = self.out(attn_g, update).transpose(1, 2).reshape(b, c, h, w)
        scaled = self.sigma.to(x.dtype) * attn_g
        return x + scaled, scaled, attn
