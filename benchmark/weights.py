"""Weights of a configuration made from the seed, on the card, in the
type they are kept in (float32 parameters, as the recipe keeps them).

One ``uniform_`` call in [-1, 1] over every float leaf at once and one
``normal_`` for the spectral-norm vectors, from a ``torch.Generator`` on
the device; each leaf is a slice of them scaled by its kind:

- convs: He-uniform (bound sqrt(6 / fan_in)), so activations keep their
  scale through ReLU; the DCN's weight likewise;
- heads and the DCN's offset conv: bound sqrt(3 / fan_in) (unit-variance
  outputs: logits of order 1, offsets of about a pixel);
- spectral-norm kernels: Glorot-uniform, as the model initialises them;
  their u and v: normal, then ``POWER_ITERATIONS`` power iterations, so
  that they hold the kernel's top singular vectors as a trained model's
  do (random ones give sigma near 0, and eval-mode activations without
  bound);
- biases within 0.1; BatchNorm scales 0.25 +- 0.05, shifts 1 +- 0.1,
  running means within 0.1, running variances in [1, 1.5]; attention
  scales sigma in [0.5, 1] (non-zero, so that the attention branch
  reaches the output); L2Norm scales 20 +- 2.

BatchNorm's shift of four of its scales keeps nearly every ReLU input
positive. A random BatchNorm network with ReLUs that cut at random is
chaotic (Yang et al., "A mean field theory of batch normalization", ICLR
2019): rounding alone scrambles its gradients, so that no comparison with
the float64 reference tells bfloat16 from fp8. On the CPU (the plain
reference at 300, batch 4, one seed each), the relative distance of the
first gradient when the reference's products are rounded to bfloat16:
46% with scales 1 and shifts 1 (fp8 1.7 times as far), 7% with scales 0.5
(3.2 times), 2.1% with 0.35 (3.3-5.2 times) and 1.4% with 0.25 (10
times); the loss falls over the first steps at the recipe's rate with
each (14 -> 13 with 0.25). Shifts of 2 at scale 1 calmed it too, but the
first SGD steps diverged (the loss 41 -> 55 -> 91).

A served model's BatchNorm running statistics are then those of the
plain reference's training-mode forward over the cell's own inputs
(``calibrate_batchnorm``), as training leaves them: statistics drawn at
random would let the eval-mode activations grow without bound through the
25 layers.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

SCALE = {
    "conv": lambda fan: math.sqrt(6.0 / fan),
    "dcn": lambda fan: math.sqrt(6.0 / fan),
    "head": lambda fan: math.sqrt(3.0 / fan),
    "offset": lambda fan: math.sqrt(3.0 / fan),
    "sn_kernel": lambda fan: math.sqrt(6.0 / fan),
}
AFFINE = {  # kind -> (centre, half-width)
    "bias": (0.0, 0.1), "bn_weight": (0.25, 0.05), "bn_bias": (1.0, 0.1), "bn_mean": (0.0, 0.1),
    "bn_var": (1.25, 0.25), "sigma": (0.75, 0.25), "l2norm": (20.0, 2.0),
}


POWER_ITERATIONS = 30


def make_weights(spec: Dict[str, Tuple[Tuple[int, ...], str, int]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for every entry of ``param_spec``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    floats = [(k, s, kind, fan) for k, (s, kind, fan) in spec.items() if kind not in ("count", "unit")]
    units = [(k, s) for k, (s, kind, _) in spec.items() if kind == "unit"]
    flat = torch.empty(sum(math.prod(s) for _, s, _, _ in floats), device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    normal = torch.empty(sum(math.prod(s) for _, s in units), device=device)
    normal.normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for k, s, kind, fan in floats:
        n = math.prod(s)
        u = flat[at:at + n].view(s)
        at += n
        if kind in SCALE:
            out[k] = u * SCALE[kind](fan)
        else:
            centre, half = AFFINE[kind]
            out[k] = u * half + centre
    at = 0
    for k, s in units:
        n = math.prod(s)
        v = normal[at:at + n].view(s)
        at += n
        out[k] = v / (v.norm() + 1e-12)
    for k in [k for k in spec if k.endswith(".kernel") and k[:-7] + ".u" in spec]:
        kernel, u = out[k], out[k[:-7] + ".u"]  # kernel [in, out], u [out]
        for _ in range(POWER_ITERATIONS):
            v = kernel @ u
            v = v / (v.norm() + 1e-12)
            u = kernel.t() @ v
            u = u / (u.norm() + 1e-12)
        out[k[:-7] + ".u"], out[k[:-7] + ".v"] = u, v
    for k, (s, kind, _) in spec.items():
        if kind == "count":
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return out


def calibrate_batchnorm(model_cfg: Dict, w: Dict[str, torch.Tensor], batches) -> None:
    """Set every ``*.bn.running_mean`` and ``*.bn.running_var`` of ``w`` in
    place to the mean over ``batches`` (each [B, H, W, 12]) of the batch
    statistics of the plain reference's training-mode forward, as a
    trained model's running averages hold them (no other change to
    ``w``). The average over several batches keeps the 1x1 maps'
    variances from resting on a handful of values."""
    from benchmark.reference.model import GSSD

    sums: Dict[str, list] = {}
    for images in batches:
        net = GSSD(model_cfg, w)
        net.bn_stats = {}
        with torch.no_grad():
            net.forward(images, train=True)
        for name, (mean, var) in net.bn_stats.items():
            acc = sums.setdefault(name, [0.0, 0.0])
            acc[0], acc[1] = acc[0] + mean, acc[1] + var
    n = len(batches)
    for name, (mean, var) in sums.items():
        w[f"{name}.bn.running_mean"].copy_(mean / n)
        w[f"{name}.bn.running_var"].copy_(var / n)
