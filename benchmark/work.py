"""The work a function needs, whatever implements it, and the card's peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 989e12 bf16 tensor-core
operations a second, 3.35e12 bytes a second of HBM3; exps at the MUFU
rate, 16 a clock an SM x 132 SMs x 1.83 GHz (the clock at which 989
TFLOP/s is 4096 bf16 operations a clock an SM).

Attention, softmax(q k^T) v with q [B, N, dk], k [B, M, dk], v [B, M, dv]:

- forward: 2 B N M (dk + dv) operations (q k^T and p v), one exp a logit;
  bytes: q, k, v read once, o written once, all bf16;
- backward: the four products dV = p^T dO, dP = dO v^T, dQ = dS k and
  dK = dS^T q, each once: 2 B N M (2 dk + 2 dv) operations; bytes: q, k,
  v, dO read once, dq, dk, dv written once.

The modulated deformable 3x3 conv, x [B, H, W, C] -> [B, H, W, Cout] with
G offset groups:

- forward: Cin 9 Cout multiply-adds a pixel; bytes: x (bf16), offsets and
  mask (f32, [B, H, W, G, 9] each, offsets two of them), the weight
  (bf16) read once, the output (bf16) written once;
- backward: that product twice (for dx and for dW); bytes: x, offsets,
  mask, weight and dOut read once, dx, doffsets, dmask and dW written
  once.

Not counted: the offset conv (a cuDNN conv), work a design recomputes, or
a TPU design's dense hat matrices. A bound is the largest of the terms.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.83e9
BF16, F32 = 2, 4

EXTRA_CHANNELS = {300: [512, 256, 256, 256], 512: [512, 256, 256, 256, 256]}


def attention_sites(model: Dict) -> List[Dict[str, int]]:
    """Every attention site of one forward: {"N", "M", "dk", "dv"}. A site
    sits at each source in the base list and again in the source list;
    the sources' channels are conv4_3's (or the DCN's) 512, conv7's 1024
    and each extra block's."""
    fs = model.get("feature_scale", 1)
    chans = [512 * fs, 1024 * fs] + EXTRA_CHANNELS[model["size"]]
    per = int(model["use_self_attention_base"]) + int(model["use_self_attention"])
    sites = []
    for f, c in zip(model["anchors"]["feature_maps"], chans):
        m = max(f // model["max_pool_factor"], 1) ** 2
        sites += [{"N": f * f, "M": m, "dk": c // 8, "dv": c // 2}] * per
    return sites


def attention_work(B: int, s: Dict[str, int], backward: bool) -> Dict[str, float]:
    N, M, dk, dv = s["N"], s["M"], s["dk"], s["dv"]
    if backward:
        return {"flops": 2.0 * B * N * M * (2 * dk + 2 * dv), "exps": 0.0,
                "bytes": BF16 * B * (2 * (N * dk + M * dk + M * dv) + N * dv)}
    return {"flops": 2.0 * B * N * M * (dk + dv), "exps": float(B * N * M),
            "bytes": BF16 * B * (N * dk + M * dk + M * dv + N * dv)}


def dcn_sites(model: Dict) -> List[Dict[str, int]]:
    """The deformable conv of one forward: conv4_3's map, 512 channels
    (1024 with the attention branch interleaved) in, 512 out."""
    f = model["anchors"]["feature_maps"][0]
    fs = model.get("feature_scale", 1)
    cin = 512 * fs * (2 if model["dcn_cat_sab"] else 1)
    return [{"H": f, "W": f, "C": cin, "Cout": 512 * fs, "G": model["groups_dcn"], "K": 9}
            ] * model["num_dcn_layers"]


def dcn_work(B: int, s: Dict[str, int], backward: bool) -> Dict[str, float]:
    P = B * s["H"] * s["W"]
    macs = P * s["C"] * s["K"] * s["Cout"]
    ins = P * s["C"] * BF16 + 3 * P * s["G"] * s["K"] * F32 + s["K"] * s["C"] * s["Cout"] * BF16
    out = P * s["Cout"] * BF16
    if backward:
        return {"flops": 4.0 * macs, "exps": 0.0, "bytes": float(2 * ins + out)}
    return {"flops": 2.0 * macs, "exps": 0.0, "bytes": float(ins + out)}


def bound_s(w: Dict[str, float]) -> float:
    """The least seconds the card could take for work ``w``."""
    return max(w["flops"] / PEAK_BF16_FLOPS, w["bytes"] / PEAK_BYTES, w["exps"] / PEAK_EXP)


def sites_bound_s(kind: str, model: Dict, B: int, backward: bool) -> float:
    """Sum of the bounds of every site of ``kind`` ('attention' or 'dcn')
    in one forward (and its backward, with ``backward``)."""
    sites, fn = ((attention_sites(model), attention_work) if kind == "attention"
                 else (dcn_sites(model), dcn_work))
    total = sum(bound_s(fn(B, s, False)) for s in sites)
    if backward:
        total += sum(bound_s(fn(B, s, True)) for s in sites)
    return total


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   transposed, _output_padding, _groups, output_mask, out_shape=None) -> int:
    """A convolution's backward: the forward's products once for the input's
    gradient and once for the weight's, each where it is asked for
    (FlopCounterMode's own formula counts a grouped conv's backward at
    5x its forward with 4 groups)."""
    from torch.utils.flop_counter import conv_flop_count

    once = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return once * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def model_flops(model: Dict, backward: bool) -> float:
    """FLOPs of one slice through the plain reference (convolutions and
    products, the DCN as its 9 per-tap products), forward and, with
    ``backward``, the backward too, counted by PyTorch's FlopCounterMode
    on the meta device (no data, no time), with ``_conv_backward``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.model import GSSD, param_spec

    dev = torch.device("meta")
    w = {}
    for name, (shape, kind, _) in param_spec(model).items():
        dt = torch.int64 if kind == "count" else torch.float32
        w[name] = torch.ones(shape, dtype=dt, device=dev, requires_grad=(
            backward and kind not in ("count", "unit", "bn_mean", "bn_var")))
    x = torch.ones(1, model["size"], model["size"], model["in_channels"], device=dev)
    mapping = {torch.ops.aten.convolution_backward: _conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        loc, conf = GSSD(model, w).forward(x, train=backward)
        if backward:
            (loc.sum() + conf.sum()).backward()
    return float(counter.get_total_flops())
