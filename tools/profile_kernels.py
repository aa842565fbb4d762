#!/usr/bin/env python3
"""Device time of every CUDA kernel inside the port's multi-kernel
launches, at the shapes chip_smoke.py holds them to, from a
torch.profiler trace on one card.

    python3 tools/profile_kernels.py [--iters 10] [--only stem_conv]

Boundaries: stem_conv_fwd and stem_conv_bwd at PixelLink++'s conv1_1 and
conv1_2 (batch 16, 300x300, bf16; the forward: the weights' packing, the
conv), deform_conv_fwd and deform_conv_bwd at the GSSD++
training site (batch 32, 38x38), at 75x75 and at 150x150 (batch 16),
flash_attn_bwd at N = M = 5625 and 22,500 (batch 16), the separable sampler's fwd, dx and dA/dB at the 38x38 site (batch
32; the range pass, the sample kernel; the range pass, dx; the range
pass, the buckets, the dA and dB passes) and all three at 75x75 (batch
16). Prints one JSON line
per boundary: the mean device ms a call of each kernel it launched (and
of the PyTorch ops around it), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(cs):
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh
    from gssd_torch.ops.kernels import deform_sample as ds
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import stem_conv as sc

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, cin, cout in cs.STEM_SITES:
        x = torch.rand(cs.PL_BATCH, cin, 300, 300, device="cuda", generator=g).bfloat16()
        w = torch.randn(cout, cin // 4, 3, 3, device="cuda", generator=g) / math.sqrt(9 * cin / 4)
        gout = torch.randn(cs.PL_BATCH, cout, 300, 300, device="cuda", generator=g).bfloat16()
        b = torch.randn(cout, device="cuda", generator=g)
        yield (f"stem_conv_fwd {name}",
               lambda x=x, w=w.bfloat16(), b=b: sc.stem_conv_fwd(x, w, b, 4))
        yield (f"stem_conv_bwd {name}",
               lambda x=x, w=w, gout=gout, dx=name != "conv1_1": sc.stem_conv_bwd(x, w, gout, 4, dx))
    x, py, px, m, wg, bias = cs.dcn_inputs(cs.TRAIN_BATCH)
    gout = torch.randn(cs.TRAIN_BATCH, py.shape[1], wg.shape[-1], device="cuda", generator=g)
    yield "deform_conv_fwd 38x38 B=32", lambda: dh.deform_conv_fwd(x, py, px, m, wg, bias)
    yield "deform_conv_bwd 38x38 B=32", lambda: dh.deform_conv_bwd(x, py, px, m, wg, gout)
    B, H, C, G, K, Cout = cs.PL_BATCH, 75, 512, 4, 9, 256
    off = torch.rand(2, B, H, H, G, K, device="cuda", generator=g) * 6 - 3
    py75, px75 = (t.reshape(B, H * H, G, K).contiguous() for t in dh.sample_coords(off[0], off[1]))
    args75 = (torch.randn(B, H, H, C, device="cuda", generator=g).bfloat16(), py75, px75,
              torch.rand(B, H * H, G, K, device="cuda", generator=g),
              (torch.randn(G, K, C // G, Cout, device="cuda", generator=g) * 0.05).bfloat16(),
              torch.randn(B, H * H, Cout, device="cuda", generator=g))
    bias75 = torch.randn(Cout, device="cuda", generator=g) * 0.1
    yield "deform_conv_fwd 75x75 B=16", lambda: dh.deform_conv_fwd(*args75[:5], bias75)
    yield "deform_conv_bwd 75x75 B=16", lambda: dh.deform_conv_bwd(*args75)
    args150 = cs.dcn_bwd_inputs(cs.PL_BATCH, cs.PL2_DCN_SITE)
    bias150 = torch.randn(args150[4].shape[-1], device="cuda", generator=g) * 0.1
    yield "deform_conv_fwd 150x150 B=16", lambda: dh.deform_conv_fwd(*args150[:5], bias150)
    yield "deform_conv_bwd 150x150 B=16", lambda: dh.deform_conv_bwd(*args150)
    for n, dk, dv in ((5625, 32, 128), (22500, 16, 64)):
        q, k, v, do = cs.attn_inputs(g, cs.PL_BATCH, n, dk, dv)
        o, lse = fa.flash_attention_fwd(q, k, v)
        yield (f"flash_attn_bwd N={n} B=16",
               lambda q=q, k=k, v=v, o=o, lse=lse, do=do: fa.flash_attention_bwd(q, k, v, o, lse,
                                                                                 do))
    a, b, xs, gs = cs.sample_inputs(cs.TRAIN_BATCH)
    yield "deform_sample_fwd 38x38 B=32", lambda: ds.abx_fwd(a, b, xs)
    yield "deform_sample_dx 38x38 B=32", lambda: ds.abx_dx(a, b, gs)
    yield "deform_sample_dab 38x38 B=32", lambda: ds.abx_dab(xs, gs, a, b)
    a75, b75, x75, g75 = cs.sample_inputs(cs.PL_BATCH, cs.PL_DCN_SITE)
    yield "deform_sample_fwd 75x75 B=16", lambda: ds.abx_fwd(a75, b75, x75)
    yield "deform_sample_dx 75x75 B=16", lambda: ds.abx_dx(a75, b75, g75)
    yield "deform_sample_dab 75x75 B=16", lambda: ds.abx_dab(x75, g75, a75, b75)


def device_ms(fn, iters):
    """{kernel or op name: mean device ms a call of ``fn``} from a
    torch.profiler trace of ``iters`` calls after 3 warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3 / iters
        if ms > 0:
            kernels[e.key[:120]] = round(ms, 4)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="", help="profile the boundaries whose label has this")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build(KERNELS.values())
    for label, fn in cases(cs):
        if args.only not in label:
            continue
        kernels = device_ms(fn, args.iters)
        total = sum(kernels.values())
        print(json.dumps({"boundary": label, "device_ms": round(total, 4),
                          "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
                          "power": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
