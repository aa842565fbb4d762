#!/usr/bin/env python3
"""The stem backward's dW against the same sum in f64, at the FSSD
trunk's stem sites, reported without failing.

Per site (300x300, 64 output channels, bf16 inputs drawn as
``chip_smoke.stem_site`` draws them): max |dW - dW64| / max |dW64| of the
kernel (``stem_conv_bwd``), of the plain version (``stem_conv_dw_plain``:
unfolded patches times g in f32 products of a few thousand pixels), and
of cuDNN's f32 weight gradient (``torch.nn.grad.conv2d_weight``, TF32
off), also under ``torch.backends.cudnn.deterministic``, beside
``chip_smoke.STEM_DW_TOL``. dW64 is the same function summed in f64
(``conv2d_weight`` on the bf16 operands cast to f64, a few images at a
time). One JSON line a site.

    python3 tools/stem_dw_witness.py [--batches 32,8]

Sites: conv1_1 (12 -> 64) and conv1_2 (64 -> 64), each at 4 groups
(groupfssd, fusedssd, PixelLink++) and ungrouped (fssd).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default="32,8")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this tool needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import build
    from gssd_torch.ops.kernels import stem_conv as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build([sc.BWD_KERNEL])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    for B in (int(b) for b in args.batches.split(",")):
        for G in (4, 1):
            for name, cin, cout in cs.STEM_SITES:
                x = torch.rand(B, cin, 300, 300, device="cuda", generator=g).bfloat16()
                w = torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g) * math.sqrt(
                    2 / (9 * cin / G))
                gout = torch.randn(B, cout, 300, 300, device="cuda", generator=g).bfloat16()
                _, kernel = sc.stem_conv_bwd(x, w, gout, G, need_dx=False)
                torch.cuda.synchronize()
                dw64 = sum(torch.nn.grad.conv2d_weight(
                    x[i:i + 4].double(), tuple(w.shape), gout[i:i + 4].double(), padding=1,
                    groups=G) for i in range(0, B, 4))
                top = dw64.abs().max()

                def rel(dw):
                    return ((dw.double() - dw64).abs().max() / top).item()

                def cudnn():
                    return torch.nn.grad.conv2d_weight(x.float(), tuple(w.shape), gout.float(),
                                                       padding=1, groups=G)

                res = dict(site=name, B=B, Cin=cin, Cout=cout, G=G, limit=cs.STEM_DW_TOL,
                           kernel=rel(kernel), plain=rel(sc.stem_conv_dw_plain(x, gout, G)),
                           cudnn_f32=rel(cudnn()), power=smi)
                torch.backends.cudnn.deterministic = True
                try:
                    res["cudnn_f32_deterministic"] = rel(cudnn())
                finally:
                    torch.backends.cudnn.deterministic = False
                print(json.dumps(res), flush=True)
                del x, gout, dw64
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
