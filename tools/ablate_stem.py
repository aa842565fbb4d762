#!/usr/bin/env python3
"""Where the stem conv forward's time goes: the same launch with one part
of the work taken out, or one setting changed, timed beside the
unmodified build on one card.

    python3 tools/ablate_stem.py [--iters 20]

Each variant is a copy of ``gssd_torch/csrc/stem_conv_fwd.cu`` and its
header ``stem_conv.cuh`` with the text edits below, built with the port's
nvcc flags into a temporary directory and called through the port's
wrapper at PixelLink++'s conv1_1 and conv1_2 (batch 16, 300x300, bf16).
The variants that take work out compute wrong numbers by design; only
their times mean anything:

- ``no_products``: each mma.sync becomes one f32 add of its operands'
  bits (the ldmatrix loads and the weights stay live);
- ``no_loads``: the staged rows are zeros (cp.async reads nothing),
  ``no_stores``: the output tile is not written out (its
  shared-memory stores stay), ``compute_only``: both;
- ``loads_only``: no products and no stores;
- ``no_transpose``: the staged rows are not transposed into the ring
  (the products read what the ring holds);
- ``four_warps``: blocks of 4 warps, not 8.

Prints one JSON line per site: ms per variant, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from compare_attention import _Baseline, bind  # noqa: E402

NO_PRODUCTS = [("mma_bf16(f[nt], a[kx], bw.x, bw.y);",
                "f[nt][0] += __uint_as_float((a[kx][0] ^ bw.x ^ bw.y) & 0x3f800000u);")]
NO_LOADS = [("cp_async8(dst + 4 * q, src + (ok ? gx0 : 0), ok);",
             "cp_async8(dst + 4 * q, src, false);")]
NO_STORES = [("for (int q = lane; q < CW / 4 && x0 + 4 * q < W; q += 32) {",
              "for (int q = lane; q < 0; q += 32) {")]
NO_TRANSPOSE = [("        transpose(s * R + 2);\n", "")]
# variant -> [(text in stem_conv.cuh, its replacement)]
VARIANTS = {
    "full": [],
    "no_products": NO_PRODUCTS,
    "no_loads": NO_LOADS,
    "no_stores": NO_STORES,
    "compute_only": NO_LOADS + NO_STORES,
    "loads_only": NO_PRODUCTS + NO_STORES,
    "no_transpose": NO_TRANSPOSE,
    "four_warps": [("constexpr int CONV_WARPS = 8;", "constexpr int CONV_WARPS = 4;")],
}
HEADERS = ("mma_sync.cuh",)


def build_variants(tmp, variants):
    """{variant: (the built library's C entry point, typed; the library)}."""
    roots = {}
    for name, edits in variants.items():
        root = os.path.join(tmp, name)
        csrc = os.path.join(root, "gssd_torch", "csrc")
        os.makedirs(csrc)
        for f in HEADERS + ("stem_conv_fwd.cu",):
            shutil.copy(os.path.join(ROOT, "gssd_torch", "csrc", f), csrc)
        with open(os.path.join(ROOT, "gssd_torch", "csrc", "stem_conv.cuh")) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"stem_conv.cuh no longer holds the text {name} edits: {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(csrc, "stem_conv.cuh"), "w") as f:
            f.write(text)
        roots[name] = root
    # one nvcc per variant, all at once
    from gssd_torch.ops.kernels.build import NVCC_FLAGS, _nvcc

    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(root, "lib.so"),
         os.path.join(root, "gssd_torch", "csrc", "stem_conv_fwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for name, root in roots.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(os.path.join(roots[name], "lib.so"))
        fns[name] = (bind(lib.stem_conv_fwd, 5, 8), lib)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import stem_conv as sc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    B, H, W, G = cs.PL_BATCH, 300, 300, 4
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(tmp, VARIANTS)
        for site, cin, cout in cs.STEM_SITES:
            x = torch.rand(B, cin, H, W, device="cuda", generator=g).bfloat16()
            w = (torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g)
                 * math.sqrt(2 / (9 * cin / G))).bfloat16()
            b = torch.randn(cout, device="cuda", generator=g) * 0.5
            row = {}
            for name, (fn, lib) in fns.items():
                saved = sc.FWD_KERNEL
                sc.FWD_KERNEL = _Baseline(fn, lib)
                try:
                    row[name] = cs.time_ms(lambda: sc.stem_conv_fwd(x, w, b, G), iters=args.iters)
                finally:
                    sc.FWD_KERNEL = saved
            print(json.dumps({"site": site, "ms": row, "power": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
