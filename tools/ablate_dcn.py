#!/usr/bin/env python3
"""Where the hat DCN kernels' time goes: the same launches with one part
of the work taken out, timed beside the unmodified build on one card.

    python3 tools/ablate_dcn.py [--iters 5]

Each variant is a copy of ``gssd_torch/csrc/deform_conv_{fwd,bwd}.cu``
with one text edit (below), built with the port's nvcc flags into a
temporary directory and called through the port's wrappers, at the
38x38 training site (batch 32, 1024 -> 512) and at 75x75 (batch 16,
512 -> 256), with compare_dcn's inputs. The variants compute wrong
numbers by design; only their times mean anything:

- forward ``no_gathers``: the producers blend zeros (no corner of x is
  loaded), so the time left is the weight stream, the products and the
  blend arithmetic; ``no_blend``: the samples are bits of the loaded
  corners, no f32 arithmetic;
- backward ``no_corner_terms``: the dU kernel writes its tile and skips
  the epilogue's rows (no gather, no dS, no sample, no scratch store);
  ``no_gathers``: the epilogue loads no corner of x; ``no_stores``: it
  stores neither dU nor the samples; ``no_ds_reduction``: no shuffles
  sum dS across the warp; ``no_blend``: no sample arithmetic;
  ``no_dw``: the dW partials are not computed (their sum still runs).

Prints one JSON line per site and direction: ms per variant, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from compare_attention import _Baseline, bind, compile_sources  # noqa: E402

# (source, variant) -> [(text in the source, its replacement)]
VARIANTS = {
    ("deform_conv_fwd", "full"): [],
    ("deform_conv_fwd", "no_gathers"): [
        ("x + (size_t)corner[q] * C + g * Cg + c, Cg - c);",
         "x + (size_t)corner[q] * C + g * Cg + c, 0);")],
    ("deform_conv_fwd", "no_blend"): [
        ("blend<4>(o, pt.v[i], pt.w[i]);",
         "for (int j = 0; j < 4; ++j) o[j] = pt.v[i][j][j] ^ __float_as_uint(pt.w[i][j]);")],
    ("deform_conv_bwd", "full"): [],
    ("deform_conv_bwd", "no_ds_reduction"): [
        ("ds[q] += __shfl_xor_sync(0xffffffffu, ds[q], off);", "ds[q] += (float)off;")],
    ("deform_conv_bwd", "no_blend"): [
        ("blend<WPL>(o, v[jj], w[jj]);",
         "for (int i = 0; i < WPL; ++i) o[i] = v[jj][i % 4][i] ^ __float_as_uint(w[jj][i % 4]);")],
    ("deform_conv_bwd", "no_corner_terms"): [
        ("for (int j0 = 0; j0 < WORKER_ROWS; j0 += ROWS) {", "for (int j0 = 0; j0 < 0; j0 += ROWS) {")],
    ("deform_conv_bwd", "no_gathers"): [
        ("valid && in ? left : 0);", "0);")],
    ("deform_conv_bwd", "no_stores"): [
        ("store_words<WPL, VEC>(du + wi * Cg + cc, u[jj], left);", ""),
        # the samples stay live, so that their blend is not optimised away
        ("store_words<WPL, VEC>(samp + wi * cg8 + cc, o, left);",
         "if (o[0] == 0x7fc00001u) du[0] = bf16();")],
    ("deform_conv_bwd", "no_dw"): [
        ("    if (Cout8 <= 64) err = launch_dw<64>(", "    if (false) err = launch_dw<64>("),
        ("    else if (Cout8 <= 128) err = launch_dw<128>(", "    else if (false) err = launch_dw<128>("),
        ("    else err = launch_dw<256>(", "    else if (false) err = launch_dw<256>(")],
}
HEADERS = ("deform_gather.cuh", "flash_sm90.cuh")


def build_variants(tmp):
    """{(source, variant): the built library's C entry point, typed}."""
    fns = {}
    for (src, name), edits in VARIANTS.items():
        root = os.path.join(tmp, f"{src}_{name}")
        csrc = os.path.join(root, "gssd_torch", "csrc")
        os.makedirs(csrc)
        for f in HEADERS:
            shutil.copy(os.path.join(ROOT, "gssd_torch", "csrc", f), csrc)
        with open(os.path.join(ROOT, "gssd_torch", "csrc", src + ".cu")) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{src}.cu no longer holds the text {name} edits: {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(csrc, src + ".cu"), "w") as f:
            f.write(text)
        lib = compile_sources(root, [src], root)[src]
        fns[(src, name)] = (bind(lib.deform_conv_bwd, 15, 10) if src == "deform_conv_bwd"
                            else bind(lib.deform_conv_fwd, 7, 9))
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import compare_dcn as cd
    from gssd_torch.ops.kernels import deform_hat as dh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(tmp)
        for label, d, site_args in cd.sites(cs):
            if label.endswith(f"B={cs.BATCH}"):
                continue
            src = "deform_conv_fwd" if d == "fwd" else "deform_conv_bwd"
            attr = "KERNEL" if d == "fwd" else "BWD_KERNEL"
            wrapper = dh.deform_conv_fwd if d == "fwd" else dh.deform_conv_bwd
            row = {}
            for (s, name), fn in fns.items():
                if s != src:
                    continue
                saved = getattr(dh, attr)
                setattr(dh, attr, _Baseline(fn))
                try:
                    row[name] = cs.time_ms(lambda: wrapper(*site_args), iters=args.iters)
                finally:
                    setattr(dh, attr, saved)
            print(json.dumps({"site": label, "direction": d, "ms": row, "power": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
