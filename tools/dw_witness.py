#!/usr/bin/env python3
"""The hat DCN backward's dW against its rounding contract computed in
f64, at the sites ``chip_smoke.py`` checks, reported without failing.

Per site, on the draws ``chip_smoke.check_dcn_bwd`` makes there: the mean
error over mean value (``dcn_contract.mean_rel_err``) of the kernel's dW
and of the plain version's (f32 sums) against ``dcn_contract.dw_exact``
(samples and g rounded to bf16 as the contract says, products summed in
f64, rounded once to bf16), and of the kernel's against the plain
version's (the reading ``chip_smoke.py`` holds to
``dcn_contract.MEAN_TOL["dwg"]``), beside that limit. The kernel is read
with dW's splits as the wrapper picks them and with each cap of
``--caps`` on the 64-pixel chunks one split sums in one chain of
``wgmma``s (``deform_hat.DW_MAX_CHUNKS``), each with its splits and its
time. One JSON line a site.

    python3 tools/dw_witness.py [--caps 256,64,16] [--sites 38,64,150]

Sites: 38 = GSSD++ at 300 (38x38, C 1024 -> 512, batch 32), 64 = GSSD++
at 512 (64x64, the same channels, batch 32), 150 = PixelLink++ 2s
(150x150, C 256 -> 128, batch 16); all 4 groups, 3x3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--caps", default="256,64,16",
                   help="chunks a split at most (comma-separated; 'none' for no cap)")
    p.add_argument("--sites", default="38,64,150")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this tool needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import dcn_contract as dc
    from gssd_torch.ops.kernels import deform_hat as dh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build(KERNELS.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sites = {"38": (cs.TRAIN_BATCH, cs.DCN_SITE), "64": (cs.TRAIN_BATCH, cs.DCN_SITE_512),
             "150": (cs.PL_BATCH, cs.PL2_DCN_SITE)}
    caps = [None if c == "none" else int(c) for c in args.caps.split(",")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    saved = dh.DW_MAX_CHUNKS
    for key in args.sites.split(","):
        batch, site = sites[key]
        args_ = cs.dcn_bwd_inputs(batch, site)
        x, py, px, m, wg, g = args_
        B, P, G, K = py.shape
        Cg, Cout = x.shape[-1] // G, wg.shape[-1]
        exact = dc.dw_exact(*args_)
        plain = dh.deform_conv_bwd_plain(*args_)[4]
        res = dict(site=key, B=B, H=site["H"], W=site["W"], C=site["C"], G=G, Cout=Cout,
                   bp=B * P, limit=dc.mean_limit("dwg", plain),
                   plain_vs_f64=dc.mean_rel_err(plain, exact), kernel={}, power=smi)
        for cap in [saved] + [c for c in caps if c != saved]:
            dh.DW_MAX_CHUNKS = cap
            try:
                got = dh.deform_conv_bwd(*args_)[4]
                torch.cuda.synchronize()
                res["kernel"][str(cap)] = dict(
                    splits=dh.dw_splits(B * P, G * K, Cg, Cout, sms, cap),
                    vs_f64=dc.mean_rel_err(got, exact), vs_plain=dc.mean_rel_err(got, plain),
                    ms=cs.time_ms(lambda: dh.deform_conv_bwd(*args_), iters=3, warmup=1))
            finally:
                dh.DW_MAX_CHUNKS = saved
            del got
        print(json.dumps(res), flush=True)
        del args_, x, py, px, m, wg, g, exact, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
