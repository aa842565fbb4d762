#!/usr/bin/env python3
"""The attention backward's rounding contract at PixelLink++'s largest
sites, reported without failing, with a witness in f64.

Per site, on contract inputs (``flash_contract.contract_inputs``), the
mean error over mean value of dq, dk and dv of the kernel, of the plain
version (f32) and of the planted two-part and bf16 dS splits, against
the contract computed in f64 (``flash_contract.bwd_exact``: P, dS and
the three products in f64, each gradient rounded once to bf16), and the
kernel's against the plain version (the reading ``chip_smoke.py`` held
before), beside the limits (``flash_contract.bwd_mean_limits``) of
each reference. The plain references run one image at a time. One JSON
line a site and draw.

    python3 tools/flash_bwd_witness.py [--sites 22500,5625] [--draws 1]

Draw 0 of the 22,500-key site (batch 16, dk 16, dv 64) is the one
``chip_smoke.py`` phase 23 checks; draw 0 of the 5625-key site (batch
16, dk 32, dv 128) is phase 15's; further draws come from another seed.
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
    p.add_argument("--sites", default="22500,5625")
    p.add_argument("--draws", type=int, default=1)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this tool needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import flash_contract as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build(KERNELS.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def phase_draw(n):
        """The backward's inputs at the site as its phase draws them."""
        if n == cs.PL2_ATTN_SITE[0]:
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
            sites = [cs.PL2_ATTN_SITE]
        else:
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
            sites = cs.PL_ATTN_SITES
        for site in sites:
            cs.attn_inputs(g, cs.PL_BATCH, *site[:3])  # the forward's draw
            bwd = cs.attn_inputs(g, cs.PL_BATCH, *site[:3])
            if site[0] == n:
                return bwd
        raise ValueError(f"no PixelLink++ site with {n} keys")

    shapes = {s[0]: s for s in [cs.PL2_ATTN_SITE] + cs.PL_ATTN_SITES}
    fresh = torch.Generator(device="cuda").manual_seed(cs.SEED + 1013)
    for key in args.sites.split(","):
        n, dk, dv, _ = shapes[int(key)]
        for draw in range(args.draws):
            inputs = phase_draw(n) if draw == 0 else cs.attn_inputs(fresh, cs.PL_BATCH, n, dk, dv)
            q, k, v, do = fc.contract_inputs(*inputs)
            del inputs
            o, lse = cs.per_image(fa.flash_attention_fwd_plain)(q, k, v)
            exact = fc.bwd_exact(q, k, v, o, lse, do)
            plain = cs.per_image(fa.flash_attention_bwd_plain)(q, k, v, o, lse, do)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do)
            res = dict(N=n, dk=dk, dv=dv, B=q.shape[0], draw=draw,
                       kernel_vs_f64=fc.bwd_mean_errs(got, exact, n),
                       plain_vs_f64=fc.bwd_mean_errs(plain, exact, n),
                       kernel_vs_plain=fc.bwd_mean_errs(got, plain, n),
                       limits_f64=fc.bwd_mean_limits(exact, n),
                       limits_plain=fc.bwd_mean_limits(plain, n))
            del got
            for name, parts in (("two_part_split", 2), ("bf16_ds", 1)):
                planted = cs.per_image(lambda *t, parts=parts: fc.bwd_split(*t, parts))(
                    q, k, v, o, lse, do)
                res[f"{name}_vs_f64"] = fc.bwd_mean_errs(planted, exact, n)
                res[f"{name}_vs_plain"] = fc.bwd_mean_errs(planted, plain, n)
                del planted
            print(json.dumps({**res, "power": smi}), flush=True)
            del q, k, v, do, o, lse, exact, plain
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
