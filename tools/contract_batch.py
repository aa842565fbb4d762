#!/usr/bin/env python3
"""The attention kernels' rounding contract at the 512 model's sites at a
given batch, reported without failing, with a witness in f64.

Per site and draw, for the forward on contract inputs: the mean error
over mean value of the kernel, the plain version and a contract-keeping
exp2 softmax (``flash_contract.fwd_exp2``) against the contract computed
in f64 (``flash_contract.fwd_exact``: P = softmax(q k^T) in f64,
rounded once to bf16, P.V summed in f64), the kernel's the reading
``chip_smoke.py`` holds to ``flash_contract.mean_limit``; the kernel's
against the plain version (the reference of the check before). Beside
them, how many elements of P the plain
version's and the exp2 softmax's f32 roundings put on another bf16 value
than the f64 one, and in how many rows of O each of the three parts
from the f64 contract by more than ROW_TOL of mean |O| (a row that
carries such a flip). For the backward: the kernel's dq, dk, dv readings
and those of the planted two-part dS split, against their limits. One
JSON line per site and draw, then a summary: at each site how many
draws read above the limit, and the flips and rows summed.

    python3 tools/contract_batch.py [--batch 8] [--draws 5] [--replay]

The sites are read off the seeded 512 model as ``chip_smoke.py`` phase
21 reads them. ``--replay`` takes the draws phase 21 makes: one a site,
from its generator, the forward's inputs at the serving batch and the
backward's at the training batch, in its order; without it the inputs
are ``--draws`` fresh draws a site at ``--batch`` from another seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a row of O parts from the f64 contract by more than this share of
# mean |O| (mean over the row) where a bf16 rounding of P flipped in it;
# summation orders alone move a row by ~1e-7
ROW_TOL = 1e-5


def witness(q, k, v):
    """The forward's readings against the f64 contract (module doc)."""
    import torch

    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import flash_contract as fc

    s = torch.matmul(q.double(), k.double().transpose(1, 2))
    p = fc.round_bf16_exact(torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)))
    want, _ = fc.fwd_exact(q, k, v)
    den = want.abs().mean().item()
    sf = torch.matmul(q.float(), k.float().transpose(1, 2))
    lse_f = torch.logsumexp(sf, dim=-1, keepdim=True)
    p_plain = torch.exp(sf - lse_f).to(torch.bfloat16).double()
    p_exp2 = torch.exp2((sf - lse_f) * fc.LOG2E).to(torch.bfloat16).double()
    del s, sf
    outs = dict(kernel=fa.flash_attention_fwd(q, k, v)[0],
                plain=fa.flash_attention_fwd_plain(q, k, v)[0],
                exp2=fc.fwd_exp2(q, k, v)[0])
    res = {f"{name}_vs_f64": fc.mean_rel_err(o, want) for name, o in outs.items()}
    res.update({f"{name}_rows_off": int(((o.double() - want).abs().mean(-1) > ROW_TOL * den)
                                        .sum().item()) for name, o in outs.items()})
    res.update(plain_p_flips=int((p_plain != p).sum().item()),
               exp2_p_flips=int((p_exp2 != p).sum().item()), rows=q.shape[0] * q.shape[1])
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--draws", type=int, default=5)
    p.add_argument("--replay", action="store_true",
                   help="the draws chip_smoke.py phase 21 makes, in its order")
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
    sites = cs.attention_sites(cs.SIZE_512)
    if args.replay:
        # check_512's generator and order: per site the forward's draw at
        # the serving batch, then the backward's at the training batch
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
        draws = [(site, 0, cs.attn_inputs(g, cs.BATCH, *site[:3]),
                  cs.attn_inputs(g, cs.TRAIN_BATCH, *site[:3])) for site in sites]
    else:
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 21 + 1000)
        draws = ((site, d, cs.attn_inputs(g, args.batch, *site[:3]), None)
                 for site in sites for d in range(args.draws))
    summary = {}
    for (n, dk, dv, _), draw, fwd_in, bwd_in in draws:
        q, k, v, _ = fc.contract_inputs(*fwd_in)
        got, _ = fa.flash_attention_fwd(q, k, v)
        o, _ = fa.flash_attention_fwd_plain(q, k, v)
        fwd = dict(batch=q.shape[0], kernel_vs_plain=fc.mean_rel_err(got, o),
                   limit=fc.mean_limit("o", fc.fwd_exact(q, k, v)[0]), **witness(q, k, v))
        q, k, v, do = fc.contract_inputs(*(bwd_in or fwd_in))
        o, lse = fa.flash_attention_fwd_plain(q, k, v)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        bwd = dict(batch=q.shape[0],
                   kernel=fc.bwd_mean_errs(fa.flash_attention_bwd(q, k, v, o, lse, do), want, n),
                   two_part_split=fc.bwd_mean_errs(fc.bwd_split(q, k, v, o, lse, do, 2), want, n),
                   limits=fc.bwd_mean_limits(want, n))
        print(json.dumps({"replay": args.replay, "N": n, "dk": dk, "dv": dv, "draw": draw,
                          "fwd": fwd, "bwd": bwd, "power": smi}), flush=True)
        over = summary.setdefault(n, dict(
            draws=0, fwd_kernel_vs_plain=0, fwd_kernel_vs_f64=0, fwd_plain_vs_f64=0,
            plain_p_flips=0, kernel_rows_off=0, plain_rows_off=0, exp2_rows_off=0,
            bwd_kernel=0, split_missed=0))
        over["draws"] += 1
        for key in ("kernel_vs_plain", "kernel_vs_f64", "plain_vs_f64"):
            over[f"fwd_{key}"] += fwd[key] > fwd["limit"]
        for key in ("plain_p_flips", "kernel_rows_off", "plain_rows_off", "exp2_rows_off"):
            over[key] += fwd[key]
        over["bwd_kernel"] += any(e > lim for e, lim in zip(bwd["kernel"], bwd["limits"]))
        over["split_missed"] += not any(e > lim for e, lim in zip(bwd["two_part_split"][:2],
                                                                   bwd["limits"][:2]))
        del q, k, v, do, got, o, lse, want
        torch.cuda.empty_cache()
    print(json.dumps({"replay": args.replay, "batch": None if args.replay else args.batch,
                      "by_site": summary, "power": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
