#!/usr/bin/env python3
"""Time the port's attention kernels against those of another checkout
at every attention site, on one card, in turns (baseline, current,
current, baseline), and print one JSON line per site and a summary.

    python3 tools/compare_attention.py --baseline <root of another checkout>

The baseline's ``gssd_torch/csrc/flash_attn_{fwd,bwd}.cu`` are built with
the same nvcc flags into a temporary directory and called through the
same C interface and the same Python wrappers (``flash_attention_fwd``,
``flash_attention_bwd``), so both sides pay the same host work. A
baseline backward that still adds dQ with atomics (its source uses
``red_add_v2``; its C function takes a zeroed f32 dQ and no scratch) is
called as its own wrapper called it: dQ zeroed, the kernel, dQ rounded
to bf16. Sites: the 12 GSSD++ sites (forward at batch 8, forward
and backward at batch 32) and PixelLink++'s 8 (forward and backward at
batch 16), from ``chip_smoke.py``. Each baseline output must agree with
the current kernel's within chip_smoke's KERNEL_TOL of max.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_sources(root, names, out_dir):
    """nvcc each ``gssd_torch/csrc/<name>.cu`` of the checkout at ``root``
    with the port's flags into ``out_dir``, all at once: {name: CDLL}."""
    from gssd_torch.ops.kernels.build import NVCC_FLAGS, _nvcc

    procs = []
    for name in names:
        src = os.path.join(root, "gssd_torch", "csrc", name + ".cu")
        so = os.path.join(out_dir, name + ".so")
        procs.append((name, so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", so, src],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the baseline's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def bind(fn, n_ptrs, n_ints):
    """``fn`` typed as the port's C entry points are: pointers, ints, the
    stream; returns int."""
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def in_turns(time_ms, baseline, current, iters):
    """Times of ``baseline`` and ``current`` in turns (baseline, current,
    current, baseline): the row of a site."""
    t = [time_ms(f, iters=iters) for f in (baseline, current, current, baseline)]
    row = dict(baseline_ms=(t[0] + t[3]) / 2, current_ms=(t[1] + t[2]) / 2, turns_ms=t)
    row["speedup"] = row["baseline_ms"] / row["current_ms"]
    return row


def build_baseline(root, out_dir):
    fns = {}
    with open(os.path.join(root, "gssd_torch", "csrc", "flash_attn_bwd.cu")) as f:
        fns["atomic_dq"] = "red_add_v2" in f.read()
    libs = compile_sources(root, ("flash_attn_fwd", "flash_attn_bwd"), out_dir)
    fns["flash_attn_fwd"] = bind(libs["flash_attn_fwd"].flash_attn_fwd, 5, 5)
    fns["flash_attn_bwd"] = (bind(libs["flash_attn_bwd"].flash_attn_bwd, 9, 5) if fns["atomic_dq"]
                             else bind(libs["flash_attn_bwd"].flash_attn_bwd, 10, 6))
    return fns


class _Baseline:
    """Stands in for a ``CudaKernel``: the baseline library's function
    (and, given its library, the host functions a wrapper queries)."""

    def __init__(self, fn, lib=None):
        self.fn, self.lib = fn, lib
        self.launches = 0

    def query(self, name, *ints):
        q = getattr(self.lib, f"{self.fn.__name__}_{name}")
        q.argtypes = [ctypes.c_int] * len(ints)
        q.restype = ctypes.c_long
        return q(*ints)

    def launch(self, stream, *args):
        code = self.fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"baseline kernel: CUDA error {code}")
        self.launches += 1


def atomic_dq_bwd(fn):
    """The backward wrapper of a baseline that adds dQ with atomics."""
    import torch

    def bwd(q, k, v, o, lse, do):
        B, N, dk = q.shape
        M, dv = k.shape[1], v.shape[2]
        delta = (do.float() * o).sum(dim=-1)
        dq = torch.zeros(B, N, dk, dtype=torch.float32, device=q.device)
        dk_ = torch.empty(B, M, dk, dtype=torch.bfloat16, device=q.device)
        dv_ = torch.empty(B, M, dv, dtype=torch.bfloat16, device=q.device)
        _Baseline(fn).launch(torch.cuda.current_stream(q.device).cuda_stream,
                             *(t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk_, dv_)),
                             B, N, M, dk, dv)
        return dq.to(torch.bfloat16), dk_, dv_

    return bwd


@contextlib.contextmanager
def baseline_kernels(fa, fns):
    saved = fa.KERNEL, fa.BWD_KERNEL, fa.flash_attention_bwd
    fa.KERNEL, fa.BWD_KERNEL = _Baseline(fns["flash_attn_fwd"]), _Baseline(fns["flash_attn_bwd"])
    if fns["atomic_dq"]:
        fa.flash_attention_bwd = atomic_dq_bwd(fns["flash_attn_bwd"])
    try:
        yield
    finally:
        fa.KERNEL, fa.BWD_KERNEL, fa.flash_attention_bwd = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="root of the checkout to compare with")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import flash_attn as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = build_baseline(args.baseline, tmp)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        rows = []
        cases = ([(cs.BATCH, n, dk, dv, c, "fwd") for n, dk, dv, c in cs.ATTN_SITES] +
                 [(cs.TRAIN_BATCH, n, dk, dv, c, d) for n, dk, dv, c in cs.ATTN_SITES
                  for d in ("fwd", "bwd")] +
                 [(cs.PL_BATCH, n, dk, dv, c, d) for n, dk, dv, c in cs.PL_ATTN_SITES
                  for d in ("fwd", "bwd")])
        for B, n, dk, dv, count, d in cases:
            q, k, v, do = cs.attn_inputs(g, B, n, dk, dv)
            o, lse = fa.flash_attention_fwd(q, k, v)
            if d == "fwd":
                def current():
                    return fa.flash_attention_fwd(q, k, v)
            else:
                def current():
                    return fa.flash_attention_bwd(q, k, v, o, lse, do)

            def baseline():
                with baseline_kernels(fa, base):
                    return current()

            pairs = list(zip(baseline(), current()))
            torch.cuda.synchronize()
            top = max(b.float().abs().max().item() for _, b in pairs)
            for a, b in pairs:
                err = (a.float() - b.float()).abs().max().item()
                scale = top if n == 1 else b.float().abs().max().item()
                if not err <= cs.KERNEL_TOL * scale:
                    print(f"FAIL: baseline and current disagree at B={B} N={n} {d}: {err}",
                          file=sys.stderr)
                    return 1
            # launch-bound sites take more iterations: their host time is noisy
            iters = args.iters if n > 100 else 10 * args.iters
            row = dict(direction=d, B=B, N=n, M=n, dk=dk, dv=dv, count=count,
                       **in_turns(cs.time_ms, baseline, current, iters))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    print(json.dumps({"power": smi, "sites": len(rows),
                      "slowest_vs_baseline": min(r["speedup"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
