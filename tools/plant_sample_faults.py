#!/usr/bin/env python3
"""Edited builds of the separable sampler's forward and dA/dB kernels on
one card: planted faults that the checks must catch, and, with
``--ablate``, variants with one part of the work taken out, timed.

    python3 tools/plant_sample_faults.py              # the faults
    python3 tools/plant_sample_faults.py --ablate [--iters 20]

Each entry of EDITS is a copy of ``gssd_torch/csrc/deform_sample_{fwd,dab}.cu``
with one text edit, built with the port's nvcc flags into a temporary
directory and called through the port's wrappers. The faults:

- ``fwd_bf16_t``: T = sum_qy A x rounded to bf16 before its product with
  B (the TPU kernel keeps T in f32);
- ``fwd_fmaf_blend``: acc = fmaf(b, T, acc), one rounding where the
  plain version (and the TPU kernel's t * b, then sum) rounds twice;
- ``dab_rz_operand``: bf16(S * g) rounded toward zero, not to nearest;
- ``dab_drop_long_rows``: the buckets put a pixel whose hat row has more
  than two cells in its range among the all-zero rows (its dA or dB row
  comes out zero).

Their inputs: chip_smoke.py phase 9's (``sample_inputs``: the forward at
the 38x38 site at batch 8 and 32 and at 75x75, batch 16; dA/dB at batch
32 and 75x75), whose rows are hats, and two dense-row cases of
``tests/test_torch_cuda.py::test_deform_sample_kernels_match_plain``.
Prints one JSON line per (kernel build, inputs): max |kernel - plain| /
max |plain| and whether the output is the plain version's bits, and
whether phase 9 (SAMPLE_TOL, and the forward's bit equality) or the
card test (1e-5 of max) fails. Exits 1 if the unmodified kernels fail a
check or a fault passes the check meant for it.

The variants (``--ablate``; wrong numbers by design, only their times
mean anything), timed beside the unmodified kernels at phase 9's 38x38
batch-32 and 75x75 inputs:

- forward ``fwd_no_stores``: the output is not written (kept live by a
  test no input passes); ``fwd_no_gathers``: the corners of x are not
  loaded (the products use the A and B values);
- dA/dB ``dab_no_products``: no warp forms A fragments or runs mma.sync;
  ``dab_no_x_tiles``: the x tiles are zero-filled, not loaded;
  ``dab_no_rows``: the g rows are zero-filled and S set to 1, not loaded;
  ``dab_no_stores``: dA and dB are not written.

Prints one JSON line per site and kernel: ms per build, with the card's
name and power limit.
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

# name -> (source, [(text in the source, its replacement)], the check
# meant to catch it, or "time" for a variant of --ablate)
EDITS = {
    "fwd_bf16_t": ("deform_sample_fwd", [
        ("    if (two) add_row(t, a1, v1);",
         "    if (two) add_row(t, a1, v1);\n"
         "    for (int j = 0; j < 8; ++j) t[j] = __bfloat162float(__float2bfloat16(t[j]));"),
        ("            const float b = __bfloat162float(brow[qx]);",
         "            for (int j = 0; j < 8; ++j) t[j] = __bfloat162float(__float2bfloat16(t[j]));\n"
         "            const float b = __bfloat162float(brow[qx]);")], "phase9"),
    "fwd_fmaf_blend": ("deform_sample_fwd", [
        ("acc[j] = __fadd_rn(acc[j], __fmul_rn(b, t[j]));", "acc[j] = fmaf(b, t[j], acc[j]);")],
        "phase9"),
    "dab_rz_operand": ("deform_sample_dab", [
        ("__nv_bfloat162 v = __floats2bfloat162_rn(s * lo, s * hi);",
         "__nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(s * lo),\n"
         "                                          __float2bfloat16_rz(s * hi));")], "phase9"),
    "dab_drop_long_rows": ("deform_sample_dab", [
        ("return side == 0 ? (r.z <= r.w ? r.z : W) : (r.x <= r.y ? r.x : H);",
         "return side == 0 ? (r.z <= r.w && r.w - r.z < 2 ? r.z : W)\n"
         "                 : (r.x <= r.y && r.y - r.x < 2 ? r.x : H);")], "card_test"),
    "fwd_no_stores": ("deform_sample_fwd", [
        ("    float4* o = reinterpret_cast<float4*>(out + row * Cg + c);",
         "    if (acc[0] != 1234.5f) return;\n"
         "    float4* o = reinterpret_cast<float4*>(out + row * Cg + c);")], "time"),
    "fwd_no_gathers": ("deform_sample_fwd", [
        ("const uint4 v00 = *reinterpret_cast<const uint4*>(c00);",
         "const uint4 v00 = make_uint4(__float_as_uint(a0), 0u, 0u, 0u);"),
        ("const uint4 v10 = y2 ? *reinterpret_cast<const uint4*>(c00 + (size_t)W * Cg) : zero;",
         "const uint4 v10 = zero;"),
        ("const uint4 v01 = x2 ? *reinterpret_cast<const uint4*>(c00 + Cg) : zero;",
         "const uint4 v01 = zero;"),
        ("y2 && x2 ? *reinterpret_cast<const uint4*>(c00 + (size_t)(W + 1) * Cg) : zero;",
         "zero;"),
        ("        const float a0 = __bfloat162float(arow[r.x]);\n", ""),
        ("        const bool y2 = r.y > r.x, x2 = r.w > r.z;",
         "        const bool y2 = r.y > r.x, x2 = r.w > r.z;\n"
         "        const float a0 = __bfloat162float(arow[r.x]);")], "time"),
    "dab_no_products": ("deform_sample_dab", [
        ("const bool rows = warp * 16 < cnt;", "const bool rows = false;")], "time"),
    "dab_no_x_tiles": ("deform_sample_dab", [
        ("                __pipeline_memcpy_async(d, xn + cell * Cg + c0 + c, 16);",
         "                *reinterpret_cast<uint4*>(d) = make_uint4((unsigned)cell, 0u, 0u, 0u);")],
        "time"),
    "dab_no_rows": ("deform_sample_dab", [
        ("                    __pipeline_memcpy_async(d, gn + (size_t)p * Cg + c0 + c, 16);",
         "                    *reinterpret_cast<uint4*>(d) = make_uint4((unsigned)p, 0u, 0u, 0u);"),
        ("Ss[buf][tid] = p >= 0 ? __bfloat162float(Sn[(size_t)p * R + r]) : 0.0f;",
         "Ss[buf][tid] = 1.0f;")], "time"),
    "dab_no_stores": ("deform_sample_dab", [
        ("                if (q < QN) orow[q] = acc[f][2 * h + e];",
         "                if (q < QN && acc[f][2 * h + e] == 1234.5f) orow[q] = 0.0f;")], "time"),
}
FAULTS = {name: e for name, e in EDITS.items() if e[2] != "time"}
HEADERS = ("hat_ranges.cuh", "mma_sync.cuh")


def build_edited(tmp, name, src, edits):
    """``gssd_torch/csrc/<src>.cu`` with ``edits`` applied, built into
    ``tmp/<name>``: a stand-in for the port's ``CudaKernel``."""
    root = os.path.join(tmp, name)
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
    fn = getattr(lib, src)
    return _Baseline(bind(fn, 5, 5) if src == "deform_sample_fwd" else bind(fn, 8, 5), lib)


def with_build(ds, kernel, stand_in, call):
    """``call()`` with the wrapper of ``kernel`` ("fwd" or "dab")
    launching ``stand_in`` (None: the port's own build)."""
    attr = "FWD_KERNEL" if kernel == "fwd" else "DAB_KERNEL"
    saved = getattr(ds, attr)
    if stand_in is not None:
        setattr(ds, attr, stand_in)
    try:
        return call()
    finally:
        setattr(ds, attr, saved)


def cases(cs):
    """(label, a, b, x, g, dense) of the inputs: phase 9's hat rows and
    two of the card test's dense-row cases."""
    import torch

    for label, batch, site in ((f"38x38 B={cs.BATCH}", cs.BATCH, cs.DCN_SITE),
                               (f"38x38 B={cs.TRAIN_BATCH}", cs.TRAIN_BATCH, cs.DCN_SITE),
                               (f"75x75 B={cs.PL_BATCH}", cs.PL_BATCH, cs.PL_DCN_SITE)):
        yield (label, *cs.sample_inputs(batch, site), False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N, G, P, H, W, Cg in ((2, 3, 200, 17, 13, 72), (1, 1, 1444, 38, 38, 256)):
        a, b = (torch.rand(N, G, P, n, device="cuda", generator=gen) for n in (H, W))
        a, b = (torch.where(t < 0.3, 0.0, t).bfloat16() for t in (a, b))
        x = torch.randn(N, G, H, W, Cg, device="cuda", generator=gen).bfloat16()
        g = torch.randn(N, G, P, Cg, device="cuda", generator=gen).bfloat16()
        yield f"dense rows N={N} G={G} P={P} H={H} W={W} Cg={Cg}", a, b, x, g, True


def readings(cs, ds, kernel, a, b, x, g, dense):
    """(rel err, bit-equal to plain, fails its check) of one kernel build
    at one input."""
    import torch

    if kernel == "fwd":
        got, want = (ds.abx_fwd(a, b, x),), (ds.abx_fwd_plain(a, b, x),)
    else:
        got, want = ds.abx_dab(x, g, a, b), ds.abx_dab_plain(x, g, a, b)
    torch.cuda.synchronize()
    rel = max(((u - v).abs().max() / v.abs().max()).item() for u, v in zip(got, want))
    same = all(torch.equal(u, v) for u, v in zip(got, want))
    tol = 1e-5 if dense else cs.SAMPLE_TOL[kernel]
    fails = not rel <= tol or (kernel == "fwd" and not dense and not same)
    return rel, same, fails


def faults(cs, ds, smi, fns):
    """Each fault against the check meant for it; returns what went wrong."""
    import torch

    caught = {name: False for name in FAULTS}
    bad = []
    for label, a, b, x, g, dense in cases(cs):
        check = "card_test" if dense else "phase9"
        # phase 9 holds dA/dB at batch 32 and 75x75, not at batch 8
        for kernel in ("fwd",) if label.endswith(f"B={cs.BATCH}") else ("fwd", "dab"):
            builds = [("none", None)] + [(n, fns[n]) for n, (src, _, _) in FAULTS.items()
                                         if src == f"deform_sample_{kernel}"]
            row = {}
            for name, fn in builds:
                rel, same, fails = with_build(
                    ds, kernel, fn, lambda: readings(cs, ds, kernel, a, b, x, g, dense))
                row[name] = dict(rel_err=rel, bit_equal=same, fails=fails)
                if name == "none" and fails:
                    bad.append(f"the unmodified {kernel} fails at {label}")
                if name != "none" and fails and FAULTS[name][2] == check:
                    caught[name] = True
            print(json.dumps({"inputs": label, "kernel": kernel, "check": check,
                              "builds": row, "power": smi}), flush=True)
        del a, b, x, g
        torch.cuda.empty_cache()
    print(json.dumps({"caught": caught, "power": smi}), flush=True)
    return bad + [f"{name} passes {FAULTS[name][2]}" for name, c in caught.items() if not c]


def ablate(cs, ds, smi, fns, iters):
    """Times of the unmodified kernels and of each variant."""
    import torch

    for label, batch, site in ((f"38x38 B={cs.TRAIN_BATCH}", cs.TRAIN_BATCH, cs.DCN_SITE),
                               (f"75x75 B={cs.PL_BATCH}", cs.PL_BATCH, cs.PL_DCN_SITE)):
        a, b, x, g = cs.sample_inputs(batch, site)
        for kernel, call in (("fwd", lambda: ds.abx_fwd(a, b, x)),
                             ("dab", lambda: ds.abx_dab(x, g, a, b))):
            row = {name: with_build(ds, kernel, fn, lambda: cs.time_ms(call, iters=iters))
                   for name, fn in [("full", None)] + list(fns.items())
                   if fn is None or EDITS[name][0] == f"deform_sample_{kernel}"}
            print(json.dumps({"site": label, "kernel": f"deform_sample_{kernel}", "ms": row,
                              "power": smi}), flush=True)
        del a, b, x, g
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true",
                    help="time the variants with part of the work taken out")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gssd_torch.ops.kernels import KERNELS, build
    from gssd_torch.ops.kernels import deform_sample as ds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build([KERNELS["deform_sample_fwd"], KERNELS["deform_sample_dab"]])
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: build_edited(tmp, name, src, edits)
               for name, (src, edits, purpose) in EDITS.items()
               if (purpose == "time") == args.ablate}
        if args.ablate:
            ablate(cs, ds, smi, fns, args.iters)
            return 0
        bad = faults(cs, ds, smi, fns)
    if bad:
        print(f"FAIL: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
