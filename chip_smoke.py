#!/usr/bin/env python3
"""GPU smoke run of the port's serving path (gssd_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout

In order, failing (exit code 1) at the first phase that goes wrong:

1. prints the card (``nvidia-smi`` name and power limit) and the TF32
   settings it pins (both off);
2. builds the CUDA kernels from ``gssd_torch/csrc`` with nvcc for
   sm_90a, all sources at once;
3. holds each kernel against its plain PyTorch version on the card at
   every serving shape, batch 8: max |kernel - plain| must stay within
   KERNEL_TOL * max |plain|; times kernel, plain version and (attention
   only) ``F.scaled_dot_product_attention`` as a yardstick the port never
   calls, and computes each call's bound from the H100 data sheet;
4. serves synthetic 512x512 slices through ``gssd_torch.infer.main`` at
   ``--reference_recipe gssd++ --eval_batch 8 --device cuda
   --compute_dtype bfloat16`` with seeded random weights, counting kernel
   launches (12 attention + 1 DCN per forward) and the latency, then
   splits one batch's time into copy, forward and Detect/NMS;
5. runs one image through the port on the CPU in f32 (plain versions)
   and on the card in bf16 (kernels): loc and conf must agree within
   E2E_TOL * max |f32|.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 1234
BATCH = 8
# kernel vs its plain version, both on the card, as a share of max|plain|:
# the same bf16 roundings, in another summation order; a bf16 rounding of
# P or of a DCN sample can flip (2^-8 relative on that one term)
KERNEL_TOL = 1e-2
# bf16 serving forward (kernels) vs f32 forward (plain versions), as a
# share of max|f32|: bf16 activations through ~25 conv/attention layers
E2E_TOL = 5e-2
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# (N = M tokens, dk, dv, launches per forward) of the 12 attention sites
ATTN_SITES = [(1444, 64, 256, 2), (361, 128, 512, 2), (100, 64, 256, 2),
              (25, 32, 128, 2), (9, 32, 128, 2), (1, 32, 128, 2)]
DCN_SITE = dict(H=38, W=38, C=1024, G=4, K=9, Cout=512)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_flash():
    import torch
    import torch.nn.functional as F

    from gssd_torch.ops.kernels import flash_attn as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    sites = []
    for n, dk, dv, count in ATTN_SITES:
        q, k = (torch.randn(BATCH, n, dk, device="cuda", generator=g).bfloat16()
                for _ in range(2))
        v = torch.randn(BATCH, n, dv, device="cuda", generator=g).bfloat16()
        o, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
        err = (o - o_ref).abs().max().item()
        scale = o_ref.abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"flash_attn_fwd at N={n} dk={dk} dv={dv}: max err {err} > {KERNEL_TOL} * {scale}")
        check(lse_err <= 1e-4 * max(lse_ref.abs().max().item(), 1.0),
              f"flash_attn_fwd lse at N={n}: max err {lse_err}")
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        ops = 2 * BATCH * n * n * (dk + dv)
        nbytes = BATCH * (2 * (n * dk + n * dk + n * dv) + 4 * n * dv + 4 * n)
        b_ms, b_by = bound(ops, nbytes)
        site = dict(
            N=n, M=n, dk=dk, dv=dv, per_forward=count, max_abs_err=err,
            rel_err=err / scale, lse_err=lse_err,
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)),
            bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
        sites.append(site)
        print(f"flash_attn_fwd B={BATCH} N=M={n} dk={dk} dv={dv}: err {err:.3g} "
              f"(rel {err / scale:.3g}), lse err {lse_err:.3g}, kernel {site['ms']:.4f} ms, "
              f"plain {site['plain_ms']:.4f} ms, sdpa {site['library_ms']:.4f} ms, "
              f"bound {1e3 * b_ms:.2f} us ({b_by})", flush=True)
    return sites


def dcn_inputs():
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    s = DCN_SITE
    B, H, W, C, G, K, Cout = BATCH, s["H"], s["W"], s["C"], s["G"], s["K"], s["Cout"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(B, H, W, C, device="cuda", generator=g)
    # offsets over +-3 px: border taps sample outside the map; a third
    # are whole numbers, so samples also land on integer coordinates
    off = (torch.rand(2, B, H, W, G, K, device="cuda", generator=g) * 6 - 3)
    whole = torch.rand(off.shape, device="cuda", generator=g) < 1 / 3
    off = torch.where(whole, off.round(), off)
    m = torch.rand(B, H, W, G, K, device="cuda", generator=g)
    bw = 1 / math.sqrt(K * C)
    w = (torch.rand(K, C, Cout, device="cuda", generator=g) * 2 - 1) * bw
    b = torch.randn(Cout, device="cuda", generator=g) * 0.1
    py, px = dh.sample_coords(off[0], off[1])
    P = H * W
    return (x.bfloat16().contiguous(), py.reshape(B, P, G, K).contiguous(),
            px.reshape(B, P, G, K).contiguous(), m.reshape(B, P, G, K).contiguous(),
            w.reshape(K, G, C // G, Cout).permute(1, 0, 2, 3).bfloat16().contiguous(), b)


def check_dcn():
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    args = dcn_inputs()
    out = dh.deform_conv_fwd(*args)
    torch.cuda.synchronize()
    ref = dh.deform_conv_fwd_plain(*args)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(math.isfinite(err) and err <= KERNEL_TOL * scale,
          f"deform_conv_fwd: max err {err} > {KERNEL_TOL} * {scale}")
    s = DCN_SITE
    P = s["H"] * s["W"]
    ops = 2 * BATCH * P * s["K"] * s["C"] * s["Cout"]
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * 4
    b_ms, b_by = bound(ops, nbytes)
    site = dict(
        B=BATCH, **s, max_abs_err=err, rel_err=err / scale,
        ms=time_ms(lambda: dh.deform_conv_fwd(*args)),
        plain_ms=time_ms(lambda: dh.deform_conv_fwd_plain(*args), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
    print(f"deform_conv_fwd B={BATCH} {s['H']}x{s['W']} C={s['C']} G={s['G']} "
          f"Cout={s['Cout']}: err {err:.3g} (rel {err / scale:.3g}), kernel "
          f"{site['ms']:.4f} ms, plain {site['plain_ms']:.4f} ms, bound "
          f"{1e3 * b_ms:.2f} us ({b_by})", flush=True)
    return site


def seeded_model(compute_dtype, seed=SEED):
    """GSSD++ with random weights from ``seed`` that make every path
    contribute: He-scaled convs (activations keep their scale through
    the ReLUs), BN running stats away from (0, 1), attention sigma 0.5
    with the spectral-norm vectors at their top singular pair, and an
    offset predictor whose offsets are about a pixel."""
    import torch

    from gssd_torch.config import ModelConfig
    from gssd_torch.infer import REFERENCE_RECIPES
    from gssd_torch.models import build_model
    from gssd_torch.ops.deform_conv import DCN
    from gssd_torch.ops.layers import ConvBNRelu, SelfAttention, SNDense

    recipe = REFERENCE_RECIPES["gssd++"]
    keys = ("ssd_type", "use_self_attention", "use_self_attention_base",
            "groups_dcn", "num_dcn_layers", "dcn_cat_sab")
    cfg = ModelConfig(compute_dtype=compute_dtype, **{k: recipe[k] for k in keys})
    model, priors = build_model(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBNRelu):
                w = mod.conv.weight
                fan_in = w[0].numel()
                w.normal_(0, math.sqrt(2 / fan_in), generator=g)
                mod.bn.running_mean.normal_(0, 0.1, generator=g)
                mod.bn.running_var.uniform_(0.5, 1.5, generator=g)
                mod.bn.weight.uniform_(0.8, 1.2, generator=g)
                mod.bn.bias.normal_(0, 0.1, generator=g)
            elif isinstance(mod, SNDense):
                u, _, vh = torch.linalg.svd(mod.kernel.t(), full_matrices=False)
                mod.u.copy_(u[:, 0])
                mod.v.copy_(vh[0])
            elif isinstance(mod, SelfAttention):
                mod.sigma.fill_(0.5)
            elif isinstance(mod, DCN):
                w = mod.conv_offset_mask.weight
                w.normal_(0, 1 / math.sqrt(w[0].numel()), generator=g)
                mod.conv_offset_mask.bias.normal_(0, 0.1, generator=g)
    return model, priors


def serve(tmp):
    import torch

    from gssd_torch import infer
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.ops.kernels import KERNELS

    model, _ = seeded_model("bfloat16")
    weights = os.path.join(tmp, "gssd_pp.pt")
    torch.save(model.state_dict(), weights)
    data = os.path.join(tmp, "ml_ready")
    t0 = time.perf_counter()
    make_synthetic_dataset(data, num_subjects=8, slices_per_subject=4, image_size=512,
                           seed=SEED)
    print(f"synthetic data: {time.perf_counter() - t0:.1f} s", flush=True)
    det_path = os.path.join(tmp, "detections.json")
    n_images = 32
    n_batches = n_images // BATCH
    for k in KERNELS.values():
        k.launches = 0
    res = infer.main([
        "--reference_recipe", "gssd++", "--datapath", data, "--split", "all",
        "--num_test_subjects", "2", "--eval_batch", str(BATCH),
        "--device", "cuda", "--compute_dtype", "bfloat16",
        "--weights", weights, "--det_output", det_path])
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"main-path launches over {n_batches} forwards: {launches}", flush=True)
    check(launches == {"flash_attn_fwd": 12 * n_batches, "deform_conv_fwd": n_batches},
          f"expected 12 flash and 1 DCN launch per forward, got {launches}")
    with open(det_path) as f:
        dets = json.load(f)
    check(len(dets) == n_images and all(set(d) == {"id", "scores", "boxes"} for d in dets),
          "detections JSON malformed")
    lat = res["latency_ms"]
    check(len(lat) == n_batches - 1 and all(math.isfinite(t) and t > 0 for t in lat),
          f"bad latency record {lat}")
    print(f"serving latency (excl. first batch, batch {BATCH}): "
          f"{sum(lat) / len(lat):.3f} ms/image over {len(lat)} batches", flush=True)
    return launches, lat, data


def breakdown():
    """Where one batch's serving time goes: the pageable host-to-device
    copy (host clock), the forward and Detect/NMS (CUDA events)."""
    import numpy as np
    import torch

    from gssd_torch.config import DetectConfig
    from gssd_torch.ops.nms import detect

    model, priors = seeded_model("bfloat16")
    model = model.to("cuda").eval()
    priors = torch.tensor(priors, device="cuda")
    x = np.random.default_rng(SEED).uniform(0, 1, (BATCH, 300, 300, 12)).astype(np.float32)
    with torch.inference_mode():
        copies = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xd = torch.from_numpy(x).to("cuda")
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t0) * 1e3)
        out = model(xd)
        conf = torch.softmax(out["conf"], dim=-1)
        parts = dict(
            h2d_ms=sorted(copies)[len(copies) // 2],
            forward_ms=time_ms(lambda: model(xd), iters=10),
            detect_ms=time_ms(lambda: detect(out["loc"], conf, priors, DetectConfig()),
                              iters=5))
    print(f"batch-{BATCH} breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          flush=True)
    return parts


def parity(data):
    import numpy as np
    import torch

    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset

    ids = DataSplitter(data, 1, 2).data_test[:1]
    raw = LesionDataset(data, ids).pull_image(0)
    x, _, _ = BaseTransform(300)(raw)
    x = np.transpose(x, (1, 2, 0, 3)).reshape(1, 300, 300, 12)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    outs = {}
    for dtype, device in (("float32", "cpu"), ("bfloat16", "cuda")):
        model, _ = seeded_model(dtype)
        model = model.to(device).eval()
        with torch.inference_mode():
            out = model(xt.to(device))
        outs[dtype] = {k: out[k].float().cpu() for k in ("loc", "conf")}
        outs[dtype]["offsets"] = out["offsets"][0].float().cpu()
    offs = outs["float32"]["offsets"].abs().max().item()
    check(offs > 0.5, f"DCN offsets too small to leave the grid: {offs}")
    errs = {}
    for name in ("loc", "conf"):
        ref, got = outs["float32"][name], outs["bfloat16"][name]
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite bf16 output")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        errs[name] = err / scale
        print(f"parity {name}: max |bf16 card - f32 cpu| = {err:.4g}, "
              f"max |f32| = {scale:.4g}, ratio {err / scale:.4g} (limit {E2E_TOL})", flush=True)
        check(err <= E2E_TOL * scale, f"{name}: bf16 card vs f32 cpu {err} > {E2E_TOL} * {scale}")
    return errs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gssd_torch.ops.kernels import KERNELS, build
    except ImportError as e:
        print(f"FAIL: gssd_torch not found next to chip_smoke.py ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device {kind}")
    # a reference pins TF32 (cuDNN convs default to it): off, so f32 is f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    try:
        t0 = time.perf_counter()
        built = build(KERNELS.values())
        print(f"built {built} in {time.perf_counter() - t0:.1f} s", flush=True)
        attn_sites = check_flash()
        dcn_site = check_dcn()
        with tempfile.TemporaryDirectory() as tmp:
            launches, lat, data = serve(tmp)
            parts = breakdown()
            errs = parity(data)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    def per_forward(key):
        return sum(s[key] * s["per_forward"] for s in attn_sites)

    flash_bound, flash_by = bound(per_forward("ops"), per_forward("bytes"))
    kernels = [
        dict(name="flash_attn_fwd", route="cuda", source="gssd_torch/csrc/flash_attn_fwd.cu",
             replaces="gssd_tpu/ops/pallas/flash_attn.py:64",
             launches=launches["flash_attn_fwd"],
             max_abs_err=max(s["max_abs_err"] for s in attn_sites),
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
             bound_ms=flash_bound, bound_by=flash_by,
             library_ms=per_forward("library_ms"),
             note=f"times summed over the 12 serving sites of one batch-{BATCH} forward",
             sites=attn_sites),
        dict(name="deform_conv_fwd", route="cuda", source="gssd_torch/csrc/deform_conv_fwd.cu",
             replaces="gssd_tpu/ops/pallas/deform_hat.py:314",
             launches=launches["deform_conv_fwd"], max_abs_err=dcn_site["max_abs_err"],
             ms=dcn_site["ms"], plain_ms=dcn_site["plain_ms"], bound_ms=dcn_site["bound_ms"],
             bound_by=dcn_site["bound_by"], library_ms=None,
             note=f"one batch-{BATCH} call at the 38x38 serving site", sites=[dcn_site]),
    ]
    print(json.dumps({"serving": {"batch": BATCH, "latency_ms_per_image": lat,
                                  "breakdown_ms_per_batch": parts,
                                  "parity_rel_err": errs, "power": smi,
                                  "seconds": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
