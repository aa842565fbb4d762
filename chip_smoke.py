#!/usr/bin/env python3
"""GPU smoke run of the port (gssd_torch) on one card: the serving path,
the training step, the three DCN routes, the trainer's evaluation,
checkpoints and resume, PixelLink++ (4s and 2s) and the FSSD family with
the stem kernels, the UNet liver-segmentation trainer, the C++ host
library, ``--visualize``, the VOC SSD300 trainer and the offline
preprocessing (a raw drop built into ml_ready and trained on).

    python3 chip_smoke.py        # from the root of a checkout

In order, failing (exit code 1) at the first phase that goes wrong:

1. prints the card (``nvidia-smi`` name and power limit) and the TF32
   settings it pins (both off);
2. builds the CUDA kernels from ``gssd_torch/csrc`` with nvcc for
   sm_90a, all sources at once;
3. holds each forward kernel against its plain PyTorch version on the
   card at every serving shape, batch 8, and each backward kernel at
   every training shape, batch 32: max |kernel - plain| must stay within
   KERNEL_TOL * max |plain| for every output; the attention kernels also
   keep their rounding contract (``gssd_torch/ops/kernels/flash_contract.py``):
   mean |kernel - reference| / mean |reference| per output within its
   limit on contract inputs (against the contract computed in f64:
   ``fwd_exact``, ``bwd_exact``), while
   a planted online-softmax forward, bf16-dS backward and two-part dS
   split, in plain PyTorch on the card, must read above it; so do the hat DCN kernels
   (``gssd_torch/ops/kernels/dcn_contract.py``: forward at batch 8 and
   32, backward at batch 32; planted f32 corner weights, unrounded
   samples, g and dU, which must read above it on every output they
   touch); times kernel, plain version and (attention only)
   ``F.scaled_dot_product_attention`` forward or backward as a yardstick
   the port never calls, and computes each call's bound from the H100
   data sheet (attention: the largest of its bytes, its tensor products
   and one exp per logit at the MUFU rate);
4. serves synthetic 512x512 slices through ``gssd_torch.infer.main`` at
   ``--reference_recipe gssd++ --eval_batch 8 --device cuda
   --compute_dtype bfloat16`` with seeded random weights, counting kernel
   launches (12 attention + 1 DCN per forward) and the latency, then
   splits one batch's time into copy, forward and Detect/NMS;
5. runs one image through the port on the CPU in f32 (plain versions)
   and on the card in bf16 (kernels): loc and conf must agree within
   E2E_TOL * max |f32|;
6. trains through ``gssd_torch.train.main`` at ``--reference_recipe
   gssd++ --synthetic True --batch_size 32 --max_iter 8 --device cuda
   --compute_dtype bfloat16``, counting launches (12 + 12 attention and
   1 + 1 DCN, forward + backward, per step); every loss must be finite;
   prints the median ms/step after the first step and slices/s;
7. takes 5 SGD steps on one repeated batch of 32 from seeded weights
   (the loss must fall) and splits a step into forward, loss, backward
   and optimizer by CUDA events;
8. takes one step's loss and gradients at batch 2 in f32 on the CPU
   (plain versions) and in bf16 on the card (kernels): the losses must
   agree within TRAIN_LOSS_TOL; the gradients of f32 on the card and on
   the CPU agree in direction (cosine >= TRAIN_COS_MIN per parameter),
   and so do bf16 through the kernels and through the plain versions
   (>= KERNEL_COS_MIN); see ``train_parity``;
9. holds the three deform_sample kernels against their plain versions at
   the 38x38 DCN site (fwd at batch 8 and 32, dx and dA/dB at batch 32)
   and at PixelLink++'s 75x75 site (all three at batch 16), within
   SAMPLE_TOL, and times them beside one ``torch.einsum`` each; the
   kernels add only the terms inside each hat row's non-zero range, so
   the forward must give the plain version's bits at these hat rows and
   dx the dense order's sum bit for bit (one p at a time, ascending);
   their bounds count the work this data needs (the dense contraction's
   beside them);
10. serves through ``gssd_torch.infer.main --dcn_impl pallas``: 9
   ``deform_sample_fwd`` and 12 ``flash_attn_fwd`` launches per forward,
   no ``deform_conv_fwd``;
11. trains through ``gssd_torch.train.main`` at batch 32 with
   ``--dcn_impl pallas`` (9 + 9 + 9 deform_sample and 12 + 12 attention
   launches per step) and ``--dcn_impl fused`` (9 ``deform_sample_dx``
   and no other DCN launch per step), finite losses, ms/step printed;
12. trains ``hat`` with ``--val_every``/``--speedrun`` set so that the
   AP/IoBB evaluation and a checkpoint happen; restores the checkpoint
   into a fresh model and optimizer and finds it equal, bit for bit, to
   the trainer's state; resumes from it (the first resumed step runs at
   the stored step's LR, past a ``--stepvalues`` boundary); evaluates it
   with ``--test True --checkpoint``: the AP/IoBB keys, values in [0, 1];
13. one DCN layer (1024 -> 512, 4 groups, 38x38, batch 8) on the
   ``pallas`` and ``fused`` routes: gradients in bf16 through the kernels
   against bf16 through the plain versions, cosine >= DCN_COS_MIN each;
14. holds the stem kernels (``stem_conv_fwd``, ``stem_conv_bwd``) against
   their plain versions at PixelLink++'s conv1_1 and conv1_2 (batch 16,
   300x300, bf16): y and dx within STEM_ULP_MAX ulp with at most
   STEM_DIFF_SHARE of the elements differing, dW within STEM_DW_TOL; a
   planted double rounding must fail; times them beside cuDNN; then the
   f32 forward (f32 x and weights, three bf16 parts on the tensor cores)
   at both sites' channels, batch 2: mean |y - y64| / mean |y64| against
   the function in f64 within ``stem_conv.STEM_F32_MEAN_TOL`` and y within
   STEM_DW_TOL of max |plain|, while a planted two-part split, in plain
   PyTorch on the card, must read at least STEM_F32_PLANTED_MIN times the
   limit;
15. holds the attention kernels at PixelLink++'s four site shapes (N =
   5625, 1444, 361; batch 16), with the checks of phase 3, and the hat
   DCN at 75x75 (512 -> 256 channels) against their plain versions and
   within the DCN contract, timed;
16. with ``USE_WIDE_CONV_KERNEL`` set in-process, trains PixelLink++
   through ``gssd_torch.train_pixellink.main`` at ``--reference_recipe
   pixellink++ --synthetic True --batch_size 16 --device cuda
   --compute_dtype bfloat16`` (2 + 2 stem, 8 + 8 (remat) + 8 attention
   and 1 + 1 DCN launches per step, finite losses, ms/step), runs its
   evaluation and checkpoint, then ``--test True --checkpoint`` (the
   AP/IoBB keys in [0, 1]; 2 stem, 8 attention, 1 DCN launches per
   batch); then as many steps with the switch off, which launch no stem
   kernel (both medians printed);
17. PixelLink++ bf16 on the card (kernels) against f32 on the CPU (plain
   versions): logits within E2E_TOL, a train-mode loss at batch 2 within
   TRAIN_LOSS_TOL;
18. repeatability: each of the nine kernel boundaries twice on the same
   inputs at its training shape must give the same bits; then, in a
   child process with CUBLAS_WORKSPACE_CONFIG=:4096:8 and
   ``torch.use_deterministic_algorithms(True)``, one ``hat`` GSSD++
   training step at batch DET_BATCH twice from the same state and batch:
   every parameter's gradient the same bits (the same without the mode is
   reported, and the step timed both ways);
19. trains PixelLink++ as phase 16 does (switch on) with ``--dcn_impl
   pallas`` for 3 steps: the separable sampler at the 75x75 DCN site,
   exactly 2 + 2 stem, 8 + 8 + 8 attention and 9 + 9 + 9 deform_sample
   launches per step and no hat DCN launch, finite losses, the median
   ms/step printed;
20. the training input paths: the ``hat`` trainer at batch 32 for
   INPUT_ITERS steps on the host path (one thread), ``--num_workers 4``,
   ``--aug_method device`` and ``--aug_method device_cached``, each with a
   ``--profile_dir`` trace of steps INPUT_TRACE: exactly 12 + 12
   attention and 1 + 1 hat DCN launches a step, finite losses; prints per
   path the median input wait, step ms, wall ms an iteration, slices/s on
   the wall clock and the device idle share of the traced steps (one
   minus the union of the kernel intervals over their span), with the
   traced step's kernels, their time by origin (the port's, NVIDIA's
   libraries, PyTorch's), launch calls and casts; exact
   resume with ``--aug_method device_cached`` and ``--num_workers 2``
   (RESUME_ITERS steps with a checkpoint at RESUME_AT, then ``--resume``:
   the resumed batches the same bits as the uninterrupted run's, the
   losses side by side); the cache's device warp at batch 32 against the
   same warp on the CPU in f64 within WARP_TOL, a TF32 warp above it; and
   the prefetch's host wait with f32 and with bf16 images on the wire;
21. GSSD++ at 512 (``--ssd_dim 512``: v2_512 anchors, 24,564 priors): the
   attention sites read off one forward of the seeded model, each held
   as in phases 3 and 15, the forward at the serving batch 8 and the
   backward at the training batch 32 (KERNEL_TOL, the rounding contract
   and its planted faults, timed beside the plain version and SDPA,
   bounded), the hat DCN pair at its 64x64 site (1024
   -> 512, 4 groups) at batch 8 and 32 within the DCN contract with its
   planted faults; serving through ``gssd_torch.infer.main --ssd_dim
   512`` (exactly 14 attention and 1 DCN launches a forward, ms/image,
   the copy/forward/Detect split); bf16 on the card against f32 on the
   CPU within E2E_TOL; training through ``gssd_torch.train.main --ssd_dim
   512`` with ``device_cached`` and on the host path (14 + 14 attention
   and 1 + 1 DCN launches a step, finite losses, median ms/step, slices/s,
   peak memory, at the recipe's batch 32);
22. k-fold cross-validation: ``gssd_torch.train.main --cross_validation
   5`` at batch 32 (``device_cached``, FOLD_ITERS iterations, an
   evaluation at the last): exactly 5 x (12 + 12) attention and 5 x (1 +
   1) DCN launches an iteration plus the evaluation's forwards, five
   ``_CV<f>`` checkpoints, the logged means the means of the five folds,
   ms an iteration and slices/s (batch x 5); ``--test --checkpoint``
   over the five folds (each in [0, 1], their mean); ``gssd_torch.infer
   --fold 3`` serving ``_CV3``; ``--resume`` of the 5-fold run (every
   fold's state, momenta and next batch the same bits as the
   uninterrupted run's); ``gssd_torch.train_pixellink --cross_validation
   2``, two steps: exact launches, finite losses, two checkpoints;
23. PixelLink++ 2s (``--version 2s``): its attention sites read off one
   forward (the 4s ones of phase 15 and N = M = 22,500, dk 16, dv 64 at
   conv2_2), the new one held forward and backward at batch 16 as phase
   15 holds the others (the plain and f64 references one image at a
   time: ``per_image``), the hat DCN pair at its 150x150 site (256 ->
   128, 4 groups, batch 16) and the sampler's three kernels there within
   their contracts; with the wide-conv switch on, training through
   ``gssd_torch.train_pixellink.main --version 2s`` at batch 16 on
   ``hat`` (PL_ITERS steps, exactly 2 + 2 stem, 20 + 10 attention and
   1 + 1 hat DCN launches a step, the peak memory), its evaluation and
   ``--test --checkpoint`` (2 stem, 10 attention, 1 DCN launches a
   batch; the host decode's share); bf16 card vs f32 CPU logits and
   loss; in a child process, one ``hat`` step at batch 2 twice from the
   same state with the same gradient bits; PL_PALLAS_ITERS steps on
   ``pallas`` (9 + 9 + 9 sampler launches a step, no hat DCN, the peak
   memory);
24. GSSD++ at 512 on the sampler's routes: the three deform_sample
   kernels at the 64x64 site (forward at batch 8 and 32, dx and dA/dB at
   32) as phase 9 holds them; serving with ``--dcn_impl pallas`` at
   batch 8 (14 attention and 9 deform_sample_fwd launches a forward);
   ROUTE_ITERS training steps at batch 32 (``device_cached``) on
   ``pallas`` (14 + 14 attention, 9 + 9 + 9 sampler launches a step) and
   ``fused`` (14 + 14 attention, 9 deform_sample_dx), ms/step and the
   peak memory;
25. the FSSD family (``--ssd_type fssd``, ``groupfssd``, ``fusedssd``)
   with the wide-conv switch on: the stem kernels at the trunk's four
   sites (conv1_1 and conv1_2, 4 groups and ungrouped, 300x300) as phase
   14 holds them, the forward at batch 8 and 32, the backward at 32 with
   dW also against the same sum in f64 (within STEM_DW_TOL), timed beside
   the plain versions and cuDNN; per model, serving through
   ``gssd_torch.infer`` at batch 8 (exactly 2 stem launches a forward and
   no other), bf16 card vs f32 CPU (loc, conf within E2E_TOL; a
   train-mode loss at batch 2 within TRAIN_LOSS_TOL), ROUTE_ITERS
   training steps at batch 32 on ``device_cached`` (2 + 2 stem launches a
   step, ms/step, peak memory) with an evaluation and checkpoint at the
   last, and ``--test --checkpoint`` (AP/IoBB in [0, 1]); groupfssd also
   trains with the switch off (no stem launch), both medians printed;
26. UNet (``gssd_torch.train_unet``, 512x512, batch 8, f32,
   feature_scale 1): UNET_ITERS steps with validation and checkpoints,
   ms/step, slices/s, peak memory; the last checkpoint restored bit for
   bit and ``--resume`` from it; the forward on the card against f32 on
   the CPU at batch 1 (f32 within UNET_F32_TOL, bf16 within E2E_TOL);
27. the host library (``gssd_torch/native``): built with g++ from the
   checkout's sources (compiler version and build time printed); phase
   12's predictions swept with the C++ and the numpy loop at every AP and
   IoBB threshold, the same TP/FP, both timed. (Phases 16 and 23 decode
   their ``--test`` logits with the C++ and the numpy path in turns: the
   same boxes and scores, bit for bit, both times and the decode's share
   of ``--test`` printed, the C++ calls counted.);
28. ``--test --checkpoint --visualize``: GSSD++ 300 ``hat`` on phase 12's
   checkpoint and PixelLink++ 4s on phase 16's: every file
   ``dump_eval_visuals`` names for each test slice, the offsets [38, 38,
   4, 9, 2] (PixelLink++ [75, 75, 4, 9, 2]) and the first attention maps
   [1444, 1444] ([5625, 5625]) with rows summing to 1 within bf16, the
   dumped detections equal to the evaluation path's on the same slice,
   and exactly one forward's launches a slice (12 ``flash_attn_fwd`` + 1
   ``deform_conv_fwd``; PixelLink++ 8 + 1 + 2 stem) plus one a batch of
   the evaluation;
29. ``python -m gssd_torch.train_voc`` on a synthetic VOCdevkit tree
   (VOC_IMAGES JPEGs with XML, ``gssd_torch.data.voc.write_voc_tree``): the vanilla SSD300 at batch 32,
   bf16, VOC_ITERS steps with a VOC mAP evaluation and a checkpoint
   (ms/step, peak memory), a finite mAP in [0, 1], the checkpoint
   restored bit for bit, ``--test --checkpoint`` with the same mAP, bf16
   card vs f32 CPU within E2E_TOL, and no launch of the port's kernels
   (the model has no attention, DCN or wide-conv stem).
30. a raw drop to a trained checkpoint: a synthetic SNUH raw drop
   (``write_raw_drop``: DROP_SUBJECTS subjects of A, D, P and Pre
   512x512 int16 volumes, uint8 raw masks with z-deltas, one subject with
   two lesions) built into ml_ready by
   ``gssd_torch.preprocessing.snuh.build_snuh_dataset`` (the sample and
   metadata counts, every ``_ct.npy`` [4, 3, 512, 512] f32 in [0, 1],
   boxes inside the slice with class 0, the pivot phase's token; seconds
   a subject, bytes written), then ``gssd_torch.train.main`` on it at
   ``--reference_recipe gssd++ --batch_size 32 --dcn_impl hat
   --compute_dtype bfloat16`` for DROP_ITERS steps with an evaluation and
   a checkpoint (finite losses, AP/IoBB in [0, 1], exactly phase 12's
   launches a step and one forward's an evaluation batch, ms/step beside
   phase 12's) and ``--test --checkpoint`` (one forward's launches a
   test batch);
31. data parallelism (``gssd_torch.parallel``, one process a rank): two
   gloo ranks sharing the card (the launcher's device list names
   ``cuda:0`` twice) against one rank at global batch DP_BATCH, GSSD++
   300 f32 on ``hat`` as the trainer initialises it, DP_ITERS steps, each
   from the one-rank run's state before it: the loss within DP_TOL
   relative, the parameters and the BatchNorm running statistics within
   DP_TOL (relative L2 over the model), the momenta within DP_GRAD_TOL
   (see DP_TOL; the one-rank run on reversed rows printed beside), the
   ranks bit-equal, and two planted faults (BatchNorm statistics, the
   loss normaliser, each over a rank's rows alone) failing those checks;
   the same two ranks through
   ``gssd_torch.train.main`` at ``--batch_size 32 --aug_method
   device_cached``, bf16: exactly 12 + 12 attention and 1 + 1 hat DCN
   launches a step on each rank, finite losses, the ranks' states
   bit-equal, ms/step (two ranks sharing one card: not a speed-up); its
   last iteration evaluates split over the two ranks
   (``parallel.mesh.plan_infer_step``): 12 attention and 1 hat DCN
   launches more on each rank for each of its evaluation forwards, and
   the valid and test AP/IoBB of a one-rank evaluation of the checkpoint
   it wrote (``--test --checkpoint``); ``plan_infer_step`` called through
   the launcher on that checkpoint (``dp_infer``): two ranks at
   eval_batch 16 give every full chunk of one rank at 8 bit for bit (the
   same rows, shapes and kernels; the tail's max difference printed),
   with the seconds of one evaluation on one rank and on two;
   PixelLink++ 4s ``--test`` on the two ranks (the stem kernels on the
   split path: 2 stem, 8 attention, 1 hat DCN launches a forward on each)
   equal to its one-rank ``--test``; with two cards or more the first
   check and the split evaluation on NCCL, one rank a card, and the
   trainer at batch 32 a card (ms/step, slices/s); with one card it says
   that the NCCL run was not made. ``python3 chip_smoke.py
   --data-parallel`` builds the kernels and runs this phase alone.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 1234
BATCH = 8          # serving
TRAIN_BATCH = 32   # the published recipe's batch
TRAIN_ITERS = 8
# kernel vs its plain version, both on the card, as a share of max|plain|:
# the same bf16 roundings, in another summation order; a bf16 rounding of
# P or of a DCN sample can flip (2^-8 relative on that one term)
KERNEL_TOL = 1e-2
# the deform_sample kernels round nothing their plain versions do not:
# fwd and dA/dB differ only in the f32 summation order (tensor cores,
# measured <= 1e-7 and <= 8.3e-7 of max at the 38x38 site), dx sums the
# same exact f32 terms in one fixed order (measured bit-equal). A bf16
# rounding of an intermediate (E = B * g, T = A . x) or a TF32 product
# reads ~1e-4 to ~2e-3 and must fail (PERF.md, PR 3)
SAMPLE_TOL = {"fwd": 1e-5, "dx": 1e-6, "dab": 1e-5}
# bf16 serving forward (kernels) vs f32 forward (plain versions), as a
# share of max|f32|: bf16 activations through ~25 conv/attention layers
E2E_TOL = 5e-2
# one train step, bf16 on the card (kernels) vs f32 on the CPU (plain
# versions), same weights and batch: relative loss difference, and the
# least cosine between a parameter's two gradients
TRAIN_LOSS_TOL = 5e-2
TRAIN_COS_MIN = 0.98
# the same step in bf16 through the kernels and through their plain
# versions (same roundings, other summation orders): least cosine
# between a parameter's two gradients
KERNEL_COS_MIN = 0.9
# one DCN layer's gradients, bf16 through the kernels vs bf16 through the
# plain versions (the same roundings, other summation orders)
DCN_COS_MIN = 0.999
# steps of each extra training run (the DCN routes, the evaluation run)
ROUTE_ITERS = 3
AP_KEYS = {"ap30", "ap50", "ap70", "iobb30", "iobb50", "iobb70"}
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, f32 rate
# outside the tensor cores, HBM3 rate
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# MUFU ex2 results a second: 16 a clock per SM (the CUDA C++ Programming
# Guide's arithmetic-instruction throughput table, compute capability
# 9.0: base-2 exponential) x 132 SMs x 1.83 GHz, the clock at which the
# 989 TFLOP/s above is 4096 bf16 operations a clock per SM
PEAK_EX2 = 16 * 132 * 1.83e9
# (N = M tokens, dk, dv, launches per forward) of the 12 attention sites
ATTN_SITES = [(1444, 64, 256, 2), (361, 128, 512, 2), (100, 64, 256, 2),
              (25, 32, 128, 2), (9, 32, 128, 2), (1, 32, 128, 2)]
DCN_SITE = dict(H=38, W=38, C=1024, G=4, K=9, Cout=512)
# PixelLink++ (4s)'s DCN site: slice_and_cat(conv3_3, attn_g) at 75x75
PL_DCN_SITE = dict(H=75, W=75, C=512, G=4, K=9, Cout=256)
# PixelLink++ 2s's: slice_and_cat(conv2_2, attn_g) at 150x150
PL2_DCN_SITE = dict(H=150, W=150, C=256, G=4, K=9, Cout=128)


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


def bound(ops, nbytes, f32_ops=0):
    """(least ms the card could take, what bounds it): bf16 tensor-core
    ``ops`` plus CUDA-core ``f32_ops``, against the bytes moved."""
    t_ops = ops / PEAK_BF16_OPS + f32_ops / PEAK_F32_OPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_work(B, n, m, dk, dv, backward):
    """What the attention function needs, whatever the design: (tensor
    operations, exps). Forward: QK^T and PV; backward: QK^T, dP = dO V^T
    and dV, plus dQ and dK, whose f32-exact products count as three bf16
    passes each; one exp per logit."""
    logits = B * n * m
    if backward:
        return 2 * logits * (dk + 2 * dv) + 3 * 2 * logits * 2 * dk, logits
    return 2 * logits * (dk + dv), logits


def attn_bound(ops, exps, nbytes):
    """(least ms, "bytes" or "operations", the term that bounds): the
    largest of the bytes at the HBM rate, the tensor products at the bf16
    rate and the exps at the MUFU rate."""
    terms = {"bytes": nbytes / PEAK_BYTES, "tensor": ops / PEAK_BF16_OPS, "exp": exps / PEAK_EX2}
    worst = max(terms, key=terms.get)
    return 1e3 * terms[worst], ("bytes" if worst == "bytes" else "operations"), worst


def attn_inputs(g, B, n, dk, dv):
    """Seeded bf16 q, k [B, n, dk] and v, dO [B, n, dv] on the card."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    return randn(B, n, dk), randn(B, n, dk), randn(B, n, dv), randn(B, n, dv)


# a plain or f64 reference whose f32 logits over the whole batch would
# pass this many bytes runs one image at a time (``per_image``): at the
# 22,500-key sites of PixelLink++ 2s, batch 16, they are 32.4 GB
PER_IMAGE_BYTES = 8 * 2**30


def per_image(fn):
    """``fn`` applied one batch element at a time, its outputs (a tensor
    or a tuple of tensors) joined along the batch."""
    import torch

    def run(*args):
        outs = [fn(*(a[b:b + 1] for a in args)) for b in range(args[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    return run


def whole(fn):
    return fn


def contract_fwd(q, k, v, each=whole):
    """The forward kernel's rounding contract at one site: mean error
    over mean value on contract inputs (logits exact in any order)
    against the contract computed exactly (``flash_contract.fwd_exact``:
    f64 softmax, P rounded once to bf16), and the same reading of a
    planted online-softmax forward in plain PyTorch, which must exceed
    the limit. (Against the f32 plain version an f32 softmax's flip of
    one large bf16 element of P, on either side, reads above the limit
    at few keys; ``tools/contract_batch.py`` shows both readings.)"""
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import flash_contract as fc

    qc, kc, vc = fc.contract_inputs(q, k, v)
    got, _ = fa.flash_attention_fwd(qc, kc, vc)
    want, _ = fc.fwd_exact(qc, kc, vc)
    err, limit = fc.mean_rel_err(got, want), fc.mean_limit("o", want)
    planted = fc.mean_rel_err(each(fc.fwd_online_softmax)(qc, kc, vc)[0], want)
    return dict(mean_rel_err=err, mean_limit=limit, planted_online_softmax=planted)


def contract_bwd(q, k, v, do, each=whole):
    """The backward kernel's contract at one site (dq, dk, dv): mean error
    over mean value on contract inputs against the contract computed
    exactly (``flash_contract.bwd_exact``: f64, each gradient rounded
    once to bf16), and the readings of a planted bf16-dS and a planted
    two-part-split backward against it, which must exceed the limits;
    the plain version's readings beside them, reported only (its f32 dQ
    sums over the keys drift from the exact ones as the keys grow: 1.9e-6
    of the mean at 22,500 keys, where the kernel reads 4.2e-7;
    ``tools/flash_bwd_witness.py``). The plain references through
    ``each`` (``whole`` or ``per_image``)."""
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import flash_contract as fc

    qc, kc, vc, doc = fc.contract_inputs(q, k, v, do)
    m = kc.shape[1]
    o, lse = each(fa.flash_attention_fwd_plain)(qc, kc, vc)
    want = fc.bwd_exact(qc, kc, vc, o, lse, doc)
    got = fa.flash_attention_bwd(qc, kc, vc, o, lse, doc)
    errs, limits = fc.bwd_mean_errs(got, want, m), fc.bwd_mean_limits(want, m)
    del got
    plain = fc.bwd_mean_errs(each(fa.flash_attention_bwd_plain)(qc, kc, vc, o, lse, doc),
                             want, m)
    planted = {name: fc.bwd_mean_errs(
                   each(lambda *t, parts=parts: fc.bwd_split(*t, parts))(qc, kc, vc, o, lse, doc),
                   want, m)
               for name, parts in (("bf16_ds", 1), ("two_part_split", 2))}
    return dict(mean_rel_errs=errs, mean_limits=limits, plain_mean_rel_errs=plain,
                planted=planted)


# a planted two-part dS split moves dq and dk by ~2e-6 of their mean: it
# must read above the limit where the reductions are long enough for it
# to stand out of the bf16 outputs' rounding (N >= 100; at N = 9 and 25
# it reads 0.5-2e-6, PERF.md)
SPLIT_FAULT_MIN_N = 100


def check_contract(site, label, m):
    """Every output within its mean limit; every planted fault above it
    (for dq or dk, which consume dS) wherever the softmax is not
    constant (m > 1), the two-part split from SPLIT_FAULT_MIN_N keys."""
    if "mean_limit" in site:
        check(site["mean_rel_err"] <= site["mean_limit"],
              f"{label}: mean err {site['mean_rel_err']:.3g} > {site['mean_limit']:.3g}")
        check(m == 1 or site["planted_online_softmax"] > site["mean_limit"],
              f"{label}: a planted online softmax reads {site['planted_online_softmax']:.3g}, "
              f"within the limit {site['mean_limit']:.3g}")
    else:
        for name, err, lim in zip(("dq", "dk", "dv"), site["mean_rel_errs"], site["mean_limits"]):
            check(err <= lim, f"{label} {name}: mean err {err:.3g} > {lim:.3g}")
        for fault, errs in site["planted"].items():
            if m == 1 or (fault == "two_part_split" and m < SPLIT_FAULT_MIN_N):
                continue
            check(any(e > lim for e, lim in zip(errs[:2], site["mean_limits"][:2])),
                  f"{label}: a planted {fault} reads {errs}, within {site['mean_limits']}")


def sdpa_timed(make, big, iters):
    """(ms, None) of the call ``make()`` returns, SDPA's forward or its
    backward, timed as the yardstick (``time_ms``); at a site whose logits
    need ``per_image`` (``big``) only the backends that stream the keys
    may take it (not the math one, which builds the [B, N, M] map): (None,
    the reason) where none takes the shape."""
    if not big:
        return time_ms(make(), iters=iters), None
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return time_ms(make(), iters=iters), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:300]


def attn_site(g, B, n, dk, dv, count, backward, iters=10, plain_iters=5):
    """One attention site: the kernel against its plain version (max
    error within KERNEL_TOL of max, per output; with one key the softmax
    is constant and dq, dk are 0 in exact arithmetic, so all three are
    held to the largest max), its contract (``check_contract``), timed
    beside the plain version and SDPA (forward, or its backward through
    autograd), with the bound of the function and PR 4's bound of the
    design. Where the batch's f32 logits pass PER_IMAGE_BYTES the plain
    and f64 references, and the plain version's time, run one image at a
    time (``per_image``)."""
    import torch
    import torch.nn.functional as F

    from gssd_torch.ops.kernels import flash_attn as fa

    q, k, v, do = attn_inputs(g, B, n, dk, dv)
    label = f"flash_attn_{'bwd' if backward else 'fwd'} B={B} N={n} dk={dk} dv={dv}"
    big = B * n * n * 4 > PER_IMAGE_BYTES
    each = per_image if big else whole
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    q4, k4, v4 = (t[:, None].detach().clone().requires_grad_(backward) for t in (q, k, v))
    ops, exps = attn_work(B, n, n, dk, dv, backward)
    if not backward:
        o_ref, lse_ref = each(fa.flash_attention_fwd_plain)(q, k, v)
        err = (o - o_ref).abs().max().item()
        scale = o_ref.abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"{label}: max err {err} > {KERNEL_TOL} * {scale}")
        check(lse_err <= 1e-4 * max(lse_ref.abs().max().item(), 1.0),
              f"{label}: lse max err {lse_err}")
        del o_ref, lse_ref
        nbytes = nbytes_of(q, k, v, o, lse)
        site = dict(max_abs_err=err, rel_err=err / scale, lse_err=lse_err,
                    **contract_fwd(q, k, v, each))
        run = lambda: fa.flash_attention_fwd(q, k, v)
        plain = lambda: each(fa.flash_attention_fwd_plain)(q, k, v)
        library = lambda: lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        old_bound = bound(ops, nbytes)[0]
    else:
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        want = each(fa.flash_attention_bwd_plain)(q, k, v, o, lse, do)
        top = max(t.float().abs().max().item() for t in want)
        errs, rels = [], []
        for name, a, b in zip("qkv", got, want):
            err = (a.float() - b.float()).abs().max().item()
            scale = top if n == 1 else b.float().abs().max().item()
            errs.append(err)
            rels.append(err / scale)
            check(math.isfinite(err) and err <= KERNEL_TOL * scale,
                  f"{label} d{name}: max err {err} > {KERNEL_TOL} * {scale}")
        del want
        nbytes = nbytes_of(q, k, v, do, o, lse, *got)
        del got
        site = dict(max_abs_err=max(errs), rel_err=max(rels),
                    **contract_bwd(q, k, v, do, each))
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)
        plain = lambda: each(fa.flash_attention_bwd_plain)(q, k, v, o, lse, do)

        def library():
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
            return lambda: torch.autograd.grad(out4, (q4, k4, v4), do[:, None],
                                               retain_graph=True)
        old_bound = bound(2 * B * n * n * (dk + 2 * dv), nbytes, 2 * B * n * n * 2 * dk)[0]
    check_contract(site, label, n)
    b_ms, b_by, b_term = attn_bound(ops, exps, nbytes)
    lib_ms, lib_none = sdpa_timed(library, big, iters)
    site.update(B=B, N=n, M=n, dk=dk, dv=dv, count=count, ms=time_ms(run, iters=iters),
                plain_ms=time_ms(plain, iters=plain_iters, warmup=1),
                plain_per_image=big, library_ms=lib_ms, library_none_because=lib_none,
                bound_ms=b_ms, bound_by=b_by,
                bound_term=b_term, old_bound_ms=old_bound, ops=ops, exps=exps, bytes=nbytes)
    if backward:
        # the forward at this batch too, beside SDPA's forward and its bound
        fwd_ops, _ = attn_work(B, n, n, dk, dv, False)
        fwd_bytes = nbytes_of(q, k, v, o, lse)
        site.update(fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=iters),
                    fwd_library_ms=sdpa_timed(
                        lambda: lambda: F.scaled_dot_product_attention(
                            q4.detach(), k4.detach(), v4.detach(), scale=1.0),
                        big, iters)[0],
                    fwd_bound_ms=attn_bound(fwd_ops, exps, fwd_bytes)[0],
                    fwd_old_bound_ms=bound(fwd_ops, fwd_bytes)[0], fwd_ops=fwd_ops,
                    fwd_bytes=fwd_bytes)
    mean = site.get("mean_rel_err", site.get("mean_rel_errs"))
    print(f"{label}: max rel err {site['rel_err']:.3g}, contract mean err {mean}, kernel "
          f"{site['ms']:.4f} ms, plain {site['plain_ms']:.4f} ms"
          f"{' (one image at a time)' if big else ''}, sdpa {site['library_ms']} "
          f"ms{f' ({lib_none})' if lib_none else ''}, bound {site['bound_ms']:.4f} ms "
          f"({b_term}; the first design's {old_bound:.4f})"
          + (f"; forward at this batch {site['fwd_ms']:.4f} ms, sdpa {site['fwd_library_ms']}"
             if backward else ""), flush=True)
    return site


def check_flash():
    """flash_attn_fwd at the 12 serving sites (batch 8): ``attn_site``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    return [dict(attn_site(g, BATCH, n, dk, dv, count, False), per_forward=count)
            for n, dk, dv, count in ATTN_SITES]


def check_flash_bwd():
    """flash_attn_bwd at the 12 training sites (batch 32): ``attn_site``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return [dict(attn_site(g, TRAIN_BATCH, n, dk, dv, count, True, plain_iters=3),
                 per_step=count)
            for n, dk, dv, count in ATTN_SITES]


def dcn_inputs(batch=BATCH, site=DCN_SITE):
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    s = site
    B, H, W, C, G, K, Cout = batch, s["H"], s["W"], s["C"], s["G"], s["K"], s["Cout"]
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


def dcn_contract(label, fwd=None, bwd=None):
    """The hat DCN's rounding contract at one site
    (``gssd_torch/ops/kernels/dcn_contract.py``): ``fwd`` = (args, kernel
    out, plain out), ``bwd`` = (args, kernel grads, plain grads). Every
    output's mean |kernel - plain| / mean |plain| within its limit, and
    every planted fault, in plain PyTorch on the card, above the limit of
    each output it touches. Returns the readings."""
    from gssd_torch.ops.kernels import dcn_contract as dc

    parts = []
    if fwd is not None:
        args, got, want = fwd
        parts.append((dc.FWD_OUTPUTS, (got,), (want,), dc.fwd_faults(args)))
    if bwd is not None:
        args, got, want = bwd
        parts.append((dc.BWD_OUTPUTS, got, want, dc.bwd_faults(args, want)))
    res = dict(mean_rel_errs={}, mean_limits={}, planted={})
    for names, got, want, planted in parts:
        errs, lims = dc.readings(names, got, want), dc.limits(names, want)
        res["mean_rel_errs"].update(errs)
        res["mean_limits"].update(lims)
        bad = dc.violations(errs, lims)
        check(not bad, f"{label}: mean err above the contract's limit: {bad}")
        missed = dc.faults_missed(planted, lims)
        check(not missed, f"{label}: a planted fault reads within the limit: {missed}")
        for fault, r in planted.items():
            res["planted"].setdefault(fault, {}).update(r)
    least = {f: min(r[n] for n in dc.AFFECTS[f] if n in r) for f, r in res["planted"].items()}
    print(f"{label} contract: " + ", ".join(
        f"{n} {e:.3g} (limit {res['mean_limits'][n]:.3g})" for n, e in
        res["mean_rel_errs"].items()) + "; least planted reading " + ", ".join(
        f"{f} {v:.3g}" for f, v in least.items()), flush=True)
    return res


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
    contract = dcn_contract(f"deform_conv_fwd B={BATCH}", fwd=(args, out, ref))
    s = DCN_SITE
    P = s["H"] * s["W"]
    ops = 2 * BATCH * P * s["K"] * s["C"] * s["Cout"]
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * 4
    b_ms, b_by = bound(ops, nbytes)
    site = dict(
        B=BATCH, **s, max_abs_err=err, rel_err=err / scale, contract=contract,
        ms=time_ms(lambda: dh.deform_conv_fwd(*args)),
        plain_ms=time_ms(lambda: dh.deform_conv_fwd_plain(*args), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
    print(f"deform_conv_fwd B={BATCH} {s['H']}x{s['W']} C={s['C']} G={s['G']} "
          f"Cout={s['Cout']}: err {err:.3g} (rel {err / scale:.3g}), kernel "
          f"{site['ms']:.4f} ms, plain {site['plain_ms']:.4f} ms, bound "
          f"{1e3 * b_ms:.2f} us ({b_by})", flush=True)
    return site


def dcn_bwd_inputs(batch=TRAIN_BATCH, site=DCN_SITE):
    """The backward's operands at a DCN site: ``dcn_inputs``' x, py, px,
    m, wg and a seeded f32 output gradient g [B, P, Cout]."""
    import torch

    x, py, px, m, wg, _ = dcn_inputs(batch, site)
    gout = torch.randn(batch, py.shape[1], wg.shape[-1], device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    return x, py, px, m, wg, gout


def check_dcn_bwd(batch=TRAIN_BATCH, site=DCN_SITE):
    """deform_conv_bwd against its plain version at the training site
    (batch 32, 38x38, C 1024, G 4, Cout 512, unless ``batch`` and ``site``
    say otherwise); each of the five gradients within KERNEL_TOL of its
    own max, and both kernels within their rounding contract at this
    batch (``dcn_contract``)."""
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    bias = dcn_inputs(batch, site)[5]
    args = dcn_bwd_inputs(batch, site)
    x, py, px, m, wg, gout = args
    B, P, G, K = py.shape
    C, Cout = x.shape[-1], wg.shape[-1]
    fwd_args = (x, py, px, m, wg, bias)
    out = dh.deform_conv_fwd(*fwd_args)
    got = dh.deform_conv_bwd(*args)
    torch.cuda.synchronize()
    want = dh.deform_conv_bwd_plain(*args)
    errs, rels = [], []
    for name, a, b in zip(("dpy", "dpx", "dm", "dx", "dwg"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        errs.append(err)
        rels.append(err / scale)
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"deform_conv_bwd {name}: max err {err} > {KERNEL_TOL} * {scale}")
    ref = dh.deform_conv_fwd_plain(*fwd_args)
    fwd_err = (out - ref).abs().max().item()
    check(math.isfinite(fwd_err) and fwd_err <= KERNEL_TOL * ref.abs().max().item(),
          f"deform_conv_fwd B={B}: max err {fwd_err}")
    H, W = x.shape[1], x.shape[2]
    contract = dcn_contract(f"hat DCN B={B} {H}x{W}", fwd=(fwd_args, out, ref),
                            bwd=(args, got, want))
    del ref, want
    # the corner terms this data needs: 6 * C/G f32 operations (dS, the
    # sample, dx) per corner that lies inside the map
    n_in = 0
    for dy in (0, 1):
        for dx in (0, 1):
            qy, qx = torch.floor(py) + dy, torch.floor(px) + dx
            n_in += int(((qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)).sum().item())
    ops = 4 * B * P * K * C * Cout
    f32_ops = 6 * (C // G) * n_in
    nbytes = nbytes_of(*args, *got)
    b_ms, b_by = bound(ops, nbytes, f32_ops)
    # the forward at this batch: its bound as check_dcn's (operations of
    # the products; bytes of the inputs and the f32 output)
    fwd_bound = bound(2 * B * P * K * C * Cout,
                      nbytes_of(x, py, px, m, wg, bias) + B * P * Cout * 4)[0]
    site = dict(
        B=B, **site, max_abs_err=max(errs), rel_err=max(rels), contract=contract,
        fwd_max_abs_err=fwd_err, fwd_ms=time_ms(lambda: dh.deform_conv_fwd(x, py, px, m, wg, bias), iters=5),
        fwd_plain_ms=time_ms(lambda: dh.deform_conv_fwd_plain(*fwd_args), iters=2, warmup=1),
        fwd_bound_ms=fwd_bound,
        ms=time_ms(lambda: dh.deform_conv_bwd(*args), iters=5),
        plain_ms=time_ms(lambda: dh.deform_conv_bwd_plain(*args), iters=2, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops, f32_ops=f32_ops,
        bytes=nbytes, corners_in_map=n_in)
    print(f"deform_conv_bwd B={B} {H}x{W} C={C} G={G} Cout={Cout}: rel err "
          f"{max(rels):.3g}, kernel {site['ms']:.4f} ms, plain {site['plain_ms']:.4f} ms, "
          f"bound {1e3 * b_ms:.2f} us ({b_by}); forward kernel at this batch "
          f"{site['fwd_ms']:.4f} ms, plain {site['fwd_plain_ms']:.4f} ms, bound "
          f"{fwd_bound:.4f} ms", flush=True)
    return site


def sample_inputs(batch, site=DCN_SITE):
    """One tap's operands of the separable sampler at a DCN site (the
    38x38 GSSD++ one unless ``site`` says otherwise), as
    deform_conv2d_pallas forms them: hat matrices A (times the mask) and
    B of sample coordinates with offsets over +-3 px (a third of them
    whole numbers), x and an output gradient, all bf16."""
    import torch

    from gssd_torch.ops.kernels import deform_sample as ds

    s = site
    H, W, G, Cg = s["H"], s["W"], s["G"], s["C"] // s["G"]
    P = H * W
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    off = torch.rand(2, batch, G, P, device="cuda", generator=g) * 6 - 3
    whole = torch.rand(off.shape, device="cuda", generator=g) < 1 / 3
    off = torch.where(whole, off.round(), off)
    # the centre tap: base - 1 (padding) + 1 (tap) + offset
    py = torch.arange(H, device="cuda").repeat_interleave(W).float() + off[0]
    px = torch.arange(W, device="cuda").repeat(H).float() + off[1]
    m = torch.rand(batch, G, P, device="cuda", generator=g)
    with torch.no_grad():
        a = (ds.hat_weights(py, H) * m[..., None]).bfloat16().contiguous()
        b = ds.hat_weights(px, W).bfloat16().contiguous()
    x = torch.randn(batch, G, H, W, Cg, device="cuda", generator=g).bfloat16()
    gout = torch.randn(batch, G, P, Cg, device="cuda", generator=g).bfloat16()
    return a, b, x, gout


def hat_extent(rows):
    """Cells from the first to the last non-zero of each hat row (0 for
    an all-zero row): [..., P, n] -> [..., P]."""
    import torch

    nz = rows != 0
    idx = torch.arange(rows.shape[-1], device=rows.device)
    first = torch.where(nz, idx, rows.shape[-1]).amin(-1)
    last = torch.where(nz, idx, -1).amax(-1)
    return (last - first + 1).clamp(min=0)


def dense_order_dx(af, bf, gf):
    """The sampler dx in the dense order, one p at a time in ascending p,
    each term A * (B * g) (exact in f32) added once: the sum the dense
    kernel formed, bit for bit."""
    import torch

    N, G, P, H = af.shape
    out = torch.zeros(N, G, H, bf.shape[-1], gf.shape[-1], dtype=torch.float32,
                      device=af.device)
    for p in range(P):
        out += af[:, :, p, :, None, None] * (bf[:, :, p, None, :, None] * gf[:, :, p, None, None])
    return out


def sample_work(a, b, Cg):
    """The work the sampler's fwd and dA/dB kernels need for these hat
    rows, counted over each row's extent (first to last non-zero):
    (fwd f32 operations: per p and channel, for each qx of B's extent the
    products and sums over A's extent and the product and sum with b;
    dab tensor-core MACs, sum_p (ext_B H + ext_A W) Cg; dab f32
    operations, the products S * g of its A operands)."""
    ext_a, ext_b = hat_extent(a).long(), hat_extent(b).long()
    H, W = a.shape[-1], b.shape[-1]
    fwd = int((ext_b * (2 * ext_a + 2) * (ext_a > 0)).sum().item()) * Cg
    dab_mac = int((ext_b * H + ext_a * W).sum().item()) * Cg
    dab_f32 = int((ext_a + ext_b).sum().item()) * Cg
    return fwd, dab_mac, dab_f32


def check_sample(cases=None):
    """The three deform_sample kernels against their plain versions at
    each of ``cases``, (label, batch, site, with the backward's two): by
    default fwd at the 38x38 site at batch 8 and 32 and at PixelLink++'s
    75x75 site (batch 16), dx and dA/dB at batch 32 and at 75x75; each
    output within SAMPLE_TOL[kernel] of its own max, the forward the
    plain version's bits and dx the dense order's sum bit for bit. Times
    kernel, plain version and one torch.einsum of the same function (the
    yardstick); bounds for the work these hat rows need, beside the dense
    contraction's. Results keyed fwd_<label>, dx_<label>, dab_<label>
    (dx and dab for the label b32)."""
    import torch

    from gssd_torch.ops.kernels import deform_sample as ds

    if cases is None:
        cases = ((f"b{BATCH}", BATCH, DCN_SITE, False),
                 (f"b{TRAIN_BATCH}", TRAIN_BATCH, DCN_SITE, True),
                 ("75", PL_BATCH, PL_DCN_SITE, True))
    sites = {}

    def compare(name, got, want):
        tol = SAMPLE_TOL[name.split()[0].removeprefix("deform_sample_")]
        errs = []
        for g_, w_ in zip(got, want):
            err = (g_ - w_).abs().max().item()
            scale = w_.abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"{name}: max err {err} (rel {err / scale:.3g}) > {tol} * {scale}")
            errs.append((err, err / scale))
        return max(e for e, _ in errs), max(r for _, r in errs)

    for label, batch, s, backward in cases:
        a, b, x, gout = sample_inputs(batch, s)
        Cg = s["C"] // s["G"]
        n_mac = batch * s["G"] * s["H"] * s["W"] * s["H"] * s["W"] * Cg
        fwd_f32, dab_mac, dab_f32 = sample_work(a, b, Cg)
        out = ds.abx_fwd(a, b, x)
        torch.cuda.synchronize()
        plain = ds.abx_fwd_plain(a, b, x)
        err, rel = compare(f"deform_sample_fwd {label}", [out], [plain])
        # hat rows: at most two non-zero exact terms in each sum, one
        # rounding in any order
        check(torch.equal(out, plain), f"deform_sample_fwd {label}: not the plain version's "
                                       f"bits at hat rows (max diff {err})")
        del plain
        nbytes = nbytes_of(a, b, x, out)
        b_ms, b_by = bound(0, nbytes, f32_ops=fwd_f32)
        sites[f"fwd_{label}"] = dict(
            B=batch, **s, max_abs_err=err, rel_err=rel, bit_equal_plain=True,
            ms=time_ms(lambda: ds.abx_fwd(a, b, x), iters=10),
            plain_ms=time_ms(lambda: ds.abx_fwd_plain(a, b, x), iters=3, warmup=1),
            library_ms=time_ms(lambda: torch.einsum("ngph,ngpw,nghwc->ngpc", a, b, x),
                               iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, f32_ops=fwd_f32,
            dense_bound_ms=bound(2 * n_mac, nbytes)[0], dense_ops=2 * n_mac)
        if not backward:
            del a, b, x, gout, out
            torch.cuda.empty_cache()
            continue
        dx = ds.abx_dx(a, b, gout)
        torch.cuda.synchronize()
        err, rel = compare(f"deform_sample_dx {label}", [dx], [ds.abx_dx_plain(a, b, gout)])
        af, bf, gf = a.float(), b.float(), gout.float()
        dense = dense_order_dx(af, bf, gf)
        check(torch.equal(dx, dense), f"deform_sample_dx {label}: not the dense order's sum bit "
                                      f"for bit (max diff {(dx - dense).abs().max().item()})")
        del dense
        # the work this data needs: 3 f32 operations (B * g, then A * E
        # added) a channel for each (qy, qx) inside both hat rows'
        # non-zero ranges
        terms = int((hat_extent(a) * hat_extent(b)).sum().item()) * Cg
        b_ms, b_by = bound(0, nbytes_of(a, b, gout, dx), f32_ops=3 * terms)
        sites["dx" if label == f"b{TRAIN_BATCH}" else f"dx_{label}"] = dict(
            B=batch, **s, max_abs_err=err, rel_err=rel, dense_order_bit_equal=True,
            ms=time_ms(lambda: ds.abx_dx(a, b, gout), iters=10),
            plain_ms=time_ms(lambda: ds.abx_dx_plain(a, b, gout), iters=3, warmup=1),
            library_ms=time_ms(lambda: torch.einsum("ngph,ngpw,ngpc->nghwc", af, bf, gf),
                               iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, f32_ops=3 * terms,
            dense_bound_ms=bound(0, nbytes_of(a, b, gout, dx), f32_ops=2 * n_mac)[0],
            dense_f32_ops=2 * n_mac)
        del af, bf, gf, dx
        da, db = ds.abx_dab(x, gout, a, b)
        torch.cuda.synchronize()
        err, rel = compare(f"deform_sample_dab {label}", [da, db],
                           ds.abx_dab_plain(x, gout, a, b))
        nbytes = nbytes_of(x, gout, a, b, da, db)
        b_ms, b_by = bound(2 * dab_mac, nbytes, f32_ops=dab_f32)

        def library_dab(a=a, b=b, x=x, gout=gout):
            torch.einsum("ngpw,ngpc,nghwc->ngph", b, gout, x)
            torch.einsum("ngph,ngpc,nghwc->ngpw", a, gout, x)

        sites["dab" if label == f"b{TRAIN_BATCH}" else f"dab_{label}"] = dict(
            B=batch, **s, max_abs_err=err, rel_err=rel,
            ms=time_ms(lambda: ds.abx_dab(x, gout, a, b), iters=10),
            plain_ms=time_ms(lambda: ds.abx_dab_plain(x, gout, a, b), iters=3, warmup=1),
            library_ms=time_ms(library_dab, iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, ops=2 * dab_mac, f32_ops=dab_f32,
            dense_bound_ms=bound(4 * n_mac, nbytes)[0], dense_ops=4 * n_mac)
        del a, b, x, gout, out, da, db
        torch.cuda.empty_cache()
    print(f"deform_sample_fwd: the plain version's bits at hat rows "
          f"({', '.join(c[0] for c in cases)}); deform_sample_dx: the dense order's sum bit "
          f"for bit ({', '.join(c[0] for c in cases if c[3])})", flush=True)
    for name, site in sites.items():
        print(f"deform_sample_{name} B={site['B']} {site['H']}x{site['W']} "
              f"Cg={site['C'] // site['G']}: rel err {site['rel_err']:.3g}, kernel "
              f"{site['ms']:.4f} ms, plain {site['plain_ms']:.4f} ms, einsum "
              f"{site['library_ms']:.4f} ms, bound {1e3 * site['bound_ms']:.2f} us "
              f"({site['bound_by']}; dense {1e3 * site['dense_bound_ms']:.2f} us)", flush=True)
    return sites


def dcn_grads():
    """One DCN layer at the GSSD++ site (1024 -> 512, 4 deformable groups,
    38x38, batch 8, bf16) on the pallas and fused routes: the gradients of
    the input and of every parameter through the kernels against those
    through the plain versions; cosine >= DCN_COS_MIN each."""
    import torch

    from gssd_torch.ops.deform_conv import DCN

    s = DCN_SITE
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(BATCH, s["C"], s["H"], s["W"], device="cuda", generator=g).bfloat16()
    r = torch.randn(BATCH, s["Cout"], s["H"], s["W"], device="cuda", generator=g)
    report = {}
    for impl in ("pallas", "fused"):
        mod = DCN(s["C"], s["Cout"], deformable_groups=s["G"], impl=impl,
                  generator=torch.Generator().manual_seed(SEED)).cuda()
        with torch.no_grad():
            w = mod.conv_offset_mask.weight
            w.normal_(0, 1 / math.sqrt(w[0].numel()), generator=g)
            mod.conv_offset_mask.bias.normal_(0, 0.1, generator=g)

        def grads(plain):
            xx = x.clone().requires_grad_()
            mod.zero_grad()
            with plain_versions() if plain else contextlib.nullcontext():
                out, _ = mod(xx)
                (out.float() * r).sum().backward()
            return {"x": xx.grad.float(), **{n: p.grad.float() for n, p in mod.named_parameters()}}

        got, want = grads(False), grads(True)
        cos = {n: ((got[n] * want[n]).sum() / (got[n].norm() * want[n].norm())).item()
               for n in want}
        print(f"DCN[{impl}] gradients, kernels vs plain versions (bf16): cosines {cos} "
              f"(limit {DCN_COS_MIN})", flush=True)
        check(all(c >= DCN_COS_MIN for c in cos.values()),
              f"DCN[{impl}] gradient cosine below {DCN_COS_MIN}: {cos}")
        report[impl] = cos
    return report


def recipe_model(compute_dtype, seed=SEED, size=300):
    """GSSD++ at input ``size`` as the trainer builds it from ``seed``
    (``build_model``'s initialisation), on the host."""
    from gssd_torch.config import ModelConfig
    from gssd_torch.infer import REFERENCE_RECIPES
    from gssd_torch.models import build_model

    recipe = REFERENCE_RECIPES["gssd++"]
    keys = ("ssd_type", "use_self_attention", "use_self_attention_base",
            "groups_dcn", "num_dcn_layers", "dcn_cat_sab")
    cfg = ModelConfig(compute_dtype=compute_dtype, size=size, **{k: recipe[k] for k in keys})
    return build_model(cfg, device="cpu", seed=seed)


def seeded_model(compute_dtype, seed=SEED, size=300):
    """GSSD++ at input ``size`` with random weights from ``seed`` that make every path
    contribute: He-scaled convs (activations keep their scale through
    the ReLUs), BN running stats away from (0, 1), attention sigma 0.5
    with the spectral-norm vectors at their top singular pair, and an
    offset predictor whose offsets are about a pixel."""
    import torch

    from gssd_torch.ops.deform_conv import DCN
    from gssd_torch.ops.layers import ConvBNRelu, SelfAttention, SNDense

    model, priors = recipe_model(compute_dtype, seed, size)
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


def serve(tmp, size=300, data=None, attn_per_forward=12):
    """The serving CLI at ``--ssd_dim size`` over 32 synthetic 512x512
    slices (made here unless ``data`` holds them) in forwards of 8, from
    seeded weights: exactly ``attn_per_forward`` attention and 1 hat DCN
    launches a forward, the detections' JSON, the latency."""
    import torch

    from gssd_torch import infer
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.ops.kernels import KERNELS

    model, _ = seeded_model("bfloat16", size=size)
    weights = os.path.join(tmp, f"gssd_pp_{size}.pt")
    torch.save(model.state_dict(), weights)
    if data is None:
        data = os.path.join(tmp, "ml_ready")
        t0 = time.perf_counter()
        make_synthetic_dataset(data, num_subjects=8, slices_per_subject=4, image_size=512,
                               seed=SEED)
        print(f"synthetic data: {time.perf_counter() - t0:.1f} s", flush=True)
    det_path = os.path.join(tmp, f"detections_{size}.json")
    n_images = 32
    n_batches = n_images // BATCH
    for k in KERNELS.values():
        k.launches = 0
    res = infer.main([
        "--reference_recipe", "gssd++", "--datapath", data, "--split", "all",
        "--num_test_subjects", "2", "--eval_batch", str(BATCH), "--ssd_dim", str(size),
        "--device", "cuda", "--compute_dtype", "bfloat16",
        "--weights", weights, "--det_output", det_path])
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"main-path launches over {n_batches} forwards at {size}: {launches}", flush=True)
    want = {name: 0 for name in KERNELS}
    want.update(flash_attn_fwd=attn_per_forward * n_batches, deform_conv_fwd=n_batches)
    check(launches == want, f"expected {attn_per_forward} flash and 1 DCN launch per forward "
                            f"at {size}, got {launches}")
    with open(det_path) as f:
        dets = json.load(f)
    check(len(dets) == n_images and all(set(d) == {"id", "scores", "boxes"} for d in dets),
          "detections JSON malformed")
    lat = res["latency_ms"]
    check(len(lat) == n_batches - 1 and all(math.isfinite(t) and t > 0 for t in lat),
          f"bad latency record {lat}")
    print(f"serving latency at {size} (excl. first batch, batch {BATCH}): "
          f"{sum(lat) / len(lat):.3f} ms/image over {len(lat)} batches", flush=True)
    return launches, lat, data, weights


def serve_pallas(tmp, data, weights, size=300, attn_per_forward=12):
    """The serving CLI at ``--ssd_dim size`` with --dcn_impl pallas over
    the 32 slices of the serving phase (four forwards of 8), launches
    counted: exactly ``attn_per_forward`` attention and 9
    deform_sample_fwd launches a forward."""
    from gssd_torch import infer
    from gssd_torch.ops.kernels import KERNELS

    n_batches = 4
    for k in KERNELS.values():
        k.launches = 0
    res = infer.main([
        "--reference_recipe", "gssd++", "--datapath", data, "--split", "all",
        "--num_test_subjects", "2", "--eval_batch", str(BATCH), "--dcn_impl", "pallas",
        "--ssd_dim", str(size), "--device", "cuda", "--compute_dtype", "bfloat16",
        "--weights", weights, "--det_output", os.path.join(tmp, f"detections_pallas_{size}.json")])
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"pallas serving launches over {n_batches} forwards at {size}: {launches}", flush=True)
    want = {name: 0 for name in KERNELS}
    want.update(flash_attn_fwd=attn_per_forward * n_batches, deform_sample_fwd=9 * n_batches)
    check(launches == want, f"expected {attn_per_forward} flash and 9 deform_sample_fwd "
                            f"launches per forward at {size}, got {launches}")
    check(len(res["detections"]) == 8 * n_batches, "pallas serving: wrong detection count")
    lat = res["latency_ms"]
    print(f"pallas serving latency at {size} (excl. first batch, batch {BATCH}): "
          f"{sum(lat) / len(lat):.3f} ms/image over {len(lat)} batches", flush=True)
    return launches, lat


def breakdown(size=300):
    """Where one batch's serving time goes at input ``size``: the
    pageable host-to-device copy (host clock), the forward and Detect/NMS
    (CUDA events)."""
    import numpy as np
    import torch

    from gssd_torch.config import DetectConfig
    from gssd_torch.ops.nms import detect

    model, priors = seeded_model("bfloat16", size=size)
    model = model.to("cuda").eval()
    priors = torch.tensor(priors, device="cuda")
    x = np.random.default_rng(SEED).uniform(0, 1, (BATCH, size, size, 12)).astype(np.float32)
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
    print(f"batch-{BATCH} breakdown at {size}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return parts


def parity(data, size=300):
    import numpy as np
    import torch

    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset

    ids = DataSplitter(data, 1, 2).data_test[:1]
    raw = LesionDataset(data, ids).pull_image(0)
    x, _, _ = BaseTransform(size)(raw)
    x = np.transpose(x, (1, 2, 0, 3)).reshape(1, size, size, 12)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    outs = {}
    for dtype, device in (("float32", "cpu"), ("bfloat16", "cuda")):
        model, _ = seeded_model(dtype, size=size)
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
        print(f"parity {name} at {size}: max |bf16 card - f32 cpu| = {err:.4g}, "
              f"max |f32| = {scale:.4g}, ratio {err / scale:.4g} (limit {E2E_TOL})", flush=True)
        check(err <= E2E_TOL * scale, f"{name}: bf16 card vs f32 cpu {err} > {E2E_TOL} * {scale}")
    return errs


# launches per train step of each DCN route (no evaluation in the run)
ROUTE_LAUNCHES = {
    "hat": dict(flash_attn_fwd=12, flash_attn_bwd=12, deform_conv_fwd=1, deform_conv_bwd=1),
    "pallas": dict(flash_attn_fwd=12, flash_attn_bwd=12, deform_sample_fwd=9,
                   deform_sample_dx=9, deform_sample_dab=9),
    "fused": dict(flash_attn_fwd=12, flash_attn_bwd=12, deform_sample_dx=9),
}


def train_argv(tmp, impl="hat", batch=TRAIN_BATCH, iters=TRAIN_ITERS, out="run",
               device="cuda"):
    return ["--reference_recipe", "gssd++", "--synthetic", "True",
            "--datapath", os.path.join(tmp, "train_ml"), "--num_test_subjects", "4",
            "--load_data_to_ram", "True", "--batch_size", str(batch), "--max_iter", str(iters),
            "--device", device, "--compute_dtype", "bfloat16", "--seed", str(SEED),
            "--dcn_impl", impl, "--output", os.path.join(tmp, out)]


def train(tmp, impl="hat", batch=TRAIN_BATCH, iters=TRAIN_ITERS):
    """The trainer CLI at the published recipe on synthetic data with DCN
    route ``impl``, the launches of the run counted: exactly
    ROUTE_LAUNCHES[impl] per step."""
    from gssd_torch import train as trainer
    from gssd_torch.ops.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    res = trainer.main(train_argv(tmp, impl, batch, iters, out=f"run_{impl}"))
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"training ({impl}) launches over {iters} steps: {launches}", flush=True)
    want = {name: ROUTE_LAUNCHES[impl].get(name, 0) * iters for name in KERNELS}
    check(launches == want, f"{impl}: expected {ROUTE_LAUNCHES[impl]} launches per step, "
                            f"got {launches}")
    losses = [r["loss"] for r in res["records"]]
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"{impl}: non-finite or missing training losses {losses}")
    median = res["median_step_ms"]
    print(f"training ({impl}): median {median:.2f} ms/step after the first step, "
          f"{batch / median * 1e3:.1f} slices/s at batch {batch}; losses {losses}", flush=True)
    return launches, res, os.path.join(tmp, "train_ml")


def eval_resume_test(tmp, device="cuda", batch=TRAIN_BATCH):
    """The hat trainer with an evaluation and a checkpoint at iteration 2
    of 3 (--val_every 2 --speedrun 2), --stepvalues 3; the checkpoint
    restored into a fresh model and optimizer must equal the trainer's
    state bit for bit; --resume 2 must run its first step (iteration 2,
    step 3) at the LR past the boundary; --test --checkpoint 2 must give
    the AP/IoBB keys in [0, 1]."""
    import torch

    from gssd_torch import train as trainer
    from gssd_torch.models import build_model
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.checkpoint import restore_checkpoint
    from gssd_torch.train.trainer import model_config, parse_args

    extra = ["--val_every", "2", "--speedrun", "2", "--stepvalues", "3", "--eval_batch", "16"]
    argv = train_argv(tmp, "hat", batch, ROUTE_ITERS, "run_eval", device) + extra
    t0 = time.perf_counter()
    first = trainer.main(argv)
    evals = first["evals"]
    check([e["iter"] for e in evals] == [2] and first["step"] == 3,
          f"expected one evaluation at iteration 2 after 3 steps, got {evals}")
    for split in ("valid", "test"):
        res = evals[0][split]
        check(set(res) == AP_KEYS and all(0.0 <= v <= 1.0 for v in res.values()),
              f"{split} AP/IoBB malformed: {res}")
    print(f"evaluation at iteration 2: valid {evals[0]['valid']}, test {evals[0]['test']}",
          flush=True)

    args = parse_args(argv)
    model, _ = build_model(model_config(args), device="cpu", seed=SEED + 7)
    model = model.to(device)
    opt = make_optimizer(model, _optim())
    step = restore_checkpoint(model, opt, os.path.join(args.output, "checkpoints"),
                              args.model_name, 2)
    want_sd, got_sd = first["model"].state_dict(), model.state_dict()
    same = [torch.equal(got_sd[k], v) for k, v in want_sd.items()]
    want_opt, got_opt = first["optimizer"].state_dict(), opt.state_dict()
    same_m = [torch.equal(got_opt["state"][i]["momentum_buffer"], st["momentum_buffer"])
              for i, st in want_opt["state"].items()]
    check(step == 3 and all(same) and len(same) == len(got_sd) and all(same_m)
          and len(same_m) == len(list(model.parameters())),
          f"restore is not exact: step {step}, {same.count(False)} tensors and "
          f"{same_m.count(False)} momenta differ")
    print(f"checkpoint restored bit for bit: {len(same)} state tensors, {len(same_m)} "
          f"momenta, step {step}", flush=True)
    del model, opt

    resumed = trainer.main(train_argv(tmp, "hat", batch, 4, "run_eval", device) + extra
                           + ["--resume", "2"])
    recs = resumed["records"]
    lr_want = args.lr * args.gamma
    check([r["iter"] for r in recs] == [2, 3] and abs(recs[0]["lr"] - lr_want) < 1e-12
          and resumed["step"] == 5 and all(math.isfinite(r["loss"]) for r in recs),
          f"resume: expected iterations [2, 3] from step 3 at lr {lr_want}, got "
          f"{[(r['iter'], r['lr'], r['loss']) for r in recs]}, step {resumed['step']}")
    print(f"resumed at iteration 2, step 3, lr {recs[0]['lr']:.2e}; losses "
          f"{[r['loss'] for r in recs]}", flush=True)

    tested = trainer.main(argv + ["--test", "True", "--checkpoint", "2"])["test"]
    check(set(tested) == AP_KEYS and all(0.0 <= v <= 1.0 for v in tested.values()),
          f"--test AP/IoBB malformed: {tested}")
    print(f"--test --checkpoint 2: {tested}", flush=True)
    return {"evaluation": evals[0], "resumed_losses": [r["loss"] for r in recs],
            "resumed_lr": recs[0]["lr"], "test": tested, "median_step_ms": first["median_step_ms"],
            "seconds": time.perf_counter() - t0}


def fixed_batch(data, n, device):
    """n slices of the synthetic set through the eval transform, as a
    device batch (the training split repeated as needed)."""
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset, collate
    from gssd_torch.train.trainer import to_device

    ids = DataSplitter(data, 1, 4).data_cv_train[0]
    ids = (ids * (n // len(ids) + 1))[:n]
    ds = LesionDataset(data, ids, transform=BaseTransform(300))
    return to_device(collate([ds[i] for i in range(n)]), device)


def _optim():
    from gssd_torch.config import OptimConfig
    from gssd_torch.infer import REFERENCE_RECIPES

    r = REFERENCE_RECIPES["gssd++"]
    return OptimConfig(lr=r["lr"], gamma=r["gamma"], stepvalues=tuple(r["stepvalues"]),
                       modify_dcn_lr=r["modify_dcn_lr"])


def descend_and_split(data, device="cuda", batch=TRAIN_BATCH):
    """Six train steps on one repeated batch from seeded weights (five
    updates: the loss must fall), each split by CUDA events into
    forward, loss, backward and optimizer."""
    import torch

    from gssd_torch.config import LossConfig
    from gssd_torch.ops.losses import multibox_loss
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.steps import backward, update

    model, priors = seeded_model("bfloat16")
    model = model.to(device).train()
    priors = torch.tensor(priors, device=device)
    b = fixed_batch(data, batch, device)
    opt, ocfg, lcfg = make_optimizer(model, _optim()), _optim(), LossConfig()
    losses, parts = [], []
    for step in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)] if device == "cuda" else []
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        mark(0)
        out = model(b["image"])
        mark(1)
        loss_l, loss_c, _ = multibox_loss(out["loc"], out["conf"], priors, b["boxes"],
                                          b["labels"], b["valid"], lcfg)
        loss = loss_l + loss_c
        mark(2)
        grads = backward(model, opt, loss)
        mark(3)
        update(opt, grads, ocfg, step)
        mark(4)
        losses.append(loss.item())
        if ev:
            torch.cuda.synchronize()
            parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    print(f"repeated batch of {batch}, 5 updates: losses {losses}", flush=True)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"the loss did not fall on a repeated batch: {losses}")
    split = {}
    if parts:
        for i, key in enumerate(("forward_ms", "loss_ms", "backward_ms", "optimizer_ms")):
            vals = sorted(p[i] for p in parts[1:])
            split[key] = vals[len(vals) // 2]
        print("train step split (median of steps 2-6): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    return losses, split


@contextlib.contextmanager
def plain_versions():
    """Route the nine kernel boundaries to their plain versions, also for
    CUDA tensors, for the length of the block (the autograd Functions
    look the boundaries up at call time)."""
    from gssd_torch.ops.kernels import deform_hat as dh
    from gssd_torch.ops.kernels import deform_sample as ds
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import stem_conv as sc

    swaps = [(fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
             (dh, "deform_conv_fwd"), (dh, "deform_conv_bwd"),
             (ds, "abx_fwd"), (ds, "abx_dx"), (ds, "abx_dab"),
             (sc, "stem_conv_fwd"), (sc, "stem_conv_bwd")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _structural_zero(name, model, cfg):
    """Gradients that are 0 in exact arithmetic, so that their direction
    is rounding noise: a conv bias in front of a train-mode BatchNorm
    (the batch mean removes it), the attention key bias (it shifts every
    logit of a row alike), and the value and output biases of an
    attention block whose output only reaches the loss through a conv
    and a train-mode BatchNorm (a per-channel shift, removed again)."""
    if name.endswith(".phi.bias"):
        return True
    if name.endswith(".conv.bias"):
        return getattr(model.get_submodule(name[: -len(".conv.bias")]), "bn", None) is not None
    block = name.split(".")[0]
    feeds_dcn = cfg.dcn_cat_sab and block == "attn_base_0"
    return (block.startswith("attn") and not feeds_dcn
            and name.endswith((".g.bias", ".out.bias")))


def train_parity(data, f32_device="cpu", device="cuda"):
    """Loss and gradients of one train step at batch 2, from the same
    seeded weights and batch, in four runs: f32 on the CPU (plain
    versions), f32 on the card (the DCN runs through its kernels there
    too), bf16 on the card through the kernels, and bf16 on the card
    through the plain versions.

    Checks: the bf16 loss (kernels) against the f32 loss within
    TRAIN_LOSS_TOL; then, with the f32 run's mined negatives replayed in
    the other runs (mining is a discrete choice, and bf16 logits reorder
    near-tied negatives), the cosine of every parameter's gradient,
    f32 card against f32 CPU at least TRAIN_COS_MIN and bf16 kernels
    against bf16 plain versions at least KERNEL_COS_MIN. Left out:
    gradients that are 0 in exact arithmetic (``_structural_zero``) and
    those this batch's loss does not reach. The cosine between the bf16
    and the f32 gradients is printed, not held to a limit: bf16 rounding
    moves the early layers' gradients of this model far from f32 (cosines
    down to ~0.3), through the plain versions as much as through the
    kernels, so that cosine says nothing about the kernels (PERF.md)."""
    import torch

    from gssd_torch.config import LossConfig
    from gssd_torch.ops import losses
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.steps import backward, forward_loss

    mined = {}
    real = losses.hard_negatives

    def replay(ce, pos, ratio):
        neg = real(ce, pos, ratio)
        mined.setdefault("ref", neg.cpu())
        mined["moved"] = int((neg.cpu() != mined["ref"]).sum())
        return mined["ref"].to(ce.device) if mined["replay"] else neg

    def run(dtype, dev, replaying, plain=False):
        mined["replay"] = replaying
        model, priors = seeded_model(dtype)
        model = model.to(dev).train()
        with plain_versions() if plain else contextlib.nullcontext():
            loss_l, loss_c, _ = forward_loss(model, torch.tensor(priors, device=dev),
                                             fixed_batch(data, 2, dev), LossConfig())
            backward(model, make_optimizer(model, _optim()), loss_l + loss_c)
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f"non-finite {dtype} gradient on {dev}")
        return (loss_l + loss_c).item(), mined["moved"], grads, model

    losses.hard_negatives = replay
    try:
        ref_loss, _, ref_g, model = run("float32", f32_device, False)
        got_loss, moved, _, _ = run("bfloat16", device, False)
        f32_g = run("float32", device, True)[2]
        bf16_g = run("bfloat16", device, True)[2]
        plain_g = run("bfloat16", device, True, plain=True)[2]
    finally:
        losses.hard_negatives = real

    loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
    print(f"train parity: loss f32 cpu {ref_loss:.6g}, bf16 card {got_loss:.6g}, rel "
          f"{loss_rel:.4g} (limit {TRAIN_LOSS_TOL}); {moved} mined negatives differ",
          flush=True)
    check(math.isfinite(got_loss) and loss_rel <= TRAIN_LOSS_TOL,
          f"train loss bf16 card vs f32 cpu: rel {loss_rel} > {TRAIN_LOSS_TOL}")
    kept = [n for n, g in ref_g.items()
            if not _structural_zero(n, model, model.cfg) and g.norm().item() > 0]

    def cosines(a, b):
        out = {}
        for n in kept:
            den = (a[n].norm() * b[n].norm()).item()
            out[n] = (a[n] * b[n]).sum().item() / den if den > 0 else float("nan")
        return out

    report = {"loss_rel": loss_rel, "negatives_moved": moved, "n_params": len(kept),
              "n_left_out": len(ref_g) - len(kept)}
    for key, (a, b), limit in (("f32_card_vs_cpu", (ref_g, f32_g), TRAIN_COS_MIN),
                               ("bf16_kernels_vs_plain", (plain_g, bf16_g), KERNEL_COS_MIN),
                               ("bf16_card_vs_f32_cpu", (ref_g, bf16_g), None),
                               ("bf16_plain_vs_f32_cpu", (ref_g, plain_g), None)):
        cos = cosines(a, b)
        worst = sorted(cos.items(), key=lambda kv: (kv[1] == kv[1], kv[1]))[:4]
        report[key] = worst
        print(f"train parity {key}: gradient cosine over {len(cos)} parameters "
              f"({report['n_left_out']} left out), worst {worst}"
              + (f" (limit {limit})" if limit else " (not held to a limit)"), flush=True)
        if limit:
            check(all(c >= limit for c in cos.values()),
                  f"{key}: gradient cosine below {limit}: {worst}")
    return report


# ---- PixelLink++ (4s) with the wide-conv switch on: the stem kernels ----

# (name, Cin, Cout) of the two stem sites, 4 groups, at 300 x 300
STEM_SITES = [("conv1_1", 12, 64), ("conv1_2", 64, 64)]
PL_BATCH = 16  # the pixellink++ recipe's batch
# (N = M tokens, dk, dv, launches per forward) of PixelLink++ (4s)'s 8
# attention sites at 300 x 300
PL_ATTN_SITES = [(5625, 32, 128, 2), (1444, 64, 256, 2), (361, 64, 256, 2), (361, 128, 512, 2)]
PL_ITERS = 5
# the stem kernels against their plain versions (both on the card): the
# same roundings, f32 sums in another order, so a bf16 output can flip by
# one ulp where its f32 sum lies near a rounding boundary. Every element
# within STEM_ULP_MAX bf16 ulp, counted at the element's magnitude or at
# max |plain| / 256 where the element is smaller (an output near zero is
# a near-cancelling sum, whose f32 order noise is that of its large
# terms: thousands of steps of its own tiny value at batch 16, PERF.md),
# and at most STEM_DIFF_SHARE of the elements differing at all
# (read <= 2.45e-5 at batch 16; a double rounding, conv rounded to bf16
# then a bf16 bias added, reads 0.29: the negative control of
# check_stem). dW is f32: within STEM_DW_TOL of max |plain| (read <=
# 2.2e-6: sums of 1.44M exact products in another order)
STEM_ULP_MAX = 1
STEM_DIFF_SHARE = 2e-4
STEM_DW_TOL = 2e-5
# the f32 forward's contract check (check_stem_f32): its batch, and how far
# above the limit the planted two-part split must read
STEM_F32_BATCH = 2
STEM_F32_PLANTED_MIN = 5
# attention sites of PixelLink++ by --version: 4s has 8, 2s also
# attn_base_0 and attn_0 at conv2_2 (150 x 150)
PL_SITES = {"4s": 8, "2s": 10}
# launches of one PixelLink++ train step (remat recomputes the attention
# forwards) and of one forward (valid loss, evaluation, --test)
PL_STEP_LAUNCHES = {v: dict(stem_conv_fwd=2, stem_conv_bwd=2, flash_attn_fwd=2 * n,
                            flash_attn_bwd=n, deform_conv_fwd=1, deform_conv_bwd=1)
                    for v, n in PL_SITES.items()}
PL_FORWARD_LAUNCHES = {v: dict(stem_conv_fwd=2, flash_attn_fwd=n, deform_conv_fwd=1)
                       for v, n in PL_SITES.items()}
# the same step on the pallas DCN route: the sampler's three kernels once
# per tap (9) in place of the hat DCN pair
PL_PALLAS_ITERS = 3
PL_PALLAS_STEP_LAUNCHES = {v: dict(stem_conv_fwd=2, stem_conv_bwd=2, flash_attn_fwd=2 * n,
                                   flash_attn_bwd=n, deform_sample_fwd=9, deform_sample_dx=9,
                                   deform_sample_dab=9)
                           for v, n in PL_SITES.items()}
PL_AP_KEYS = {"ap50", "iobb50"}


def bf16_ulp_err(got, want):
    """|got - want| per element in bf16 ulps of max(|want|, max|want| /
    256) (bf16 tensors)."""
    import torch

    g, w = got.float(), want.float()
    scale = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def _agreement(got, want):
    """(the largest bf16_ulp_err, the share of elements that differ)."""
    return (bf16_ulp_err(got, want).max().item(),
            (got != want).float().mean().item())


def raw_bf16_ulps(got, want):
    """The largest distance in bf16 steps between two bf16 tensors, with
    no floor (near zero it counts every step between tiny values)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i + 32768), i)

    return int((ordered(got) - ordered(want)).abs().max().item())


def stem_site(g, name, cin, cout, B, G, backward=True, planted=False, witness=False):
    """stem_conv_fwd (and with ``backward`` stem_conv_bwd) against their
    plain versions at one stem site (300 x 300, bf16, batch B, G groups):
    y and dx within STEM_ULP_MAX ulp with at most STEM_DIFF_SHARE of the
    elements differing, dW within STEM_DW_TOL of max |plain|. ``planted``:
    a planted double rounding of the forward must fail the share limit.
    ``witness``: dW also within STEM_DW_TOL of max |dW64|, the same sum in
    f64 (the plain version's reading beside it). Times kernel, plain
    version and cuDNN (F.conv2d, aten.convolution_backward), the
    yardstick the port never calls, beside each call's bound."""
    import torch
    import torch.nn.functional as F

    from gssd_torch.ops.kernels import stem_conv as sc

    H = W = 300
    tag = f"stem_conv {name} B={B} {cin}->{cout} G={G}"
    x = torch.rand(B, cin, H, W, device="cuda", generator=g).bfloat16()
    w = torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g) * math.sqrt(
        2 / (9 * cin / G))
    b = torch.randn(cout, device="cuda", generator=g) * 0.5
    gout = torch.randn(B, cout, H, W, device="cuda", generator=g).bfloat16() if backward \
        else None
    wb = w.bfloat16()
    y = sc.stem_conv_fwd(x, wb, b, G)
    torch.cuda.synchronize()
    yp = sc.stem_conv_fwd_plain(x, wb, b, G)
    y_ulp, y_share = _agreement(y, yp)
    ops = 2 * B * H * W * cout * (cin // G) * 9
    fwd_bytes = nbytes_of(x, wb, b, y)
    fwd_bound = bound(ops, fwd_bytes)
    site = dict(site=name, B=B, H=H, W=W, Cin=cin, Cout=cout, G=G, y_max_ulp=y_ulp,
                y_share=y_share, unfloored_max_steps=raw_bf16_ulps(y, yp), ops=ops,
                fwd_bytes=fwd_bytes, max_abs_err=(y.float() - yp.float()).abs().max().item())
    msg = f"{tag}: y max {y_ulp:.3g} ulp, {y_share:.3g} differ"
    checks = [("y", y_ulp, y_share)]
    if planted:
        p_ulp, p_share = _agreement(
            F.conv2d(x.float(), wb.float(), None, padding=1, groups=G).bfloat16()
            + b.bfloat16()[None, :, None, None], yp)
        site.update(planted_max_ulp=p_ulp, planted_share=p_share)
        msg += f"; planted double rounding: max {p_ulp:.3g} ulp, {p_share:.3g} differ"
        check(p_share > STEM_DIFF_SHARE,
              f"{tag}: the planted double rounding passes the share limit "
              f"({p_share} <= {STEM_DIFF_SHARE})")
    if backward:
        need_dx = name != "conv1_1"  # conv1_1's input is the image
        dx, dw = sc.stem_conv_bwd(x, w, gout, G, need_dx)
        torch.cuda.synchronize()
        dxp, dwp = sc.stem_conv_bwd_plain(x, w, gout, G, need_dx)
        dx_ulp, dx_share = _agreement(dx, dxp) if need_dx else (0, 0.0)
        dw_rel = ((dw - dwp).abs().max() / dwp.abs().max()).item()
        site.update(need_dx=need_dx, dx_max_ulp=dx_ulp, dx_share=dx_share, dw_rel=dw_rel,
                    unfloored_max_steps=max(site["unfloored_max_steps"],
                                            raw_bf16_ulps(dx, dxp) if need_dx else 0),
                    max_abs_err=max(site["max_abs_err"],
                                    (dx.float() - dxp.float()).abs().max().item()
                                    if need_dx else 0.0,
                                    (dw - dwp).abs().max().item()))
        msg += f"; dx max {dx_ulp:.3g} ulp, {dx_share:.3g} differ; dW rel {dw_rel:.3g}"
        checks.append(("dx", dx_ulp, dx_share))
        check(math.isfinite(dw_rel) and dw_rel <= STEM_DW_TOL,
              f"{tag} dW: rel err {dw_rel} > {STEM_DW_TOL}")
        if witness:
            # the same f32 function's sum in f64, a few images at a time
            dw64 = sum(torch.nn.grad.conv2d_weight(
                x[i:i + 8].double(), tuple(w.shape), gout[i:i + 8].double(), padding=1,
                groups=G) for i in range(0, B, 8))
            top = dw64.abs().max()
            site.update(dw_vs_f64=((dw - dw64).abs().max() / top).item(),
                        dw_plain_vs_f64=((dwp - dw64).abs().max() / top).item())
            msg += (f"; dW against f64 {site['dw_vs_f64']:.3g} (plain version "
                    f"{site['dw_plain_vs_f64']:.3g}; limit {STEM_DW_TOL})")
            check(site["dw_vs_f64"] <= STEM_DW_TOL,
                  f"{tag} dW against f64: rel err {site['dw_vs_f64']} > {STEM_DW_TOL}")
            del dw64
    print(f"{msg}; unfloored max {site['unfloored_max_steps']} steps", flush=True)
    for what, ulp, share in checks:
        check(ulp <= STEM_ULP_MAX and share <= STEM_DIFF_SHARE,
              f"{tag} {what}: {ulp} ulp max, {share} of elements differ "
              f"(limits {STEM_ULP_MAX}, {STEM_DIFF_SHARE})")
    site.update(
        fwd_ms=time_ms(lambda: sc.stem_conv_fwd(x, wb, b, G)),
        fwd_plain_ms=time_ms(lambda: sc.stem_conv_fwd_plain(x, wb, b, G), iters=5),
        fwd_library_ms=time_ms(lambda: F.conv2d(x, wb, b.bfloat16(), padding=1, groups=G)),
        fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1])
    msg = (f"  forward: kernel {site['fwd_ms']:.4f} ms, plain {site['fwd_plain_ms']:.4f}, "
           f"cuDNN {site['fwd_library_ms']:.4f}, bound {site['fwd_bound_ms']:.4f} "
           f"({site['fwd_bound_by']})")
    if backward:
        xr = x.detach().requires_grad_(need_dx)
        bwd_bytes = nbytes_of(x, gout, dw, *((dx,) if need_dx else ()))
        bwd_bound = bound(ops * (2 if need_dx else 1), bwd_bytes)
        site.update(
            bwd_ms=time_ms(lambda: sc.stem_conv_bwd(x, w, gout, G, need_dx), iters=10),
            bwd_plain_ms=time_ms(lambda: sc.stem_conv_bwd_plain(x, w, gout, G, need_dx),
                                 iters=3),
            bwd_library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                gout, xr, wb, [cout], [1, 1], [1, 1], [1, 1], False, [0, 0], G,
                [need_dx, True, False]), iters=10),
            bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1], bwd_bytes=bwd_bytes)
        msg += (f"; backward: kernel {site['bwd_ms']:.4f} ms, plain {site['bwd_plain_ms']:.4f}, "
                f"cuDNN {site['bwd_library_ms']:.4f}, bound {site['bwd_bound_ms']:.4f} "
                f"({site['bwd_bound_by']})")
    print(msg, flush=True)
    return site


def check_stem():
    """The stem kernels at the two PixelLink++ stem sites (batch 16, 4
    groups), forward and backward, with the planted double rounding
    (``stem_site``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sites = [stem_site(g, name, cin, cout, PL_BATCH, 4, planted=True)
             for name, cin, cout in STEM_SITES]
    torch.cuda.empty_cache()
    return sites


def check_stem_f32():
    """The f32 forward (f32 x and w: the kernel takes three bf16 parts of
    w) at conv1_1's and conv1_2's channels, batch STEM_F32_BATCH, 300 x
    300: within ``STEM_F32_MEAN_TOL`` of the function in f64 (mean error
    over mean value) and within STEM_DW_TOL of max |plain|; a planted
    two-part split must read at least STEM_F32_PLANTED_MIN times the
    limit. The kernel is timed beside its plain version."""
    import torch

    from gssd_torch.ops.kernels import stem_conv as sc

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    B, H, W, G = STEM_F32_BATCH, 300, 300, 4
    limit = sc.STEM_F32_MEAN_TOL
    sites = []
    for name, cin, cout in STEM_SITES:
        x = torch.rand(B, cin, H, W, device="cuda", generator=g)
        w = torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g) * math.sqrt(
            2 / (9 * cin / G))
        b = torch.randn(cout, device="cuda", generator=g) * 0.5
        y = sc.stem_conv_fwd(x, w, b, G)
        torch.cuda.synchronize()
        y64 = sc.stem_conv_fwd_f64(x, w, b, G)
        yp = sc.stem_conv_fwd_plain(x, w, b, G)
        site = dict(site=name, B=B, H=H, W=W, Cin=cin, Cout=cout, G=G, limit=limit,
                    mean_err=sc.f32_mean_err(y, y64),
                    plain_mean_err=sc.f32_mean_err(yp, y64),
                    three_part_plain_mean_err=sc.f32_mean_err(
                        sc.stem_conv_fwd_split(x, w, b, G, 3), y64),
                    planted_two_part_mean_err=sc.f32_mean_err(
                        sc.stem_conv_fwd_split(x, w, b, G, 2), y64),
                    rel_err=((y - yp).abs().max() / yp.abs().max()).item(),
                    ms=time_ms(lambda: sc.stem_conv_fwd(x, w, b, G)),
                    plain_ms=time_ms(lambda: sc.stem_conv_fwd_plain(x, w, b, G), iters=5))
        sites.append(site)
        print(f"stem_conv f32 {name} B={B} {cin}->{cout}: mean err {site['mean_err']:.3g} "
              f"(limit {limit:.3g}; plain f32 conv {site['plain_mean_err']:.3g}, three-part "
              f"emulation {site['three_part_plain_mean_err']:.3g}), planted two-part split "
              f"{site['planted_two_part_mean_err']:.3g}; max rel err {site['rel_err']:.3g}; "
              f"kernel {site['ms']:.4f} ms, plain {site['plain_ms']:.4f}", flush=True)
        check(site["mean_err"] <= limit,
              f"stem_conv f32 {name}: mean err {site['mean_err']} > {limit}")
        check(site["rel_err"] <= STEM_DW_TOL,
              f"stem_conv f32 {name}: rel err {site['rel_err']} > {STEM_DW_TOL}")
        check(site["planted_two_part_mean_err"] >= STEM_F32_PLANTED_MIN * limit,
              f"stem_conv f32 {name}: the planted two-part split reads "
              f"{site['planted_two_part_mean_err']}, below {STEM_F32_PLANTED_MIN} x {limit}")
        del x, y, y64, yp
    return sites


def check_pixellink_sites():
    """The attention and hat DCN kernels at PixelLink++'s shapes (batch
    16): attention at its four site shapes (``attn_site``: N = M = 5625,
    1444 and 361), forward and backward, and the hat DCN at 75 x 75 (512
    -> 256 channels, 4 groups), forward and backward, within KERNEL_TOL of
    its plain version's max and within its rounding contract
    (``dcn_contract``)."""
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    B = PL_BATCH
    attn = []
    for n, dk, dv, count in PL_ATTN_SITES:
        fwd = attn_site(g, B, n, dk, dv, count, False, iters=5, plain_iters=2)
        bwd = attn_site(g, B, n, dk, dv, count, True, iters=3, plain_iters=1)
        attn.append(dict(fwd=fwd, bwd=bwd, N=n, M=n, dk=dk, dv=dv, per_forward=count))
        torch.cuda.empty_cache()

    H = W = 75
    C, G, K, Cout = 512, 4, 9, 256
    x = torch.randn(B, H, W, C, device="cuda", generator=g)
    off = torch.rand(2, B, H, W, G, K, device="cuda", generator=g) * 6 - 3
    m = torch.rand(B, H, W, G, K, device="cuda", generator=g)
    wgt = (torch.rand(K, C, Cout, device="cuda", generator=g) * 2 - 1) / math.sqrt(K * C)
    bias = torch.randn(Cout, device="cuda", generator=g) * 0.1
    py, px = dh.sample_coords(off[0], off[1])
    P = H * W
    args = (x.bfloat16().contiguous(), py.reshape(B, P, G, K).contiguous(),
            px.reshape(B, P, G, K).contiguous(), m.reshape(B, P, G, K).contiguous(),
            wgt.reshape(K, G, C // G, Cout).permute(1, 0, 2, 3).bfloat16().contiguous())
    gout = torch.randn(B, P, Cout, device="cuda", generator=g)
    out = dh.deform_conv_fwd(*args, bias)
    got = dh.deform_conv_bwd(*args, gout)
    torch.cuda.synchronize()
    ref = dh.deform_conv_fwd_plain(*args, bias)
    dcn_fwd_err = (out - ref).abs().max().item()
    check(dcn_fwd_err <= KERNEL_TOL * ref.abs().max().item(),
          f"deform_conv_fwd at 75x75: max err {dcn_fwd_err}")
    want = dh.deform_conv_bwd_plain(*args, gout)
    dcn_bwd_errs = []
    for name, a, b_ in zip(("dpy", "dpx", "dm", "dx", "dwg"), got, want):
        err = (a.float() - b_.float()).abs().max().item()
        dcn_bwd_errs.append(err)
        check(err <= KERNEL_TOL * b_.float().abs().max().item(),
              f"deform_conv_bwd {name} at 75x75: max err {err}")
    contract = dcn_contract(f"hat DCN B={B} 75x75", fwd=((*args, bias), out, ref),
                            bwd=((*args, gout), got, want))
    del ref, want
    ops = 2 * B * P * K * C * Cout
    dcn = dict(
        B=B, H=H, W=W, C=C, G=G, K=K, Cout=Cout, fwd_max_abs_err=dcn_fwd_err,
        bwd_max_abs_err=max(dcn_bwd_errs), contract=contract,
        fwd_ms=time_ms(lambda: dh.deform_conv_fwd(*args, bias), iters=5),
        fwd_plain_ms=time_ms(lambda: dh.deform_conv_fwd_plain(*args, bias), iters=2, warmup=1),
        bwd_ms=time_ms(lambda: dh.deform_conv_bwd(*args, gout), iters=3),
        bwd_plain_ms=time_ms(lambda: dh.deform_conv_bwd_plain(*args, gout), iters=1, warmup=1),
        library_ms=None)
    dcn["fwd_bound_ms"], dcn["fwd_bound_by"] = bound(ops, nbytes_of(*args, bias, out))
    dcn["bwd_bound_ms"], dcn["bwd_bound_by"] = bound(2 * ops, nbytes_of(*args, gout, *got))
    print(f"hat DCN B={B} 75x75 {C}->{Cout} G={G}: fwd kernel {dcn['fwd_ms']:.4f} ms, plain "
          f"{dcn['fwd_plain_ms']:.4f}, bound {dcn['fwd_bound_ms']:.4f}; bwd kernel "
          f"{dcn['bwd_ms']:.4f} ms, plain {dcn['bwd_plain_ms']:.4f}, bound "
          f"{dcn['bwd_bound_ms']:.4f}", flush=True)
    return {"attention": attn, "hat_dcn_75": dcn}


def pl_argv(tmp, data, out, *extra):
    return ["--reference_recipe", "pixellink++", "--synthetic", "True", "--datapath", data,
            "--num_test_subjects", "4", "--load_data_to_ram", "True",
            "--batch_size", str(PL_BATCH), "--device", "cuda", "--compute_dtype", "bfloat16",
            "--seed", str(SEED), "--output", os.path.join(tmp, out), *extra]


def _reset_launches():
    from gssd_torch.ops.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def _launches():
    from gssd_torch.ops.kernels import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def wide_conv(on=True):
    """USE_WIDE_CONV_KERNEL set in-process, as a user of the package sets
    it, for the length of the block."""
    from gssd_torch.ops import layers

    saved = layers.USE_WIDE_CONV_KERNEL
    layers.USE_WIDE_CONV_KERNEL = on
    try:
        yield
    finally:
        layers.USE_WIDE_CONV_KERNEL = saved


class decode_in_turns:
    """While active, every ``mask_to_boxes`` call of the evaluation
    (``ap_iobb``) decodes its logits with the C++ path (whose result it
    returns) and then with the numpy path, each timed; the two must give
    the same boxes and scores, bit for bit."""

    def __init__(self, module):
        self.module, self.real = module, module.mask_to_boxes
        self.native_s, self.numpy_s, self.boxes = [], [], 0

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        scores, boxes = self.real(*args, **kwargs, impl="native")
        t1 = time.perf_counter()
        np_scores, np_boxes = self.real(*args, **kwargs, impl="numpy")
        self.native_s.append(t1 - t)
        self.numpy_s.append(time.perf_counter() - t1)
        check(scores.shape == np_scores.shape and boxes.shape == np_boxes.shape
              and (scores == np_scores).all() and (boxes == np_boxes).all(),
              f"the C++ decode differs from the numpy decode: {len(scores)} against "
              f"{len(np_scores)} boxes")
        self.boxes += len(scores)
        return scores, boxes

    def __enter__(self):
        self.module.mask_to_boxes = self
        return self

    def __exit__(self, *exc):
        self.module.mask_to_boxes = self.real


def pixellink(tmp, data, version="4s"):
    """PixelLink++ (``--version``) through ``gssd_torch.train_pixellink.main``
    with the wide-conv switch on: PL_ITERS train steps (exactly
    PL_STEP_LAUNCHES[version] each, finite losses, the peak memory
    allocated); a run with its evaluation and a checkpoint at iteration
    1; ``--test --checkpoint 1`` (the AP/IoBB keys in [0, 1], exactly
    PL_FORWARD_LAUNCHES[version] per batch); then (4s) as many steps with
    the switch off: no stem_conv launch."""
    import torch

    from gssd_torch import train_pixellink
    from gssd_torch.data import DataSplitter
    from gssd_torch.eval import ap_iobb
    from gssd_torch.native import NATIVE

    tag = f"pixellink++ {version}"
    per_step, per_forward = PL_STEP_LAUNCHES[version], PL_FORWARD_LAUNCHES[version]
    v = ["--version", version]
    with wide_conv():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        res = train_pixellink.main(pl_argv(tmp, data, f"pl_run_{version}", "--max_iter",
                                           str(PL_ITERS), "--speedrun", "100000", *v))
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{tag} training launches over {PL_ITERS} steps: {launches}", flush=True)
        want = {name: per_step.get(name, 0) * PL_ITERS for name in launches}
        check(launches == want, f"{tag}: expected {per_step} per step, got {launches}")
        losses = [r["loss"] for r in res["records"]]
        check(len(losses) == PL_ITERS and all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite or missing losses {losses}")
        median = res["median_step_ms"]
        print(f"{tag} training: median {median:.2f} ms/step after the first step, "
              f"{PL_BATCH / median * 1e3:.1f} slices/s at batch {PL_BATCH}; peak memory "
              f"{peak:.2f} GiB; losses {losses}; "
              f"input wait {[round(r['wait_ms'], 1) for r in res['records']]} ms", flush=True)

        t0 = time.perf_counter()
        ev = train_pixellink.main(pl_argv(tmp, data, f"pl_eval_{version}", "--max_iter", "2",
                                          "--val_every", "1", "--speedrun", "1", *v))
        eval_s = time.perf_counter() - t0
        check([e["iter"] for e in ev["evals"]] == [1] and os.path.exists(ev["weights"]),
              f"{tag}: expected an evaluation and a checkpoint at iteration 1, got "
              f"{ev['evals']}")
        for split in ("valid", "test"):
            r = ev["evals"][0][split]
            check(set(r) == PL_AP_KEYS and all(0.0 <= v <= 1.0 for v in r.values()),
                  f"{tag} {split} AP/IoBB malformed: {r}")

        n_test = len(DataSplitter(data, 1, 4).data_test)
        n_batches = -(-n_test // 16)
        decode = decode_in_turns(ap_iobb)
        _reset_launches()
        native_calls = {k: f.calls for k, f in NATIVE.items()}
        t0 = time.perf_counter()
        with decode:
            tested = train_pixellink.main(pl_argv(tmp, data, f"pl_eval_{version}", "--test",
                                                  "True", "--checkpoint", "1", *v))["test"]
        # --test as it runs: its wall time less the numpy decode run beside it
        test_s = time.perf_counter() - t0 - sum(decode.numpy_s)
        launches_test = _launches()
        native_calls = {k: f.calls - native_calls[k] for k, f in NATIVE.items()}
        check(set(tested) == PL_AP_KEYS and all(0.0 <= v <= 1.0 for v in tested.values()),
              f"{tag} --test AP/IoBB malformed: {tested}")
        want = {name: per_forward.get(name, 0) * n_batches for name in launches_test}
        check(launches_test == want, f"{tag} --test: expected {per_forward} per "
                                     f"batch over {n_batches} batches, got {launches_test}")
        check(native_calls["pixellink_boxes"] == native_calls["pixellink_components"] == n_test
              and native_calls["eval_sweep"] == (len(PL_AP_KEYS) if decode.boxes else 0),
              f"{tag} --test: expected {n_test} C++ decodes and {len(PL_AP_KEYS)} C++ sweeps, "
              f"got {native_calls}")
        cxx_s, numpy_s = sum(decode.native_s), sum(decode.numpy_s)
        print(f"{tag} --test --checkpoint 1: {tested}; {n_test} images in {n_batches} "
              f"batches, {test_s:.2f} s in all ({1e3 * test_s / n_test:.1f} ms/image, model "
              f"build included), of which the C++ host decode {cxx_s:.3f} s "
              f"({1e3 * cxx_s / n_test:.1f} ms/image, {100 * cxx_s / test_s:.1f}% of --test); "
              f"the numpy decode of the same logits, in turns, {numpy_s:.2f} s "
              f"({1e3 * numpy_s / n_test:.1f} ms/image; {100 * numpy_s / (test_s - cxx_s + numpy_s):.1f}% "
              f"of a --test of {test_s - cxx_s + numpy_s:.2f} s with it): the same boxes and "
              f"scores, bit for bit, {decode.boxes} boxes; C++ calls {native_calls}; the "
              f"evaluation run took {eval_s:.2f} s", flush=True)
    out = {"launches": launches, "records": res["records"], "median_step_ms": median,
           "peak_memory_gib": peak, "evaluation": ev["evals"][0], "eval_run_s": eval_s,
           "test": tested, "test_s": test_s, "test_decode_s": cxx_s,
           "test_decode_numpy_s": numpy_s, "test_s_numpy_decode": test_s - cxx_s + numpy_s,
           "test_boxes": decode.boxes, "test_native_calls": native_calls,
           "test_images": n_test, "test_launches": launches_test}
    if version != "4s":
        return out

    # the switch off over as many steps as the switch-on run, so that the
    # two medians compare like with like
    _reset_launches()
    off = train_pixellink.main(pl_argv(tmp, data, "pl_off", "--max_iter", str(PL_ITERS),
                                       "--speedrun", "100000"))
    launches_off = _launches()
    check(launches_off["stem_conv_fwd"] == launches_off["stem_conv_bwd"] == 0
          and launches_off["flash_attn_fwd"] == per_step["flash_attn_fwd"] * PL_ITERS,
          f"pixellink++ with the switch off: expected no stem_conv launch, got {launches_off}")
    median_off = off["median_step_ms"]
    print(f"pixellink++ with the switch off (cuDNN stem): launches {launches_off}; median "
          f"{median_off:.2f} ms/step after the first step over {PL_ITERS} steps (switch on: "
          f"{median:.2f}); steps {[round(r['ms'], 1) for r in off['records']]} ms", flush=True)
    return {**out, "switch_off_launches": launches_off, "switch_off_records": off["records"],
            "switch_off_median_step_ms": median_off}


def pixellink_pallas(tmp, data, version="4s"):
    """PixelLink++ (``--version``) trained with ``--dcn_impl pallas`` (the
    separable sampler at the DCN site: 75x75 for 4s, 150x150 for 2s) and
    the wide-conv switch on: PL_PALLAS_ITERS steps of exactly
    PL_PALLAS_STEP_LAUNCHES[version] each, finite losses, the median
    ms/step and the peak memory allocated printed."""
    import torch

    from gssd_torch import train_pixellink

    per_step = PL_PALLAS_STEP_LAUNCHES[version]
    tag = f"pixellink++ {version} pallas"
    with wide_conv():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        res = train_pixellink.main(pl_argv(tmp, data, f"pl_pallas_{version}", "--max_iter",
                                           str(PL_PALLAS_ITERS), "--speedrun", "100000",
                                           "--dcn_impl", "pallas", "--version", version))
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    want = {name: per_step.get(name, 0) * PL_PALLAS_ITERS for name in launches}
    check(launches == want, f"{tag}: expected {per_step} per step, got {launches}")
    losses = [r["loss"] for r in res["records"]]
    check(len(losses) == PL_PALLAS_ITERS and all(math.isfinite(v) for v in losses),
          f"{tag}: non-finite or missing losses {losses}")
    print(f"pixellink++ {version} --dcn_impl pallas: launches {launches}; median "
          f"{res['median_step_ms']:.2f} ms/step after the first step over {PL_PALLAS_ITERS} "
          f"steps; steps {[round(r['ms'], 1) for r in res['records']]} ms; peak memory "
          f"{peak:.2f} GiB; losses {losses}", flush=True)
    return {"launches": launches, "ms_per_step": [r["ms"] for r in res["records"]],
            "losses": losses, "median_ms_per_step": res["median_step_ms"],
            "peak_memory_gib": peak}


def seeded_pixellink(compute_dtype, seed=SEED, version="4s"):
    """PixelLink++ (``version``) with random weights from ``seed`` that make
    every path contribute, as ``seeded_model`` does for GSSD++."""
    import torch

    from gssd_torch.models.pixellink import PixelLink
    from gssd_torch.ops.deform_conv import DCN
    from gssd_torch.ops.layers import BatchNorm, ConvBNRelu, SelfAttention, SNDense
    from gssd_torch.train_pixellink import parse_args, pixellink_config

    cfg = pixellink_config(parse_args(["--reference_recipe", "pixellink++",
                                       "--version", version]))
    model = PixelLink(cfg, compute_dtype=compute_dtype, dcn_impl="hat", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvBNRelu):
                w = mod.conv.weight
                w.normal_(0, math.sqrt(2 / w[0].numel()), generator=g)
                mod.conv.bias.normal_(0, 0.1, generator=g)
            elif isinstance(mod, BatchNorm):
                mod.running_mean.normal_(0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
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
    return model


def pixellink_batch(data, n, device, version="4s"):
    """n slices of the synthetic set through the eval transform, with
    their pixel/link target maps (``version``), as a device batch."""
    import numpy as np

    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset, collate_pixellink
    from gssd_torch.data.pixellink_targets import make_pixel_link_targets
    from gssd_torch.train.trainer import to_device

    ids = DataSplitter(data, 1, 4).data_cv_train[0][:n]
    ds = LesionDataset(data, ids, transform=BaseTransform(300))
    items = []
    for i in range(n):
        img, boxes, labels = ds[i]
        t = make_pixel_link_targets(np.asarray(boxes), 300, version)
        t["labels"] = labels
        items.append((img, boxes, t))
    return to_device(collate_pixellink(items), device)


def pixellink_parity(data, version="4s"):
    """PixelLink++ (``version``) with the switch on: one image's pixel and
    link logits, bf16 on the card (kernels) against f32 on the CPU (plain
    versions), within E2E_TOL of max |f32|; one train-mode step's loss at
    batch 2 (forward and loss), within TRAIN_LOSS_TOL relative."""
    import torch

    from gssd_torch.train.steps import pixellink_forward_loss

    batch = {dev: pixellink_batch(data, 2, dev, version) for dev in ("cpu", "cuda")}
    outs, losses = {}, {}
    with wide_conv():
        for dtype, dev in (("float32", "cpu"), ("bfloat16", "cuda")):
            model = seeded_pixellink(dtype, version=version).to(dev)
            with torch.inference_mode():
                out = model.eval()(batch[dev]["image"][:1])
            outs[dtype] = {k: out[k].float().cpu() for k in ("pixel", "link")}
            model.train()
            loss, _ = pixellink_forward_loss(model, batch[dev], model.cfg)
            losses[dtype] = loss.item()
            del model
    errs = {}
    for name in ("pixel", "link"):
        ref, got = outs["float32"][name], outs["bfloat16"][name]
        check(bool(torch.isfinite(got).all()), f"pixellink {name}: non-finite bf16 output")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        errs[name] = err / scale
        print(f"pixellink++ {version} parity {name}: max |bf16 card - f32 cpu| = {err:.4g}, max |f32| = "
              f"{scale:.4g}, ratio {err / scale:.4g} (limit {E2E_TOL})", flush=True)
        check(err <= E2E_TOL * scale, f"pixellink {name}: bf16 card vs f32 cpu {err} > "
                                      f"{E2E_TOL} * {scale}")
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    print(f"pixellink++ {version} train loss at batch 2: f32 cpu {losses['float32']:.6g}, bf16 card "
          f"{losses['bfloat16']:.6g}, rel {rel:.4g} (limit {TRAIN_LOSS_TOL})", flush=True)
    check(math.isfinite(losses["bfloat16"]) and rel <= TRAIN_LOSS_TOL,
          f"pixellink train loss bf16 card vs f32 cpu: rel {rel} > {TRAIN_LOSS_TOL}")
    return {"logits_rel_err": errs, "loss_rel": rel, "losses": losses}


# ---- repeatability: fixed-order sums, a deterministic training step ----

# batch of the repeated whole training step (quick; the sums it exercises
# are those of batch 32)
DET_BATCH = 8
DET_TIMED_STEPS = 5


def _same_bits(first, second):
    """Whether two calls' outputs (a tensor, or a tuple of tensors and
    Nones) hold the same bits."""
    import torch

    pairs = zip(first, second) if isinstance(first, tuple) else [(first, second)]
    return all(a is b is None or (a is not None and b is not None and torch.equal(a, b))
               for a, b in pairs)


def repeat_kernels():
    """Each of the nine kernel boundaries twice on the same inputs at its
    training shape (attention at the 12 GSSD++ sites, batch 32; the hat
    DCN and the sampler at the 38x38 site, batch 32, the sampler also at
    the 75x75 site, batch 16; the stem at
    PixelLink++'s conv1_1 and conv1_2, batch 16): every output the same
    bits both times."""
    import torch

    from gssd_torch.ops.kernels import deform_hat as dh
    from gssd_torch.ops.kernels import deform_sample as ds
    from gssd_torch.ops.kernels import flash_attn as fa
    from gssd_torch.ops.kernels import stem_conv as sc

    calls = {}

    def twice(name, fn, *args):
        same = _same_bits(fn(*args), fn(*args))
        check(same, f"{name}: two calls on the same inputs give different bits")
        calls[name] = calls.get(name, 0) + 1

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for n, dk, dv, _ in ATTN_SITES:
        q, k, v, do = attn_inputs(g, TRAIN_BATCH, n, dk, dv)
        twice("flash_attn_fwd", fa.flash_attention_fwd, q, k, v)
        o, lse = fa.flash_attention_fwd(q, k, v)
        twice("flash_attn_bwd", fa.flash_attention_bwd, q, k, v, o, lse, do)
        del q, k, v, do, o, lse
    x, py, px, m, wg, bias = dcn_inputs(TRAIN_BATCH)
    gout = torch.randn(TRAIN_BATCH, py.shape[1], wg.shape[-1], device="cuda", generator=g)
    twice("deform_conv_fwd", dh.deform_conv_fwd, x, py, px, m, wg, bias)
    twice("deform_conv_bwd", dh.deform_conv_bwd, x, py, px, m, wg, gout)
    del x, py, px, m, wg, bias, gout
    a, b, x, gs = sample_inputs(TRAIN_BATCH)
    twice("deform_sample_fwd", ds.abx_fwd, a, b, x)
    twice("deform_sample_dx", ds.abx_dx, a, b, gs)
    twice("deform_sample_dab", ds.abx_dab, x, gs, a, b)
    a, b, x, gs = sample_inputs(PL_BATCH, PL_DCN_SITE)
    twice("deform_sample_fwd", ds.abx_fwd, a, b, x)
    twice("deform_sample_dx", ds.abx_dx, a, b, gs)
    twice("deform_sample_dab", ds.abx_dab, x, gs, a, b)
    del a, b, x, gs
    G = 4
    for name, cin, cout in STEM_SITES:
        x = torch.rand(PL_BATCH, cin, 300, 300, device="cuda", generator=g).bfloat16()
        w = torch.randn(cout, cin // G, 3, 3, device="cuda", generator=g) / math.sqrt(9 * cin / G)
        b = torch.randn(cout, device="cuda", generator=g)
        gout = torch.randn(PL_BATCH, cout, 300, 300, device="cuda", generator=g).bfloat16()
        twice("stem_conv_fwd", sc.stem_conv_fwd, x, w.bfloat16(), b, G)
        twice("stem_conv_bwd", sc.stem_conv_bwd, x, w, gout, G, name != "conv1_1")
        del x, gout
    torch.cuda.synchronize()
    print(f"repeatability: every kernel boundary gave the same bits twice ({calls} shapes)",
          flush=True)
    return calls


def deterministic_step(data):
    """The child of ``deterministic_step_check`` (run with
    CUBLAS_WORKSPACE_CONFIG=:4096:8): under
    torch.use_deterministic_algorithms(True), one ``hat`` GSSD++ training
    step (forward, loss, backward) at batch DET_BATCH from seeded weights,
    twice from the same state (the model's state reloaded: the step
    updates the BN statistics and the spectral-norm vectors) and the same
    batch; then the same without the mode; then the whole step with the
    SGD update timed, DET_TIMED_STEPS times each way. Prints one JSON
    line: the parameters whose gradients differ between the two runs of
    each mode, and the median step ms of each mode."""
    import copy

    import torch

    from gssd_torch.config import LossConfig
    from gssd_torch.train import make_optimizer
    from gssd_torch.train.steps import backward, forward_loss, train_step

    model, priors = seeded_model("bfloat16")
    model = model.to("cuda").train()
    priors = torch.tensor(priors, device="cuda")
    state = copy.deepcopy(model.state_dict())
    batch = fixed_batch(data, DET_BATCH, "cuda")
    opt, ocfg, lcfg = make_optimizer(model, _optim()), _optim(), LossConfig()
    names = [n for n, _ in model.named_parameters()]

    def grads():
        model.load_state_dict(state)
        loss_l, loss_c, _ = forward_loss(model, priors, batch, lcfg)
        return [t.clone() for t in backward(model, opt, loss_l + loss_c)]

    def step_ms():
        times = []
        for i in range(DET_TIMED_STEPS + 1):
            model.load_state_dict(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, priors, batch, lcfg, ocfg, i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times[1:])[DET_TIMED_STEPS // 2]

    out = {}
    for key, mode in (("with_mode", True), ("without_mode", False)):
        torch.use_deterministic_algorithms(mode)
        first, second = grads(), grads()
        out[key] = dict(
            differing=[n for n, a, b in zip(names, first, second) if not torch.equal(a, b)],
            params=len(names), step_ms=step_ms())
    print(json.dumps(out), flush=True)


def child_step(data, *model):
    """The JSON line of ``python3 chip_smoke.py --deterministic-step DATA
    [MODEL]`` run in a child process with CUBLAS_WORKSPACE_CONFIG=:4096:8
    (it must be set before the process first uses cuBLAS)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--deterministic-step",
                           data, *model], env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the repeated step {model} failed (exit {proc.returncode}):\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def deterministic_step_check(data):
    """Runs ``deterministic_step`` in a child process (``child_step``):
    under deterministic algorithms every parameter's gradient must be the
    same bits in both runs."""
    res = child_step(data)
    on, off = res["with_mode"], res["without_mode"]
    print(f"deterministic step (hat, batch {DET_BATCH}): with "
          f"torch.use_deterministic_algorithms(True) {len(on['differing'])} of {on['params']} "
          f"gradients differ between two runs, median step {on['step_ms']:.2f} ms; without "
          f"the mode {len(off['differing'])} differ ({off['differing'][:6]}), median step "
          f"{off['step_ms']:.2f} ms", flush=True)
    check(not on["differing"], f"deterministic step: gradients differ: {on['differing']}")
    return res


# ---- the training input paths on the card ----

# steps of each input path's run, and the iterations its --profile_dir
# trace covers (steps 5-11: past the first steps' allocations and builds)
INPUT_ITERS = 12
INPUT_TRACE = (5, 12)
INPUT_PATHS = {"host": [], "workers": ["--num_workers", "4"],
               "device": ["--aug_method", "device"],
               "device_cached": ["--aug_method", "device_cached"]}
# the device warp (f32 products) against the same warp in f64, images in
# [0, 1]: f32 sums of <= 512 terms read ~1e-7; a TF32 product (10-bit
# mantissa) ~1e-4..1e-3, which must read above it
WARP_TOL = 1e-5
# the exact-resume runs: steps, and the iteration of the checkpoint
RESUME_ITERS, RESUME_AT = 6, 3
# batches of the wire-dtype reading, and the device time a simulated step
# holds the card (cycles of torch.cuda._sleep at ~1.8 GHz: ~190 ms, a
# GSSD++ step at batch 32)
WIRE_BATCHES, WIRE_STEP_CYCLES = 12, 340_000_000


@contextlib.contextmanager
def profile_window(window):
    """The trainer's --profile_dir window set in-process for the block."""
    from gssd_torch.train import trainer

    saved = trainer.PROFILE_WINDOW
    trainer.PROFILE_WINDOW = window
    try:
        yield
    finally:
        trainer.PROFILE_WINDOW = saved


# kernels by origin in a step's trace: the port's own (the __global__
# functions of gssd_torch/csrc), NVIDIA's libraries, PyTorch's own
LIBRARY_KERNELS = ("cudnn", "cutlass", "xmma", "gemm", "gemv", "nvjet", "cublas")


def port_kernel_names():
    import glob
    import re

    names = set()
    for src in glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "gssd_torch", "csrc", "*.cu*")):
        with open(src) as f:
            names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                    r"(\w+)\s*\(", f.read()))
    check(len(names) >= 9, f"found only {sorted(names)} in gssd_torch/csrc")
    return names


def read_trace(path, port_names):
    """From a --profile_dir trace (Chrome JSON): the span of its
    "train_iteration" ranges on the host clock and one minus the union of
    the kernel intervals inside it over that span (the device idle
    share); per iteration the kernels, their ms by origin (the port's,
    NVIDIA's libraries, PyTorch's at::native, other), the host's kernel
    launch calls and its casts (aten::to)."""
    import re

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    iters = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "train_iteration" and e.get("cat") == "user_annotation"]
    check(iters, f"{path}: no train_iteration range in the trace")
    lo, hi = min(a for a, _ in iters), max(b for _, b in iters)
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in kernels)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    check(busy > 0, f"{path}: no kernel inside the traced iterations")
    port = re.compile(r"\b(" + "|".join(sorted(port_names)) + r")\b")
    by_origin = dict.fromkeys(("port", "library", "pytorch", "other"), 0.0)
    for e in kernels:
        name = e["name"]
        origin = ("port" if port.search(name) else
                  "library" if any(k in name.lower() for k in LIBRARY_KERNELS) else
                  "pytorch" if "at::native" in name or "at_cuda_detail" in name else "other")
        by_origin[origin] += e["dur"]
    n = len(iters)
    total = sum(by_origin.values())
    return {"iterations": n, "window_ms": (hi - lo) / 1e3, "kernel_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (hi - lo),
            "kernels_per_iteration": len(kernels) / n,
            "kernel_ms_per_iteration": total / 1e3 / n,
            "kernel_share_by_origin": {k: v / total for k, v in by_origin.items()},
            "launch_calls_per_iteration": sum(1 for e in events if e.get("cat") == "cuda_runtime"
                                              and "Launch" in e.get("name", "")) / n,
            "casts_per_iteration": sum(1 for e in events if e.get("cat") == "cpu_op"
                                       and e.get("name") == "aten::to") / n}


def input_paths(tmp):
    """The hat GSSD++ trainer at batch 32, INPUT_ITERS steps through each
    of INPUT_PATHS, with a --profile_dir trace of INPUT_TRACE: exactly
    ROUTE_LAUNCHES["hat"] a step, finite losses; per path the median
    input wait, step and wall ms (wait + step) after the first step,
    slices/s on the wall clock and the device idle share of the trace."""
    import statistics

    from gssd_torch import train as trainer

    out, port_names = {}, port_kernel_names()
    for name, extra in INPUT_PATHS.items():
        _reset_launches()
        trace_dir = os.path.join(tmp, f"trace_{name}")
        with profile_window(INPUT_TRACE):
            res = trainer.main(train_argv(tmp, "hat", TRAIN_BATCH, INPUT_ITERS, f"input_{name}")
                               + extra + ["--profile_dir", trace_dir])
        launches = _launches()
        want = {k: ROUTE_LAUNCHES["hat"].get(k, 0) * INPUT_ITERS for k in launches}
        check(launches == want, f"input path {name}: launches {launches}, expected {want}")
        recs = res["records"]
        losses = [r["loss"] for r in recs]
        check(len(losses) == INPUT_ITERS and all(math.isfinite(v) for v in losses),
              f"input path {name}: non-finite or missing losses {losses}")
        check(len(res["traces"]) == 1, f"input path {name}: traces {res['traces']}")
        steady = recs[1:]
        wall = [r["wait_ms"] + r["ms"] for r in steady]
        out[name] = dict(
            flags=extra, steps=INPUT_ITERS,
            median_input_wait_ms=statistics.median(r["wait_ms"] for r in steady),
            median_ms_per_step=statistics.median(r["ms"] for r in steady),
            median_wall_ms_per_iteration=statistics.median(wall),
            slices_per_s=TRAIN_BATCH * len(wall) / sum(wall) * 1e3,
            trace=read_trace(res["traces"][0], port_names),
            input_wait_ms=[r["wait_ms"] for r in recs], ms_per_step=[r["ms"] for r in recs],
            losses=losses)
        p, tr = out[name], out[name]["trace"]
        print(f"input path {name} {extra}: median input_wait {p['median_input_wait_ms']:.2f} "
              f"ms, step {p['median_ms_per_step']:.2f} ms, wall "
              f"{p['median_wall_ms_per_iteration']:.2f} ms/iteration, {p['slices_per_s']:.1f} "
              f"slices/s; device idle {tr['idle_share']:.3f} of steps {INPUT_TRACE[0]}-"
              f"{INPUT_TRACE[1] - 1} ({tr['kernel_ms']:.1f} of {tr['window_ms']:.1f} ms); a "
              f"step {tr['kernels_per_iteration']:.0f} kernels, "
              f"{tr['kernel_ms_per_iteration']:.1f} kernel ms by origin "
              + ", ".join(f"{k} {v:.3f}" for k, v in tr["kernel_share_by_origin"].items())
              + f"; {tr['launch_calls_per_iteration']:.0f} launch calls, "
              f"{tr['casts_per_iteration']:.0f} casts", flush=True)
    return out


@contextlib.contextmanager
def recorded_steps(seen, states=None):
    """gssd_torch.train.steps.train_step wrapped in-process for the block:
    each step's batch is kept (a copy on the card) in ``seen`` and, if
    ``states`` is a list, the model's state and momenta before the step
    in ``states``."""
    from gssd_torch.train import steps

    real = steps.train_step

    def recording(model, opt, priors, batch, *a):
        seen.append({k: v.clone() for k, v in batch.items()})
        if states is not None:
            states.append(({k: v.clone() for k, v in model.state_dict().items()},
                           [opt.state[p]["momentum_buffer"].clone()
                            for p in model.parameters() if p in opt.state]))
        return real(model, opt, priors, batch, *a)

    steps.train_step = recording
    try:
        yield
    finally:
        steps.train_step = real


def exact_resume(tmp):
    """With --aug_method device_cached and with --num_workers 2: RESUME_ITERS
    steps with a checkpoint at iteration RESUME_AT, then --resume
    RESUME_AT; the resumed run's batches (image bits, boxes, valid) must
    equal the uninterrupted run's from that iteration on."""
    import torch

    from gssd_torch import train as trainer

    out = {}
    for name, extra in (("device_cached", ["--aug_method", "device_cached"]),
                        ("workers", ["--num_workers", "2"])):
        argv = train_argv(tmp, "hat", TRAIN_BATCH, RESUME_ITERS, f"resume_{name}") + extra
        first, second = [], []
        with recorded_steps(first):
            run = trainer.main(argv + ["--val_every", str(RESUME_AT), "--speedrun",
                                       str(RESUME_AT)])
        with recorded_steps(second):
            resumed = trainer.main(argv + ["--resume", str(RESUME_AT)])
        check(len(first) == RESUME_ITERS and len(second) == RESUME_ITERS - RESUME_AT,
              f"resume {name}: {len(first)} and {len(second)} steps")
        same = [all(torch.equal(a[k], b[k]) for k in ("image", "boxes", "valid"))
                for a, b in zip(first[RESUME_AT:], second)]
        losses = ([r["loss"] for r in run["records"][RESUME_AT:]],
                  [r["loss"] for r in resumed["records"]])
        print(f"exact resume ({name}) at iteration {RESUME_AT}: batches "
              f"{list(range(RESUME_AT, RESUME_ITERS))} the same bits {same}; losses "
              f"uninterrupted {losses[0]}, resumed {losses[1]}", flush=True)
        check(all(same), f"resume {name}: the resumed batches differ from the "
                         f"uninterrupted run's: {same}")
        out[name] = {"same_batches": same, "losses_uninterrupted": losses[0],
                     "losses_resumed": losses[1]}
        del first, second
    return out


def warp_check(data):
    """The device cache's gather-warp on the card at batch 32 (512 -> 300,
    12 channels) against the same warp on the CPU in f64, from one cache
    and one geometry: max abs error within WARP_TOL; the same call with
    TF32 products (allow_tf32 on for that call only) must read above it.
    Times the warp (CUDA events) and the host geometry of 32 items."""
    import numpy as np
    import torch

    from gssd_torch.data import DataSplitter, DeviceCacheLoader, LesionDataset
    from gssd_torch.data.augment_device import hat_matrices, warp

    ids = DataSplitter(data, 1, 4).data_cv_train[0]
    loader = DeviceCacheLoader(LesionDataset(data, ids), TRAIN_BATCH, seed=SEED)
    check(loader.cache.is_cuda, f"the device cache lives on {loader.cache.device}")
    idx = np.asarray(loader._perm.indices_for_batch(0, TRAIN_BATCH), np.int64)
    g = loader._geom
    g.rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    geom, _ = g.sample_batch([loader._boxes[i] for i in idx], [loader._labels[i] for i in idx])
    geometry_ms = (time.perf_counter() - t0) * 1e3
    args = (torch.from_numpy(idx).cuda(), *geom.to("cuda"))

    def gathered():
        return loader._gather_warp(*args)

    got = gathered()
    mat_y, mat_x = hat_matrices(args[1], args[2], args[3], g.size, loader.src_size)
    ref = warp(loader.cache[args[0]].cpu(), mat_y.cpu(), mat_x.cpu(), args[4].cpu(),
               args[5].cpu(), g.mean, g.use_normalize, dtype=torch.float64)
    err = (got.cpu().double() - ref).abs().max().item()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        planted = (gathered().cpu().double() - ref).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ms = time_ms(gathered)
    ops = 2 * TRAIN_BATCH * g.size * loader.src_size * (loader.src_size * 12 + g.size * 12)
    bound_ms = ops / PEAK_F32_OPS * 1e3
    print(f"device warp (batch {TRAIN_BATCH}, {loader.src_size} -> {g.size}): max |f32 card - "
          f"f64 cpu| {err:.3g} (limit {WARP_TOL}); TF32 planted {planted:.3g}; {ms:.3f} ms a "
          f"batch on the card ({ops / 1e9:.1f} GFLOP f32, bound {bound_ms:.3f} ms), "
          f"host geometry {geometry_ms:.2f} ms", flush=True)
    check(err <= WARP_TOL, f"device warp: {err} > {WARP_TOL} against f64")
    check(planted > WARP_TOL, f"device warp: a TF32 warp reads {planted} <= {WARP_TOL}")
    return {"max_abs_err": err, "tf32_planted": planted, "limit": WARP_TOL, "ms": ms,
            "gflop": ops / 1e9, "bound_ms": bound_ms, "geometry_ms": geometry_ms,
            "cache_mib": loader.cache.nbytes / 2**20, "slices": len(ids)}


def wire_dtype_wait(data):
    """The host wait of ``device_prefetch`` with f32 and with bf16 images
    on the wire, on WIRE_BATCHES collated batch-32 batches already in host
    memory (the loader out of the way), each taken while a simulated
    ~190 ms step holds the card, as the trainer takes them: median ms
    blocked on next()."""
    import statistics

    import torch

    from gssd_torch.data import (DataSplitter, LesionDataset, SSDAugmentation, collate,
                                 device_prefetch)

    ids = DataSplitter(data, 1, 4).data_cv_train[0]
    ds = LesionDataset(data, ids, transform=SSDAugmentation(seed=SEED), load_to_ram=True)
    batches = [collate([ds[(b * TRAIN_BATCH + i) % len(ds)] for i in range(TRAIN_BATCH)])
               for b in range(3)]
    out = {}
    for label, cast in (("f32", None), ("bf16", {"image": torch.bfloat16}),
                        ("f32 again", None), ("bf16 again", {"image": torch.bfloat16})):
        it = device_prefetch((batches[n % 3] for n in range(WIRE_BATCHES)), "cuda", cast=cast)
        waits = []
        for _ in range(WIRE_BATCHES):
            t0 = time.perf_counter()
            b = next(it)
            waits.append((time.perf_counter() - t0) * 1e3)
            torch.cuda._sleep(WIRE_STEP_CYCLES)
            b["image"].float().sum()
            torch.cuda.synchronize()
        out[label] = statistics.median(waits[2:])
    print(f"device_prefetch wait at batch {TRAIN_BATCH} (median ms on next()): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


# ---- GSSD++ at 512 (v2_512 anchors, the DCN at 64 x 64) ----

SIZE_512 = 512
# the hat DCN site of the 512 model: slice_and_cat(conv4_3, attn_g) at 64x64
DCN_SITE_512 = dict(H=64, W=64, C=1024, G=4, K=9, Cout=512)
# training steps of each 512 run
ITERS_512 = 5


def record_attention(model, x):
    """The (N, M, dk, dv) of every call of the attention forward boundary
    in one forward of ``model`` on ``x`` (inference mode), in order."""
    import torch

    from gssd_torch.ops.kernels import flash_attn as fa

    seen, real = [], fa.flash_attention_fwd

    def recording(q, k, v):
        seen.append((q.shape[1], k.shape[1], q.shape[2], v.shape[2]))
        return real(q, k, v)

    fa.flash_attention_fwd = recording
    try:
        with torch.inference_mode():
            model(x)
    finally:
        fa.flash_attention_fwd = real
    return seen


def attention_sites(size):
    """(N = M tokens, dk, dv, launches per forward) of every attention
    site of GSSD++ at input ``size``, read off one forward of the seeded
    model at batch 1 on the card through a recording wrapper of the
    forward kernel's boundary; largest N first."""
    import collections

    import torch

    from gssd_torch.ops.kernels import flash_attn as fa

    model, priors = seeded_model("bfloat16", size=size)
    model = model.to("cuda").eval()
    seen = record_attention(model, torch.zeros(1, size, size, 12, device="cuda"))
    counts = collections.Counter(seen)
    sources = len(model.cfg.anchor_config.feature_maps)
    check(all(n == m for n, m, _, _ in counts),
          f"an attention site at {size} has N != M: {sorted(counts)}")
    sites = [(n, dk, dv, c) for (n, _, dk, dv), c in sorted(counts.items(), reverse=True)]
    print(f"attention sites at {size} (N = M, dk, dv, per forward): {sites}; "
          f"{len(priors)} priors", flush=True)
    check(len(seen) == 2 * sources,
          f"{len(seen)} attention calls a forward at {size}, {sources} sources")
    del model
    return sites


def check_512(sites):
    """The attention kernels at the 512 model's sites, as phases 3 and 15
    hold them at 300 (``attn_site``: KERNEL_TOL, the rounding contract
    and its planted faults, timed beside the plain version and SDPA,
    bounded): the forward at the serving batch 8, the backward at the
    training batch 32; and the hat DCN pair at its 64x64 site (batch 8
    and 32, ``check_dcn_bwd``: KERNEL_TOL, ``dcn_contract`` with its
    planted faults, timed, bounded)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    attn = []
    for n, dk, dv, count in sites:
        big = n >= 1024
        fwd = attn_site(g, BATCH, n, dk, dv, count, False, iters=5 if big else 10,
                        plain_iters=2 if big else 5)
        bwd = attn_site(g, TRAIN_BATCH, n, dk, dv, count, True, iters=3 if big else 10,
                        plain_iters=1 if big else 3)
        attn.append(dict(fwd=fwd, bwd=bwd, N=n, M=n, dk=dk, dv=dv, per_forward=count))
        torch.cuda.empty_cache()
    dcn = [check_dcn_bwd(batch, DCN_SITE_512) for batch in (BATCH, TRAIN_BATCH)]
    torch.cuda.empty_cache()
    return {"attention": attn, "hat_dcn_64": dcn}


CACHED_512 = ("device_cached", ["--aug_method", "device_cached"])


def train_512(tmp, attn_per_forward, impl="hat", paths=(CACHED_512, ("host", [])),
              iters=ITERS_512):
    """The trainer CLI at ``--ssd_dim 512`` on the card with DCN route
    ``impl``, ``iters`` steps at the recipe's batch 32 on each input path
    of ``paths`` (by default ``--aug_method device_cached`` and the host
    path, one thread): exactly ROUTE_LAUNCHES[impl] a step with
    ``attn_per_forward`` attention launches each way, finite losses;
    median ms/step, slices/s and the peak memory allocated."""
    import torch

    from gssd_torch import train as trainer

    out, batch = {}, TRAIN_BATCH
    per_step = dict(ROUTE_LAUNCHES[impl], flash_attn_fwd=attn_per_forward,
                    flash_attn_bwd=attn_per_forward)
    for path, extra in paths:
        tag = f"512 training ({impl}, {path})"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        run = f"run512_{path}" if impl == "hat" else f"run512_{impl}_{path}"
        res = trainer.main(train_argv(tmp, impl, batch, iters, run)
                           + ["--ssd_dim", str(SIZE_512)] + extra)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = _launches()
        want = {k: per_step.get(k, 0) * iters for k in launches}
        check(launches == want, f"{tag}: launches {launches}, expected {want}")
        losses = [r["loss"] for r in res["records"]]
        check(len(losses) == iters and all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite or missing losses {losses}")
        median = res["median_step_ms"]
        out[path] = dict(batch=batch, steps=iters, median_ms_per_step=median,
                         slices_per_s=batch / median * 1e3, peak_memory_gib=peak,
                         ms_per_step=[r["ms"] for r in res["records"]],
                         input_wait_ms=[r["wait_ms"] for r in res["records"]], losses=losses,
                         launches=launches)
        print(f"{tag}, batch {batch}: median {median:.2f} ms/step after the "
              f"first, {batch / median * 1e3:.1f} slices/s, median input wait "
              f"{sorted(out[path]['input_wait_ms'][1:])[(iters - 1) // 2]:.1f} ms, peak "
              f"memory {peak:.2f} GiB; launches {launches}; losses {losses}", flush=True)
    return out


def gssd_512(tmp, data):
    """Phase 21: the 512 model's kernel shapes, serving, parity and
    training on the card."""
    t0 = time.perf_counter()
    sites = attention_sites(SIZE_512)
    per_forward = sum(c for *_, c in sites)
    kernels = check_512(sites)
    launches, lat, _, _ = serve(tmp, SIZE_512, data, per_forward)
    parts = breakdown(SIZE_512)
    errs = parity(data, SIZE_512)
    training = train_512(tmp, per_forward)
    return {"attention_sites": sites, "kernels": kernels, "serving_launches": launches,
            "latency_ms_per_image": lat, "breakdown_ms_per_batch": parts,
            "parity_rel_err": errs, "training": training,
            "seconds": time.perf_counter() - t0}


# ---- k-fold cross-validation ----

FOLDS = 5
FOLD_ITERS = 3
FOLD_EVAL_BATCH = 16
INFER_FOLD = 3  # the fold whose checkpoint gssd_torch.infer --fold serves
PL_FOLDS = 2


def _eval_forwards(splitter, eval_batch):
    """Forwards of one evaluation over every fold: a validation-loss batch,
    the fold's validation set and the test set in chunks of eval_batch."""
    test = -(-len(splitter.data_test) // eval_batch)
    return sum(1 + -(-len(ids) // eval_batch) + test for ids in splitter.data_cv_eval)


def folds_phase(tmp):
    """Phase 22. The GSSD++ trainer with ``--cross_validation FOLDS`` at
    batch 32 (``device_cached``, FOLD_ITERS iterations, an evaluation at
    the last): exactly FOLDS x (12 + 12) attention and FOLDS x (1 + 1) hat
    DCN launches an iteration plus the evaluation's forwards, finite
    losses, a checkpoint a fold, the logged means the means of the folds;
    ``--test`` over the folds' checkpoints; ``gssd_torch.infer --fold
    INFER_FOLD`` serving that fold's checkpoint; ``--resume`` restoring every fold's state and its
    next batch bit for bit; PixelLink++ with PL_FOLDS folds, two steps."""
    import torch

    from gssd_torch import infer
    from gssd_torch import train as trainer
    from gssd_torch import train_pixellink
    from gssd_torch.data import DataSplitter, make_synthetic_dataset
    from gssd_torch.parallel.folds import fold_mean

    t0 = time.perf_counter()
    data = os.path.join(tmp, "train_ml")
    out_dir = os.path.join(tmp, "run_folds")
    common = ["--cross_validation", str(FOLDS), "--aug_method", "device_cached",
              "--eval_batch", str(FOLD_EVAL_BATCH)]
    argv = (train_argv(tmp, "hat", TRAIN_BATCH, FOLD_ITERS, "run_folds") + common
            + ["--val_every", str(FOLD_ITERS), "--speedrun", str(FOLD_ITERS - 1)])
    last = FOLD_ITERS - 1
    seen = []
    _reset_launches()
    with recorded_steps(seen):
        res = trainer.main(argv)
    launches = _launches()
    splitter = DataSplitter(data, FOLDS, 4)
    steps, fwd = FOLDS * FOLD_ITERS, _eval_forwards(splitter, FOLD_EVAL_BATCH)
    hat = ROUTE_LAUNCHES["hat"]
    want = {k: 0 for k in launches}
    want.update(flash_attn_fwd=hat["flash_attn_fwd"] * (steps + fwd),
                flash_attn_bwd=hat["flash_attn_bwd"] * steps,
                deform_conv_fwd=steps + fwd, deform_conv_bwd=steps)
    print(f"{FOLDS}-fold training launches over {FOLD_ITERS} iterations and one evaluation "
          f"({fwd} forwards): {launches}", flush=True)
    check(launches == want, f"{FOLDS} folds: launches {launches}, expected {want}")
    recs = res["records"]
    check(len(recs) == FOLD_ITERS and all(len(r["folds"]) == FOLDS and all(
        math.isfinite(f["loss"]) for f in r["folds"]) for r in recs),
        f"{FOLDS} folds: missing or non-finite losses {[r.get('folds') for r in recs]}")
    ev = res["evals"]
    check([e["iter"] for e in ev] == [last], f"{FOLDS} folds: evaluations {ev}")
    paths = [p["checkpoint"] for p in ev[0]["folds"]]
    check([os.path.basename(p) for p in paths]
          == [f"GSSD_plusplus_{last}_CV{f}.pt" for f in range(FOLDS)]
          and all(os.path.exists(p) for p in paths), f"{FOLDS} folds: checkpoints {paths}")
    for split in ("valid", "test"):
        folds = [p[split] for p in ev[0]["folds"]]
        check(all(set(r) == AP_KEYS and all(0 <= v <= 1 for v in r.values()) for r in folds),
              f"{FOLDS} folds {split} AP/IoBB malformed: {folds}")
        check(ev[0][split] == fold_mean(folds),
              f"{FOLDS} folds: the {split} mean {ev[0][split]} is not the folds' mean")
    median_ms, slices = res["median_step_ms"], res["slices_per_s"]
    print(f"{FOLDS} folds at batch {TRAIN_BATCH}: median {median_ms:.2f} ms an "
          f"iteration after the first ({FOLDS} steps), {slices:.1f} slices/s; "
          f"iterations {[round(r['ms'], 1) for r in recs]} ms; mean valid {ev[0]['valid']}, "
          f"test {ev[0]['test']}", flush=True)

    tested = trainer.main(argv + ["--test", "True", "--checkpoint", str(last)])
    check(len(tested["folds"]) == FOLDS and all(
        set(r) == AP_KEYS and all(0 <= v <= 1 for v in r.values()) for r in tested["folds"])
        and tested["test"] == fold_mean(tested["folds"]),
        f"--test over {FOLDS} folds: {tested}")
    same = tested["folds"] == [p["test"] for p in ev[0]["folds"]]
    print(f"--test --checkpoint {last} over {FOLDS} folds: mean {tested['test']}; the same as "
          f"the training run's evaluation: {same}", flush=True)

    _reset_launches()
    served = infer.main(["--reference_recipe", "gssd++", "--datapath", data,
                         "--num_test_subjects", "4", "--cross_validation", str(FOLDS),
                         "--fold", str(INFER_FOLD), "--checkpoint", str(last),
                         "--output", out_dir,
                         "--eval_batch", str(BATCH), "--device", "cuda",
                         "--compute_dtype", "bfloat16",
                         "--det_output", os.path.join(tmp, "detections_fold.json")])
    n_test, infer_launches = len(splitter.data_test), _launches()
    n_fwd = -(-n_test // BATCH)
    check(served["weights"] == paths[INFER_FOLD] and len(served["detections"]) == n_test
          and infer_launches["flash_attn_fwd"] == hat["flash_attn_fwd"] * n_fwd
          and infer_launches["deform_conv_fwd"] == n_fwd,
          f"infer --fold {INFER_FOLD}: weights {served['weights']}, {len(served['detections'])} "
          f"detections, launches {infer_launches}")
    print(f"infer --fold {INFER_FOLD} served {served['weights']}: {n_test} slices, launches "
          f"{infer_launches}", flush=True)

    # --resume: the uninterrupted run's last iteration again, from its
    # checkpoint: each fold's state before the step and its batch
    again, states = [], []
    with recorded_steps(again, states):
        resumed = trainer.main(train_argv(tmp, "hat", TRAIN_BATCH, FOLD_ITERS, "run_folds")
                               + common + ["--resume", str(last), "--speedrun", "100"])
    check(len(again) == FOLDS and [m.step for m in resumed["folds"]] == [FOLD_ITERS + 1] * FOLDS,
          f"--resume: {len(again)} steps, steps {[m.step for m in resumed['folds']]}")
    resume_same = []
    for f, member in enumerate(res["folds"]):
        want_sd = member.model.state_dict()
        got_sd, got_mom = states[f]
        want_mom = [member.optimizer.state[p]["momentum_buffer"]
                    for p in member.model.parameters()]
        state_same = (set(got_sd) == set(want_sd)
                      and all(torch.equal(got_sd[k], v) for k, v in want_sd.items())
                      and len(got_mom) == len(want_mom)
                      and all(torch.equal(a, b) for a, b in zip(got_mom, want_mom)))
        batch_same = all(torch.equal(again[f][k], seen[last * FOLDS + f][k])
                         for k in ("image", "boxes", "valid"))
        resume_same.append({"state": state_same, "batch": batch_same})
    print(f"--resume {last} of {FOLDS} folds: state and next batch the same bits per fold "
          f"{resume_same}", flush=True)
    check(all(r["state"] and r["batch"] for r in resume_same),
          f"--resume of {FOLDS} folds is not exact: {resume_same}")
    del seen, again, states, res, resumed
    torch.cuda.empty_cache()

    pl_data = os.path.join(tmp, "pl_folds_ml")
    make_synthetic_dataset(pl_data, num_subjects=6, slices_per_subject=1, image_size=512,
                           seed=SEED)
    _reset_launches()
    pl = train_pixellink.main(pl_argv(tmp, pl_data, "pl_folds", "--cross_validation",
                                      str(PL_FOLDS), "--num_test_subjects", "1",
                                      "--max_iter", "2", "--val_every", "2", "--speedrun", "1"))
    pl_launches = _launches()
    pl_split = DataSplitter(pl_data, PL_FOLDS, 1)
    pl_steps, pl_fwd = PL_FOLDS * 2, _eval_forwards(pl_split, 16)
    pl_want = {k: 0 for k in pl_launches}
    pl_want.update(flash_attn_fwd=PL_STEP_LAUNCHES["4s"]["flash_attn_fwd"] * pl_steps
                   + PL_FORWARD_LAUNCHES["4s"]["flash_attn_fwd"] * pl_fwd,
                   flash_attn_bwd=PL_STEP_LAUNCHES["4s"]["flash_attn_bwd"] * pl_steps,
                   deform_conv_fwd=pl_steps + pl_fwd, deform_conv_bwd=pl_steps)
    pl_recs, pl_ev = pl["records"], pl["evals"]
    pl_paths = [p["checkpoint"] for p in pl_ev[0]["folds"]] if pl_ev else []
    print(f"pixellink++ {PL_FOLDS} folds: launches {pl_launches}; losses "
          f"{[[f['loss'] for f in r['folds']] for r in pl_recs]}; checkpoints {pl_paths}",
          flush=True)
    check(pl_launches == pl_want, f"pixellink++ folds: launches {pl_launches}, want {pl_want}")
    check(len(pl_recs) == 2 and all(math.isfinite(f["loss"]) for r in pl_recs
                                    for f in r["folds"])
          and len(pl_paths) == PL_FOLDS and all(os.path.exists(p) for p in pl_paths),
          f"pixellink++ folds: records {pl_recs}, checkpoints {pl_paths}")
    return {
        "folds": FOLDS, "batch": TRAIN_BATCH, "iterations": FOLD_ITERS,
        "launches": launches, "eval_forwards": fwd,
        "ms_per_iteration": [r["ms"] for r in recs],
        "input_wait_ms": [r["wait_ms"] for r in recs],
        "fold_losses": [[f["loss"] for f in r["folds"]] for r in recs],
        "median_ms_per_iteration": median_ms, "slices_per_s": slices,
        "evaluation": {"valid": ev[0]["valid"], "test": ev[0]["test"],
                       "folds": [{k: p[k] for k in ("valid", "test")} for p in ev[0]["folds"]]},
        "test": tested, "test_same_as_training_eval": same,
        "infer_fold": {"fold": INFER_FOLD, "weights": served["weights"], "launches": infer_launches},
        "resume_same_bits": resume_same,
        "pixellink": {"folds": PL_FOLDS, "launches": pl_launches,
                      "losses": [[f["loss"] for f in r["folds"]] for r in pl_recs],
                      "checkpoints": pl_paths},
        "seconds": time.perf_counter() - t0}


# ---- PixelLink++ 2s, and GSSD++ 512 on the sampler's routes ----

# the attention site only 2s has: attn_base_0 and attn_0 at conv2_2
# (150 x 150, 128 channels): N = M = 22,500, dk 16, dv 64
PL2_ATTN_SITE = (22500, 16, 64, 2)


def pixellink_2s_sites():
    """The attention sites of PixelLink++ 2s (N = M, dk, dv, per forward),
    read off one forward of the seeded 2s model at batch 1 on the card
    (``record_attention``), largest N first."""
    import collections

    import torch

    model = seeded_pixellink("bfloat16", version="2s").to("cuda").eval()
    with wide_conv():
        seen = record_attention(model, torch.zeros(1, 300, 300, 12, device="cuda"))
    del model
    check(all(n == m for n, m, _, _ in seen), f"a 2s attention site has N != M: {seen}")
    counts = collections.Counter(seen)
    sites = [(n, dk, dv, c) for (n, _, dk, dv), c in sorted(counts.items(), reverse=True)]
    print(f"pixellink++ 2s attention sites (N = M, dk, dv, per forward): {sites}", flush=True)
    check(sorted(sites) == sorted([PL2_ATTN_SITE] + PL_ATTN_SITES),
          f"2s attention sites {sites}: expected {PL2_ATTN_SITE} and phase 15's {PL_ATTN_SITES}")
    return sites


def pl2_repeat_step(data):
    """The child of ``pl2_repeat_check``: under
    torch.use_deterministic_algorithms(True, warn_only=True), one
    PixelLink++ 2s ``hat`` step (forward, loss, backward) at batch 2 from
    seeded weights with the wide-conv switch on, twice from the same
    state (reloaded: the step updates the spectral-norm vectors) and
    batch. Prints one JSON line: the parameters whose gradients differ,
    the launches of both steps, and the operations PyTorch warned have no
    deterministic implementation."""
    import copy
    import warnings

    import torch

    from gssd_torch.train.steps import pixellink_forward_loss

    torch.use_deterministic_algorithms(True, warn_only=True)
    with wide_conv():
        model = seeded_pixellink("bfloat16", version="2s").to("cuda").train()
        state = copy.deepcopy(model.state_dict())
        batch = pixellink_batch(data, 2, "cuda", "2s")
        names = [n for n, _ in model.named_parameters()]

        def grads():
            model.load_state_dict(state)
            model.zero_grad(set_to_none=True)
            loss, _ = pixellink_forward_loss(model, batch, model.cfg)
            loss.backward()
            return [None if p.grad is None else p.grad.clone() for p in model.parameters()]

        _reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            first, second = grads(), grads()
    differing = [n for n, a, b in zip(names, first, second) if not _same_bits((a,), (b,))]
    print(json.dumps({"differing": differing, "params": len(names), "launches": _launches(),
                      "warned": sorted({str(w.message).splitlines()[0][:200] for w in caught})}),
          flush=True)


def pl2_repeat_check(data):
    """Runs ``pl2_repeat_step`` in a child process (``child_step`` with
    pixellink2s): both steps through the hat DCN and attention kernels,
    every gradient the same bits."""
    res = child_step(data, "pixellink2s")
    print(f"pixellink++ 2s hat step at batch 2, twice from the same state: "
          f"{len(res['differing'])} of {res['params']} gradients differ {res['differing'][:6]}; "
          f"launches {res['launches']}; warned {res['warned']}", flush=True)
    check(res["launches"]["deform_conv_bwd"] == 2 and res["launches"]["flash_attn_bwd"] == 20,
          f"the 2s repeated step did not run the hat DCN and attention kernels: "
          f"{res['launches']}")
    check(not res["differing"], f"2s step: gradients differ between two runs: "
                                f"{res['differing']}")
    return res


def pixellink_2s(tmp, data):
    """Phase 23: PixelLink++ 2s on the card: its attention sites, the new
    one held at batch 16 (``attn_site``), the hat DCN pair and the sampler
    at 150x150 (batch 16), training on ``hat`` with its evaluation and
    ``--test`` (``pixellink``), parity with the CPU, a repeated step, and
    training on ``pallas``."""
    import torch

    t0 = time.perf_counter()
    sites = pixellink_2s_sites()
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    attn = []
    for n, dk, dv, count in [PL2_ATTN_SITE]:
        fwd = attn_site(g, PL_BATCH, n, dk, dv, count, False, iters=3, plain_iters=1)
        bwd = attn_site(g, PL_BATCH, n, dk, dv, count, True, iters=3, plain_iters=1)
        attn.append(dict(fwd=fwd, bwd=bwd, N=n, M=n, dk=dk, dv=dv, per_forward=count))
        torch.cuda.empty_cache()
    dcn = check_dcn_bwd(PL_BATCH, PL2_DCN_SITE)
    torch.cuda.empty_cache()
    sample = check_sample((("150", PL_BATCH, PL2_DCN_SITE, True),))
    torch.cuda.empty_cache()
    training = pixellink(tmp, data, "2s")
    parity_res = pixellink_parity(data, "2s")
    repeat = pl2_repeat_check(data)
    pallas = pixellink_pallas(tmp, data, "2s")
    return {"attention_sites": sites, "kernels": {"attention": attn, "hat_dcn_150": dcn,
                                                  "sample_150": sample},
            "training": training, "parity": parity_res, "repeat": repeat, "pallas": pallas,
            "seconds": time.perf_counter() - t0}


def gssd_512_routes(tmp, data, attn_per_forward):
    """Phase 24: GSSD++ at 512 on the sampler's routes: the three
    deform_sample kernels at the 64x64 site (``check_sample``: forward at
    batch 8 and 32, dx and dA/dB at 32), serving on ``pallas`` at batch 8
    with phase 21's weights, and ROUTE_ITERS training steps at batch 32
    on ``pallas`` and ``fused`` (``device_cached``)."""
    import torch

    t0 = time.perf_counter()
    sample = check_sample((("64_b8", BATCH, DCN_SITE_512, False),
                           ("64_b32", TRAIN_BATCH, DCN_SITE_512, True)))
    torch.cuda.empty_cache()
    weights = os.path.join(tmp, f"gssd_pp_{SIZE_512}.pt")
    check(os.path.exists(weights), f"phase 21's 512 weights are missing: {weights}")
    launches, lat = serve_pallas(tmp, data, weights, SIZE_512, attn_per_forward)
    training = {impl: train_512(tmp, attn_per_forward, impl, (CACHED_512,), ROUTE_ITERS)
                for impl in ("pallas", "fused")}
    return {"kernels": {"sample_64": sample}, "serving_launches": launches,
            "latency_ms_per_image": lat, "training": training,
            "seconds": time.perf_counter() - t0}


# ---- the FSSD family with the stem kernels at its trunk; UNet ----

FSSD_TYPES = ("fssd", "groupfssd", "fusedssd")
# launches of one FSSD forward and train step with the wide-conv switch on
FSSD_FORWARD_LAUNCHES = dict(stem_conv_fwd=2)
FSSD_STEP_LAUNCHES = dict(stem_conv_fwd=2, stem_conv_bwd=2)
FSSD_EVAL_BATCH = 16


def check_stem_fssd():
    """The stem kernels at the FSSD trunk's four sites (conv1_1 12 -> 64
    and conv1_2 64 -> 64 at 300 x 300, G = 4 and G = 1): the forward at
    the serving batch 8 and the training batch 32, the backward at 32
    with dW also against its sum in f64 (``stem_site``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    sites = []
    for G in (4, 1):
        for name, cin, cout in STEM_SITES:
            sites.append(stem_site(g, name, cin, cout, BATCH, G, backward=False))
            sites.append(stem_site(g, name, cin, cout, TRAIN_BATCH, G, witness=True))
            torch.cuda.empty_cache()
    return sites


def seeded_fssd(ssd_type, compute_dtype, seed=SEED):
    """An FSSD-family model from ``seed`` with He-scaled convs (the
    trunk's, the fusion's and the transposed conv: activations keep their
    scale through the ReLUs) and every BatchNorm's statistics and affine
    away from (0, 1) and (1, 0), as ``seeded_model`` seeds GSSD++."""
    import torch

    from gssd_torch.config import ModelConfig
    from gssd_torch.models import build_model
    from gssd_torch.ops.layers import BatchNorm, ConvBNRelu

    model, priors = build_model(ModelConfig(ssd_type=ssd_type, compute_dtype=compute_dtype),
                                device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (ConvBNRelu, torch.nn.ConvTranspose2d)):
                w = mod.conv.weight if isinstance(mod, ConvBNRelu) else mod.weight
                fan_in = w[0].numel() if isinstance(mod, ConvBNRelu) else w.shape[0]
                w.normal_(0, math.sqrt(2 / fan_in), generator=g)
            elif isinstance(mod, BatchNorm):
                mod.running_mean.normal_(0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
                mod.weight.uniform_(0.8, 1.2, generator=g)
                mod.bias.normal_(0, 0.1, generator=g)
    return model, priors


def fssd_parity(data, ssd_type):
    """The seeded model in bf16 on the card (stem kernels) against f32 on
    the CPU (plain versions): one image's loc and conf within E2E_TOL of
    max |f32|, and one train-mode step's loss at batch 2 within
    TRAIN_LOSS_TOL relative."""
    import numpy as np
    import torch

    from gssd_torch.config import LossConfig
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.train.steps import forward_loss

    ids = DataSplitter(data, 1, 4).data_test[:1]
    x, _, _ = BaseTransform(300)(LesionDataset(data, ids).pull_image(0))
    xt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(x, (1, 2, 0, 3)).reshape(1, 300, 300, 12)))
    outs, losses = {}, {}
    for dtype, device in (("float32", "cpu"), ("bfloat16", "cuda")):
        model, priors = seeded_fssd(ssd_type, dtype)
        model = model.to(device).eval()
        with torch.inference_mode():
            out = model(xt.to(device))
        outs[dtype] = {k: out[k].float().cpu() for k in ("loc", "conf")}
        model.train()
        with torch.no_grad():
            loss_l, loss_c, _ = forward_loss(model, torch.tensor(priors, device=device),
                                             fixed_batch(data, 2, device), LossConfig())
        losses[dtype] = (loss_l + loss_c).item()
    errs = {}
    for name in ("loc", "conf"):
        ref, got = outs["float32"][name], outs["bfloat16"][name]
        check(bool(torch.isfinite(got).all()), f"{ssd_type} {name}: non-finite bf16 output")
        errs[name] = (got - ref).abs().max().item() / ref.abs().max().item()
        check(errs[name] <= E2E_TOL,
              f"{ssd_type} {name}: bf16 card vs f32 cpu {errs[name]} > {E2E_TOL}")
    errs["loss"] = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    print(f"{ssd_type} parity, bf16 card vs f32 cpu: loc {errs['loc']:.4g}, conf "
          f"{errs['conf']:.4g} (limit {E2E_TOL}); train-mode loss at batch 2 "
          f"{losses['bfloat16']:.6g} vs {losses['float32']:.6g}, rel {errs['loss']:.4g} "
          f"(limit {TRAIN_LOSS_TOL})", flush=True)
    check(math.isfinite(losses["bfloat16"]) and errs["loss"] <= TRAIN_LOSS_TOL,
          f"{ssd_type} train loss bf16 card vs f32 cpu: rel {errs['loss']} > {TRAIN_LOSS_TOL}")
    return errs


def fssd_serve(tmp, data, ssd_type):
    """``gssd_torch.infer --ssd_type`` over the 32 serving slices in
    forwards of 8 from the seeded weights: exactly FSSD_FORWARD_LAUNCHES a
    forward, ms/image after the first batch."""
    import torch

    from gssd_torch import infer

    model, _ = seeded_fssd(ssd_type, "bfloat16")
    weights = os.path.join(tmp, f"{ssd_type}.pt")
    torch.save(model.state_dict(), weights)
    n_batches = 4
    _reset_launches()
    res = infer.main(["--ssd_type", ssd_type, "--datapath", data, "--split", "all",
                      "--num_test_subjects", "2", "--eval_batch", str(BATCH),
                      "--device", "cuda", "--compute_dtype", "bfloat16", "--weights", weights,
                      "--det_output", os.path.join(tmp, f"detections_{ssd_type}.json")])
    launches = _launches()
    want = {k: FSSD_FORWARD_LAUNCHES.get(k, 0) * n_batches for k in launches}
    check(launches == want, f"{ssd_type} serving: launches {launches}, expected {want}")
    check(len(res["detections"]) == BATCH * n_batches, f"{ssd_type}: wrong detection count")
    lat = res["latency_ms"]
    check(len(lat) == n_batches - 1 and all(math.isfinite(t) and t > 0 for t in lat),
          f"{ssd_type}: bad latency record {lat}")
    print(f"{ssd_type} serving (batch {BATCH}): {sum(lat) / len(lat):.3f} ms/image over "
          f"{len(lat)} batches after the first; launches {launches}", flush=True)
    return {"launches": launches, "latency_ms_per_image": lat}


def fssd_train(tmp, data, ssd_type, evaluate=True):
    """``gssd_torch.train --ssd_type`` at batch 32 on ``device_cached``,
    ROUTE_ITERS steps: exactly FSSD_STEP_LAUNCHES a step with the switch
    on (none with it off) plus, with ``evaluate``, FSSD_FORWARD_LAUNCHES a
    forward of the evaluation and checkpoint at the last iteration, then
    ``--test --checkpoint`` (the AP/IoBB keys in [0, 1]); finite losses,
    median ms/step after the first, the peak memory allocated."""
    import torch

    from gssd_torch import train as trainer
    from gssd_torch.data import DataSplitter
    from gssd_torch.ops import layers

    on = layers.USE_WIDE_CONV_KERNEL
    tag = f"{ssd_type} training (switch {'on' if on else 'off'})"
    last = ROUTE_ITERS - 1
    argv = ["--ssd_type", ssd_type, "--datapath", data, "--num_test_subjects", "4",
            "--batch_size", str(TRAIN_BATCH), "--max_iter", str(ROUTE_ITERS),
            "--aug_method", "device_cached", "--device", "cuda", "--compute_dtype",
            "bfloat16", "--seed", str(SEED), "--eval_batch", str(FSSD_EVAL_BATCH),
            "--output", os.path.join(tmp, f"run_{ssd_type}_{'on' if on else 'off'}")]
    argv += (["--val_every", str(last), "--speedrun", str(last)] if evaluate
             else ["--speedrun", "100000"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res = trainer.main(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _launches()
    splitter = DataSplitter(data, 1, 4)
    forwards = _eval_forwards(splitter, FSSD_EVAL_BATCH) if evaluate else 0
    want = {k: (FSSD_STEP_LAUNCHES.get(k, 0) * ROUTE_ITERS
                + FSSD_FORWARD_LAUNCHES.get(k, 0) * forwards) * on for k in launches}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    losses = [r["loss"] for r in res["records"]]
    check(len(losses) == ROUTE_ITERS and all(math.isfinite(v) for v in losses),
          f"{tag}: non-finite or missing losses {losses}")
    median = res["median_step_ms"]
    out = dict(batch=TRAIN_BATCH, steps=ROUTE_ITERS, median_ms_per_step=median,
               slices_per_s=TRAIN_BATCH / median * 1e3, peak_memory_gib=peak,
               ms_per_step=[r["ms"] for r in res["records"]], losses=losses, launches=launches)
    print(f"{tag}, batch {TRAIN_BATCH}, device_cached: median {median:.2f} ms/step after the "
          f"first, {out['slices_per_s']:.1f} slices/s, peak memory {peak:.2f} GiB; launches "
          f"{launches}; losses {losses}", flush=True)
    if not evaluate:
        return out
    check([e["iter"] for e in res["evals"]] == [last] and os.path.exists(res["weights"]),
          f"{tag}: expected an evaluation and a checkpoint at iteration {last}")
    _reset_launches()
    tested = trainer.main(argv + ["--test", "True", "--checkpoint", str(last)])["test"]
    launches_test = _launches()
    n_test = -(-len(splitter.data_test) // FSSD_EVAL_BATCH)
    want = {k: FSSD_FORWARD_LAUNCHES.get(k, 0) * n_test for k in launches_test}
    check(launches_test == want, f"{ssd_type} --test: launches {launches_test}, expected {want}")
    check(set(tested) == AP_KEYS and all(0.0 <= v <= 1.0 for v in tested.values()),
          f"{ssd_type} --test AP/IoBB malformed: {tested}")
    print(f"{ssd_type} --test --checkpoint {last}: {tested}", flush=True)
    return {**out, "evaluation": res["evals"][0]["test"], "test": tested,
            "test_launches": launches_test}


def fssd_family(tmp, data, train_data):
    """Phase 25: the stem kernels at the FSSD trunk's sites; then each of
    fssd, groupfssd and fusedssd with the wide-conv switch on: serving,
    parity and training; groupfssd also trains with the switch off."""
    t0 = time.perf_counter()
    kernels = check_stem_fssd()
    models = {}
    with wide_conv():
        for t in FSSD_TYPES:
            models[t] = {"serving": fssd_serve(tmp, data, t),
                         "parity_rel_err": fssd_parity(train_data, t),
                         "training": fssd_train(tmp, train_data, t)}
    with wide_conv(False):
        off = fssd_train(tmp, train_data, "groupfssd", evaluate=False)
    on_ms = models["groupfssd"]["training"]["median_ms_per_step"]
    print(f"groupfssd ms/step at batch {TRAIN_BATCH}: switch on {on_ms:.2f}, off (cuDNN "
          f"stem) {off['median_ms_per_step']:.2f}", flush=True)
    return {"kernels": kernels, "models": models, "groupfssd_switch_off": off,
            "seconds": time.perf_counter() - t0}


UNET_BATCH = 8       # the JAX trainer's default
UNET_ITERS = 6       # evaluations and checkpoints at iterations 3 and 5
UNET_VAL_EVERY = 3
UNET_F32_TOL = 1e-3  # f32 card (cuDNN, TF32 off) vs f32 CPU: sums in another order


def unet_phase(tmp, data):
    """Phase 26: ``gssd_torch.train_unet`` on the synthetic 512 x 512 set
    with the JAX trainer's defaults (feature_scale 1, batch 8, f32):
    UNET_ITERS steps with validation and a checkpoint every
    UNET_VAL_EVERY and at the last (ms/step, slices/s, peak memory); the
    last checkpoint restored into a fresh model and optimizer must equal
    the trainer's state bit for bit, and ``--resume`` continues from it;
    the f32 forward on the card against f32 on the CPU at batch 1 within
    UNET_F32_TOL of max |ref|, the bf16 forward within E2E_TOL."""
    import numpy as np
    import torch

    from gssd_torch import train_unet
    from gssd_torch.config import OptimConfig
    from gssd_torch.models.unet import UNet
    from gssd_torch.train.checkpoint import restore_checkpoint
    from gssd_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "unet")
    argv = ["--datapath", data, "--output", out_dir, "--batch_size", str(UNET_BATCH),
            "--val_every", str(UNET_VAL_EVERY), "--seed", str(SEED), "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train_unet.main(argv + ["--max_iter", str(UNET_ITERS)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in res["records"]]
    last = UNET_ITERS - 1
    check(len(losses) == UNET_ITERS and all(math.isfinite(v) for v in losses),
          f"unet: non-finite or missing losses {losses}")
    check([e["iter"] for e in res["evals"]] == [UNET_VAL_EVERY, last]
          and all(math.isfinite(e["loss"]) and 0 <= e["pixel_acc"] <= 1
                  and 0 <= e["fg_iou"] <= 1 for e in res["evals"]),
          f"unet: evaluations malformed {res['evals']}")
    median = res["median_step_ms"]
    print(f"unet training (512 x 512, batch {UNET_BATCH}, f32): median {median:.2f} ms/step "
          f"after the first, {res['slices_per_s']:.1f} slices/s, peak memory {peak:.2f} GiB; "
          f"losses {losses}; validation {res['evals']}", flush=True)

    model = UNet(n_classes=2, feature_scale=1, seed=SEED + 7).to("cuda")
    opt = make_optimizer(model, OptimConfig(lr=1e-4, momentum=0.8, stepvalues=()))
    step = restore_checkpoint(model, opt, os.path.join(out_dir, "checkpoints"),
                              "unet_liverseg", last)
    want_sd, want_opt = res["model"].state_dict(), res["optimizer"].state_dict()["state"]
    same = [torch.equal(v, want_sd[k]) for k, v in model.state_dict().items()]
    same_m = [torch.equal(st["momentum_buffer"], want_opt[i]["momentum_buffer"])
              for i, st in opt.state_dict()["state"].items()]
    check(step == UNET_ITERS and all(same) and len(same) == len(want_sd) and all(same_m)
          and len(same_m) == len(list(model.parameters())),
          f"unet restore is not exact: step {step}, {same.count(False)} tensors and "
          f"{same_m.count(False)} momenta differ")
    del model, opt
    resumed = train_unet.main(argv + ["--max_iter", str(UNET_ITERS + 1), "--resume", str(last)])
    check([r["iter"] for r in resumed["records"]] == [last, last + 1]
          and resumed["step"] == UNET_ITERS + 2
          and all(math.isfinite(r["loss"]) for r in resumed["records"]),
          f"unet --resume {last}: records {resumed['records']}, step {resumed['step']}")
    print(f"unet checkpoint {last} restored bit for bit ({len(same)} tensors, {len(same_m)} "
          f"momenta, step {step}); --resume {last}: losses "
          f"{[r['loss'] for r in resumed['records']]}", flush=True)
    steps_ms = [r["ms"] for r in res["records"]]
    del res, resumed

    images, _ = train_unet.load_slices(data)
    x = torch.from_numpy(images[:1])
    outs = {}
    for dtype, device in (("float32", "cpu"), ("float32", "cuda"), ("bfloat16", "cuda")):
        model = UNet(n_classes=2, feature_scale=1, compute_dtype=dtype, seed=SEED).to(device)
        with torch.inference_mode():
            outs[(dtype, device)] = model.eval()(x.to(device)).float().cpu()
    ref = outs[("float32", "cpu")]
    errs = {}
    for key, limit in ((("float32", "cuda"), UNET_F32_TOL), (("bfloat16", "cuda"), E2E_TOL)):
        got = outs[key]
        check(bool(torch.isfinite(got).all()), f"unet {key}: non-finite output")
        errs[key[0]] = (got - ref).abs().max().item() / ref.abs().max().item()
        check(errs[key[0]] <= limit, f"unet {key[0]} card vs f32 cpu: {errs[key[0]]} > {limit}")
    print(f"unet parity at batch 1, 512 x 512, against f32 on the cpu: f32 card "
          f"{errs['float32']:.4g} (limit {UNET_F32_TOL}), bf16 card {errs['bfloat16']:.4g} "
          f"(limit {E2E_TOL})", flush=True)
    return {"batch": UNET_BATCH, "steps": UNET_ITERS, "median_ms_per_step": median,
            "slices_per_s": UNET_BATCH / median * 1e3, "peak_memory_gib": peak,
            "ms_per_step": steps_ms,
            "losses": losses, "parity_rel_err": errs, "seconds": time.perf_counter() - t0}


# ---- the native host library, --visualize, the VOC SSD300 trainer ----

# the AP/IoBB thresholds of the GSSD trainer's evaluation (phase 12)
SWEEP_THRESHOLDS = (0.3, 0.5, 0.7)


def native_phase(tmp):
    """Phase 27: the host library built with g++ from the checkout's
    sources (a fresh build, timed, beside the one the earlier phases
    loaded at first use); phase 12's predictions (its checkpoint 2 over
    the test set through the evaluation's ``collect_predictions``) swept
    with the C++ and the numpy loop at every AP and IoBB threshold: the
    same TP/FP, both timed."""
    import numpy as np
    import torch

    from gssd_torch.config import DetectConfig
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.eval.ap_iobb import collect_predictions, sweep
    from gssd_torch.models import build_model
    from gssd_torch.native import NATIVE, build, compiler_version
    from gssd_torch.train.checkpoint import checkpoint_path, load_weights_partial
    from gssd_torch.train.steps import make_infer_step
    from gssd_torch.train.trainer import model_config, parse_args

    version = compiler_version()
    loaded = build.library_path()
    saved, build.BUILD_DIR = build.BUILD_DIR, os.path.join(tmp, "native_build")
    try:
        t0 = time.perf_counter()
        fresh = build.build()
        build_s = time.perf_counter() - t0
    finally:
        build.BUILD_DIR = saved
    check(os.path.exists(loaded) and os.path.getsize(fresh) > 0,
          f"native library missing: {loaded}, {fresh}")
    print(f"native library: {version}; built from the checkout's sources in {build_s:.2f} s "
          f"({' '.join(build.CXX_FLAGS)}); loaded {os.path.basename(loaded)}", flush=True)

    args = parse_args(train_argv(tmp, "hat", TRAIN_BATCH, ROUTE_ITERS, "run_eval"))
    model, priors = build_model(model_config(args), device="cpu", seed=SEED)
    model = model.to("cuda")
    load_weights_partial(model, checkpoint_path(os.path.join(args.output, "checkpoints"),
                                                args.model_name, 2))
    infer = make_infer_step(model, torch.tensor(priors, device="cuda"), DetectConfig())
    test_set = LesionDataset(args.datapath, DataSplitter(args.datapath, 1, 4).data_test)
    preds, gts = collect_predictions(lambda b: infer(b).cpu().numpy(), test_set,
                                     BaseTransform(300), args.confidence_threshold, 16)
    del model
    calls = NATIVE["eval_sweep"].calls
    times = {"native": 0.0, "numpy": 0.0}
    for metric in ("iou", "iobb"):
        for thr in SWEEP_THRESHOLDS:
            out = {}
            for impl in times:
                t = time.perf_counter()
                out[impl] = sweep(preds, gts, thr, metric, impl=impl)
                times[impl] += time.perf_counter() - t
            (tp, fp, npos), (tp_np, fp_np, npos_np) = out["native"], out["numpy"]
            check(npos == npos_np and tp is not None and np.array_equal(tp, tp_np)
                  and np.array_equal(fp, fp_np),
                  f"C++ sweep differs from numpy at {metric} {thr}")
    sweeps = 2 * len(SWEEP_THRESHOLDS)
    check(NATIVE["eval_sweep"].calls - calls == sweeps,
          f"expected {sweeps} C++ sweeps, got {NATIVE['eval_sweep'].calls - calls}")
    print(f"AP/IoBB sweep over phase 12's {len(preds)} predictions of {len(gts)} test "
          f"slices, {sweeps} thresholds: C++ {1e3 * times['native']:.2f} ms, numpy "
          f"{1e3 * times['numpy']:.2f} ms, the same TP/FP", flush=True)
    return {"compiler": version, "build_s": build_s, "predictions": len(preds),
            "sweeps": sweeps, "sweep_ms": {k: 1e3 * v for k, v in times.items()}}


# launches of one GSSD++ forward (serving, --test, --visualize)
GSSD_FORWARD_LAUNCHES = dict(flash_attn_fwd=12, deform_conv_fwd=1)


def check_dumps(out_dir, n_images, offsets_shape, attn_shape):
    """Every file ``dump_eval_visuals`` names for each test slice; the
    first slice's offsets and attention maps of the expected shapes, the
    maps' rows summing to 1 within bf16 (each entry rounded to 8 bits)."""
    import numpy as np

    from gssd_torch.utils.visualize import dump_names

    want = sorted(n for i in range(n_images) for n in dump_names(i, True, True, True))
    check(sorted(os.listdir(out_dir)) == want,
          f"--visualize files in {out_dir}: {sorted(os.listdir(out_dir))[:8]}..., "
          f"expected {want[:8]}...")
    offs = np.load(os.path.join(out_dir, "00000_offsets.npy"))
    check(offs.shape == offsets_shape and np.isfinite(offs).all(),
          f"offsets {offs.shape}, expected {offsets_shape}")
    sums = {}
    for name in ("attention", "attention_base"):
        a = np.load(os.path.join(out_dir, f"00000_{name}.npy"))
        check(a.shape == attn_shape, f"{name} {a.shape}, expected {attn_shape}")
        dev = float(np.abs(a.astype(np.float64).sum(-1) - 1).max())
        check(dev <= 2.0 ** -8, f"{name}: rows sum to 1 +- {dev}")
        sums[name] = dev
    return {"files": len(want), "offsets": list(offs.shape), "attention": list(attn_shape),
            "row_sum_max_dev": sums}


def visualize_phase(tmp, pl_data):
    """Phase 28: ``--test --checkpoint --visualize`` of GSSD++ 300 ``hat``
    on phase 12's checkpoint and of PixelLink++ 4s (wide-conv switch on)
    on phase 16's: the dump set of every test slice, the shapes, the
    dumped detections equal to the evaluation path's (its inference step,
    or forward and C++ decode, on the same slice alone), and exactly the
    launches of one forward a slice plus one a batch of the evaluation."""
    import numpy as np
    import torch

    from gssd_torch import train_pixellink
    from gssd_torch.config import DetectConfig
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.eval.pixellink_decode import mask_to_boxes
    from gssd_torch.models import build_model
    from gssd_torch.models.pixellink import build_pixellink
    from gssd_torch.train import trainer
    from gssd_torch.train.checkpoint import checkpoint_path, load_weights_partial
    from gssd_torch.train.steps import make_infer_step, make_pixellink_forward

    t0 = time.perf_counter()
    out = {}

    def slice_input(data, idx, size=300):
        test_set = LesionDataset(data, DataSplitter(data, 1, 4).data_test)
        x, _, _ = BaseTransform(size)(test_set.pull_image(idx))
        return np.transpose(x, (1, 2, 0, 3)).reshape(1, size, size, 12).astype(np.float32)

    # GSSD++ on phase 12's checkpoint 2
    argv = train_argv(tmp, "hat", TRAIN_BATCH, ROUTE_ITERS, "run_eval") + [
        "--eval_batch", "16", "--test", "True", "--checkpoint", "2", "--visualize", "True"]
    args = trainer.parse_args(argv)
    n_test = len(DataSplitter(args.datapath, 1, 4).data_test)
    _reset_launches()
    t = time.perf_counter()
    res = trainer.main(argv)
    gssd_s = time.perf_counter() - t
    launches = _launches()
    n_forwards = n_test + -(-n_test // 16)
    want = {k: GSSD_FORWARD_LAUNCHES.get(k, 0) * n_forwards for k in launches}
    check(launches == want, f"gssd++ --visualize: launches {launches}, expected {want}")
    vis = res["visualized"]
    dumps = check_dumps(vis["dir"], n_test, (38, 38, 4, 9, 2), (1444, 1444))
    model, priors = build_model(trainer.model_config(args), device="cpu", seed=SEED)
    model = model.to("cuda")
    load_weights_partial(model, checkpoint_path(os.path.join(args.output, "checkpoints"),
                                                args.model_name, 2), verbose=False)
    infer = make_infer_step(model, torch.tensor(priors, device="cuda"), DetectConfig())
    for idx in (0, n_test - 1):
        got = vis["detections"][idx]
        ref = infer(slice_input(args.datapath, idx))[0].cpu().numpy()
        check(np.array_equal(got, ref), f"gssd++ --visualize detections of slice {idx} "
                                        "differ from the inference step's")
    del model
    out["gssd++"] = {"seconds": gssd_s, "launches": launches, "test": res["test"], **dumps}
    print(f"gssd++ --test --visualize: {n_test} slices dumped in {gssd_s:.2f} s with the "
          f"evaluation; launches {launches}; {dumps}", flush=True)

    # PixelLink++ 4s on phase 16's checkpoint 1
    plv = pl_argv(tmp, pl_data, "pl_eval_4s", "--test", "True", "--checkpoint", "1",
                  "--visualize", "True")
    pargs = train_pixellink.parse_args(plv)
    n_test = len(DataSplitter(pl_data, 1, 4).data_test)
    with wide_conv():
        _reset_launches()
        t = time.perf_counter()
        res = train_pixellink.main(plv)
        pl_s = time.perf_counter() - t
        launches = _launches()
        per = PL_FORWARD_LAUNCHES["4s"]
        want = {k: per.get(k, 0) * (n_test + -(-n_test // 16)) for k in launches}
        check(launches == want, f"pixellink++ --visualize: launches {launches}, expected {want}")
        vis = res["visualized"]
        dumps = check_dumps(vis["dir"], n_test, (75, 75, 4, 9, 2), (5625, 5625))
        plc = train_pixellink.pixellink_config(pargs)
        model = build_pixellink(plc, pargs.cascade_fuse, pargs.batch_norm, "bfloat16", "hat",
                                device="cpu", seed=SEED).to("cuda")
        load_weights_partial(model, checkpoint_path(os.path.join(pargs.output, "checkpoints"),
                                                    pargs.model_name, 1), verbose=False)
        forward = make_pixellink_forward(model, torch.device("cuda"))
        for idx in (0, n_test - 1):
            pix, lnk = forward(slice_input(pl_data, idx))
            scores, boxes = mask_to_boxes(pix[0], lnk[0], 300, plc)
            got = vis["detections"][idx]
            check(np.array_equal(got[1, :len(scores), 0], scores.astype(np.float32))
                  and np.array_equal(got[1, :len(scores), 1:], (boxes / 300).astype(np.float32))
                  and got.shape[1] == max(len(scores), 1),
                  f"pixellink++ --visualize detections of slice {idx} differ from the "
                  "evaluation's forward and decode")
        del model
    out["pixellink++"] = {"seconds": pl_s, "launches": launches, "test": res["test"], **dumps}
    print(f"pixellink++ 4s --test --visualize: {n_test} slices dumped in {pl_s:.2f} s with "
          f"the evaluation; launches {launches}; {dumps}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


VOC_IMAGES = 64      # the synthetic VOCdevkit tree: trainval 64, test its first 32
VOC_ITERS = 6        # an evaluation and a checkpoint at the last
VOC_CLASSES_USED = ("dog", "cat", "person", "car", "bird")


def voc_objects(n=VOC_IMAGES, seed=SEED):
    """{name: objects} and {name: (h, w)} of ``n`` synthetic VOC images of
    280-500 px: 1-3 objects an image of five classes, some difficult,
    every image with one that is not."""
    import numpy as np

    rng = np.random.default_rng(seed)
    objects, sizes = {}, {}
    for i in range(n):
        name = f"{i:06d}"
        h, w = int(rng.integers(280, 500)), int(rng.integers(280, 500))
        sizes[name], objects[name] = (h, w), []
        for k in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(40, w // 2)), int(rng.integers(40, h // 2))
            x1, y1 = int(rng.integers(1, w - bw)), int(rng.integers(1, h - bh))
            objects[name].append((VOC_CLASSES_USED[int(rng.integers(0, 5))],
                                  (x1, y1, x1 + bw, y1 + bh), int(k > 0 and rng.random() < 0.3)))
    return objects, sizes


def voc_phase(tmp):
    """Phase 29: ``python -m gssd_torch.train_voc`` on a synthetic
    VOCdevkit tree: the vanilla SSD300 (3 channels, 21 classes, no BN) at
    batch 32, bf16, VOC_ITERS steps with a VOC mAP evaluation and a
    checkpoint at the last (ms/step, peak memory); a finite mAP in [0, 1];
    the checkpoint restored bit for bit; ``--test --checkpoint`` gives the
    same mAP; the bf16 forward on the card against f32 on the CPU with the
    checkpoint's weights within E2E_TOL; and no launch of the port's
    kernels (this model has no attention, DCN or wide-conv stem)."""
    import numpy as np
    import torch

    from gssd_torch import train_voc
    from gssd_torch.config import OptimConfig
    from gssd_torch.data import BaseTransform
    from gssd_torch.data.voc import VOCDataset, write_voc_tree
    from gssd_torch.models import build_model
    from gssd_torch.train.checkpoint import load_weights_partial, restore_checkpoint
    from gssd_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    root = os.path.join(tmp, "VOCdevkit")
    objects, sizes = voc_objects()
    names = list(objects)
    write_voc_tree(root, objects, sizes, {"trainval": names, "test": names[:VOC_IMAGES // 2]},
                   seed=SEED)
    argv = ["--voc_root", root, "--train_sets", "2007:trainval", "--eval_sets", "2007:test",
            "--batch_size", str(TRAIN_BATCH), "--max_iter", str(VOC_ITERS), "--val_every",
            "100", "--seed", str(SEED), "--output", os.path.join(tmp, "voc"),
            "--device", "cuda"]
    _reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train_voc.main(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in res["records"]]
    last = VOC_ITERS - 1
    check(len(losses) == VOC_ITERS and all(math.isfinite(v) for v in losses),
          f"voc: non-finite or missing losses {losses}")
    mean_ap = res["voc_map"]["map"]
    check([e["iter"] for e in res["evals"]] == [last] and math.isfinite(mean_ap)
          and 0.0 <= mean_ap <= 1.0, f"voc: evaluation malformed {res['evals']}")
    median = res["median_step_ms"]
    print(f"voc ssd300 training (batch {TRAIN_BATCH}, bf16): median {median:.2f} ms/step "
          f"after the first, {TRAIN_BATCH / median * 1e3:.1f} images/s, peak memory "
          f"{peak:.2f} GiB; losses {losses}; VOC mAP {res['voc_map']}", flush=True)

    args = train_voc.parse_args(argv)
    ckpt_dir = os.path.join(args.output, "checkpoints")
    model, _ = build_model(train_voc.model_config(args), device="cpu", seed=SEED + 7)
    model = model.to("cuda")
    opt = make_optimizer(model, OptimConfig(lr=args.lr, momentum=args.momentum,
                                            weight_decay=args.weight_decay))
    step = restore_checkpoint(model, opt, ckpt_dir, args.model_name, last)
    want_sd, want_opt = res["model"].state_dict(), res["optimizer"].state_dict()["state"]
    same = [torch.equal(v, want_sd[k]) for k, v in model.state_dict().items()]
    same_m = [torch.equal(st["momentum_buffer"], want_opt[i]["momentum_buffer"])
              for i, st in opt.state_dict()["state"].items()]
    check(step == VOC_ITERS and all(same) and len(same) == len(want_sd) and all(same_m)
          and len(same_m) == len(list(model.parameters())),
          f"voc restore is not exact: step {step}, {same.count(False)} tensors and "
          f"{same_m.count(False)} momenta differ")
    del model, opt, res["model"], res["optimizer"]
    tested = train_voc.main(argv + ["--test", "True", "--checkpoint", str(last)])["voc_map"]
    check(tested == res["voc_map"], f"voc --test: {tested} against the run's {res['voc_map']}")

    raw = VOCDataset(root, [("2007", "test")]).pull_image(0)[None]
    x, _, _ = BaseTransform(300, args.means, False, args.use_normalize)(raw)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0, 3).reshape(1, 300, 300, 3)))
    outs = {}
    for dtype, device in (("float32", "cpu"), ("bfloat16", "cuda")):
        args.compute_dtype = dtype
        model, _ = build_model(train_voc.model_config(args), device="cpu", seed=SEED)
        load_weights_partial(model, os.path.join(ckpt_dir, args.model_name,
                                                 f"{args.model_name}_{last}_CV0.pt"),
                             verbose=False)
        with torch.inference_mode():
            out = model.to(device).eval()(xt.to(device))
        outs[dtype] = {k: out[k].float().cpu() for k in ("loc", "conf")}
    errs = {}
    for name in ("loc", "conf"):
        ref, got = outs["float32"][name], outs["bfloat16"][name]
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= E2E_TOL * scale,
              f"voc {name}: bf16 card vs f32 cpu {err} > {E2E_TOL} * {scale}")
        errs[name] = err / scale
    launches = _launches()
    check(not any(launches.values()), f"voc: the port's kernels launched: {launches}")
    print(f"voc checkpoint {last} restored bit for bit ({len(same)} tensors, {len(same_m)} "
          f"momenta, step {step}); --test --checkpoint {last}: mAP {tested['map']:.4f}; bf16 "
          f"card vs f32 cpu {errs}; no kernel launch (no attention, DCN or wide stem)",
          flush=True)
    return {"batch": TRAIN_BATCH, "steps": VOC_ITERS, "ms_per_step": [r["ms"] for r in
                                                                      res["records"]],
            "median_ms_per_step": median, "peak_memory_gib": peak, "losses": losses,
            "voc_map": res["voc_map"], "test_map": tested["map"], "parity_rel_err": errs,
            "launches": launches, "seconds": time.perf_counter() - t0}


DROP_SUBJECTS = 6     # the trainer's one fold holds out 20% of the training subjects: >= 5
DROP_SLICES = 16      # a subject's z (16 or 17), the same in its four phases
DROP_LESION_Z = (3, 13)  # lesion slices 3..12: ten interior slices a subject
DROP_PIVOTS = ("P", "A", "D", "Pre", "P", "A")  # the annotated phase of each subject
DROP_ITERS = 3


def drop_series_reader(directory, pattern):
    """The synthetic drop's DICOM series: one ``<phase>_vol.npy`` volume a
    phase directory, through ``build_snuh_dataset``'s ``series_reader``
    (the port reads DICOM with the optional pydicom)."""
    import numpy as np

    return np.load(os.path.join(directory, pattern.split("*")[0] + "vol.npy"))


def write_raw_drop(root, seed=SEED):
    """A synthetic SNUH raw drop at the clinical size, in the layout of
    ``gssd_torch/preprocessing/snuh.py``: DROP_SUBJECTS subjects with A, D,
    P and Pre volumes of 512 x 512 int16 HU values (a body, a liver and
    the lesions over noise), lesions over the DROP_LESION_Z slices of the
    pivot phase, uint8 ``segmentation_mask/<id>_<phase>.raw`` masks with
    the pivot's z-delta of extra leading slices (subject 0 has two
    lesions: ``<id>_<phase>1.raw`` and ``2.raw``), and metadata.txt with
    non-zero deltas. Returns {subject: (pivot phase, lesion slices)}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:512]

    def ellipse(cy, cx, ry, rx):
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1

    os.makedirs(os.path.join(root, "segmentation_mask"))
    rows, subjects = [], {}
    lo, hi = DROP_LESION_Z
    for s in range(DROP_SUBJECTS):
        subject, mask_id, pivot = f"HCC_{1100 + s}", f"A{s + 1}", DROP_PIVOTS[s]
        z = DROP_SLICES + s % 2
        deltas = [(s + k) % 4 + 1 for k in range(4)]  # A, D, P, Pre: all non-zero
        lesions = [ellipse(*rng.uniform(200, 300, 2), *rng.uniform(18, 34, 2))
                   for _ in range(2 if s == 0 else 1)]
        body = np.where(ellipse(256, 256, 200, 230), 40, -1000).astype(np.int16)
        body[ellipse(230, 200, 110, 130)] = 60  # the liver
        for phase in ("A", "D", "P", "Pre"):
            vol = np.repeat(body[:, :, None], z, axis=2)
            for lesion in lesions:
                vol[lesion, lo:hi] = 20 + 15 * ("A", "D", "P", "Pre").index(phase)
            vol += rng.integers(-25, 26, vol.shape, dtype=np.int16)
            d = os.path.join(root, "dicom_image", subject, phase)
            os.makedirs(d)
            np.save(os.path.join(d, f"{phase}_vol.npy"), vol)
        delta = deltas[("A", "D", "P", "Pre").index(pivot)]
        for i, lesion in enumerate(lesions):
            m = np.zeros((z + delta, 512, 512), np.uint8)
            m[lo + delta:hi + delta, lesion] = 1
            suffix = str(i + 1) if len(lesions) > 1 else ""
            m.tofile(os.path.join(root, "segmentation_mask", f"{mask_id}_{pivot}{suffix}.raw"))
        rows.append("\t".join([subject, *map(str, deltas), pivot, mask_id]))
        subjects[subject] = (pivot, hi - lo)
    with open(os.path.join(root, "metadata.txt"), "w") as f:
        f.write("ID\tDelta_A\tDelta_D\tDelta_P\tDelta_Pre\tMask_Phase\tMask_ID\n"
                + "\n".join(rows) + "\n")
    return subjects


def raw_drop_phase(tmp, harness):
    """Phase 30, a raw drop to a trained checkpoint: a synthetic SNUH raw
    drop at 512 x 512 (``write_raw_drop``) built into ml_ready by
    ``gssd_torch.preprocessing.snuh.build_snuh_dataset`` (the sample and
    metadata counts; every ``_ct.npy`` [4, 3, 512, 512] f32 in [0, 1];
    every box inside 512 x 512 with class 0; each sample's phase token its
    subject's pivot phase; seconds a subject, bytes written), then the
    GSSD++ trainer on it at batch 32 (``hat``, bf16, DROP_ITERS steps with
    an evaluation and a checkpoint at the last): finite losses, AP/IoBB in
    [0, 1], exactly phase 12's 12 + 12 attention and 1 + 1 hat DCN
    launches a step plus one forward's an evaluation batch, ms/step beside
    phase 12's; and ``--test --checkpoint`` (one forward's launches a test
    batch). The legacy v1 h5 round trip (``legacy_v1.write_v1_h5``,
    ``gssd_torch.data.legacy_h5``) needs h5py, which this script does not
    require: tests/test_torch_legacy_h5.py holds it to the JAX package."""
    import numpy as np

    from gssd_torch import train as trainer
    from gssd_torch.data import DataSplitter
    from gssd_torch.preprocessing.snuh import PHASE_TOKEN, build_snuh_dataset

    t0 = time.perf_counter()
    drop, ml = os.path.join(tmp, "raw_drop"), os.path.join(tmp, "raw_drop_ml")
    subjects = write_raw_drop(drop)
    write_s = time.perf_counter() - t0
    t = time.perf_counter()
    lines = build_snuh_dataset(drop, ml, img_size=512, series_reader=drop_series_reader)
    build_s = time.perf_counter() - t
    want = sum(n for _, n in subjects.values())
    with open(os.path.join(ml, "metadata.txt")) as f:
        meta = [line for line in f.read().splitlines() if line]
    check(len(lines) == want and meta == lines,
          f"raw drop: {len(lines)} samples and {len(meta)} metadata lines, expected {want}")
    n_boxes = 0
    for line in lines:
        rel, subject = line.split("|")
        base = os.path.join(ml, rel)
        ct = np.load(base + "_ct.npy")
        check(ct.shape == (4, 3, 512, 512) and ct.dtype == np.float32
              and 0.0 <= ct.min() and ct.max() <= 1.0,
              f"{rel}: ct {ct.shape} {ct.dtype} in [{ct.min()}, {ct.max()}]")
        b = np.load(base + "_bbox.npy")
        check(b.ndim == 2 and b.shape[0] >= 1 and b.shape[1] == 5
              and (b[:, :2] >= 0).all() and (b[:, 2:4] <= 512).all()
              and (b[:, 2:4] > b[:, :2]).all() and (b[:, 4] == 0).all(), f"{rel}: boxes {b}")
        n_boxes += len(b)
        token = np.load(base + "_phase.npy")
        check(token.shape == () and token.dtype == np.int64
              and int(token) == PHASE_TOKEN[subjects[subject][0]],
              f"{rel}: phase token {token!r}, pivot {subjects[subject][0]}")
    nbytes = sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(ml) for n in ns)
    ct_bytes = sum(os.path.getsize(os.path.join(ml, line.split("|")[0] + "_ct.npy"))
                   for line in lines)
    print(f"raw drop -> ml_ready: {len(subjects)} subjects, {len(lines)} samples, {n_boxes} "
          f"boxes in {build_s:.2f} s ({build_s / len(subjects):.3f} s a subject; the drop "
          f"written in {write_s:.2f} s), {nbytes} bytes written ({ct_bytes} of _ct.npy)",
          flush=True)

    argv = ["--reference_recipe", "gssd++", "--datapath", ml, "--num_test_subjects", "1",
            "--batch_size", str(TRAIN_BATCH), "--dcn_impl", "hat", "--compute_dtype",
            "bfloat16", "--device", "cuda", "--seed", str(SEED), "--load_data_to_ram", "True",
            "--max_iter", str(DROP_ITERS), "--val_every", "2", "--speedrun", "2",
            "--eval_batch", "16", "--output", os.path.join(tmp, "run_raw_drop")]
    splitter = DataSplitter(ml, 1, 1)
    fwd, steps = _eval_forwards(splitter, 16), DROP_ITERS
    hat = ROUTE_LAUNCHES["hat"]
    _reset_launches()
    t = time.perf_counter()
    res = trainer.main(argv)
    train_s = time.perf_counter() - t
    launches = _launches()
    want = {k: hat.get(k, 0) * steps + GSSD_FORWARD_LAUNCHES.get(k, 0) * fwd for k in launches}
    check(launches == want, f"raw drop training: launches {launches}, expected {want}")
    losses = [r["loss"] for r in res["records"]]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"raw drop training: losses {losses}")
    evals = res["evals"]
    check([e["iter"] for e in evals] == [steps - 1] and all(
        set(evals[0][s]) == AP_KEYS and all(0.0 <= v <= 1.0 for v in evals[0][s].values())
        for s in ("valid", "test")), f"raw drop evaluation: {evals}")
    median = res["median_step_ms"]
    print(f"raw drop training at batch {TRAIN_BATCH}: median {median:.2f} ms/step after the "
          f"first (phase 12 on the synthetic set: {harness['median_step_ms']:.2f}); losses "
          f"{losses}; {launches} launches over {steps} steps and {fwd} evaluation forwards; "
          f"valid {evals[0]['valid']}, test {evals[0]['test']}", flush=True)

    n_test = -(-len(splitter.data_test) // 16)
    _reset_launches()
    tested = trainer.main(argv + ["--test", "True", "--checkpoint", str(steps - 1)])["test"]
    test_launches = _launches()
    want = {k: GSSD_FORWARD_LAUNCHES.get(k, 0) * n_test for k in test_launches}
    check(test_launches == want, f"raw drop --test: launches {test_launches}, expected {want}")
    check(set(tested) == AP_KEYS and all(0.0 <= v <= 1.0 for v in tested.values()),
          f"raw drop --test: {tested}")
    seconds = time.perf_counter() - t0
    print(f"raw drop --test --checkpoint {steps - 1}: {tested}; phase 30 took {seconds:.1f} s",
          flush=True)
    return {"subjects": len(subjects), "samples": len(lines), "boxes": n_boxes,
            "write_s": write_s, "build_s": build_s, "build_s_per_subject":
            build_s / len(subjects), "bytes_written": nbytes, "ct_bytes": ct_bytes,
            "batch": TRAIN_BATCH, "steps": steps, "losses": losses,
            "ms_per_step": [r["ms"] for r in res["records"]], "median_ms_per_step": median,
            "phase12_median_ms_per_step": harness["median_step_ms"], "train_s": train_s,
            "evaluation": evals[0], "test": tested, "launches": launches,
            "test_launches": test_launches, "seconds": seconds}


# ---- phase 31: data parallelism, one process a rank ----

# Two ranks against one at the same global batch, f32 (TF32 off), each
# step from the one-rank run's state before it: the loss within DP_TOL
# relative; the parameters and spectral vectors and the BatchNorm running
# statistics after the step each within DP_TOL of their norm over the
# model (relative L2; the parameters whose gradient is 0 in exact
# arithmetic, ``_structural_zero``, left out); the momenta (the step's
# gradient) within DP_GRAD_TOL; the ranks bit-equal. The f32 gradient of
# this model is a near-cancelling sum: one rank fed its own batch with the
# rows reversed (the same function in exact arithmetic) moves it by
# 2.2-3.1e-2 (relative L2) and moves ~150-200 of 660 tensors by more than
# DP_TOL of their max |value|, and two ranks read 2.3-6.1e-2 (PERF.md, PR
# 17), so no split can hold a tensor's max |diff| to DP_TOL; the reversal
# is run and printed beside the split. Two planted faults must fail the
# checks: BatchNorm statistics over a rank's rows alone, and the MultiBox
# normaliser over a rank's positives alone (each moves the momenta by
# ~1.2 and the parameters by ~8e-4 on the CPU at batch 4)
DP_TOL = 1e-4
DP_GRAD_TOL = 0.2
DP_BATCH = 8
DP_ITERS = 3


def dp_steps(rank, batches, starts=None):
    """Rank body of phase 31 (a module-level function: the spawned ranks
    unpickle it from this file): GSSD++ 300 at full width on ``hat`` as
    the trainer initialises it from SEED, f32 with TF32 off, one SGD step on the rank's rows
    of each host batch; step s starts from ``starts[s]`` (a model state and
    momenta; None: where step s - 1 left it) -> the losses, each step's
    resulting state and momenta on the host, and ms a step (synchronised,
    host clock)."""
    import torch

    from gssd_torch.config import LossConfig
    from gssd_torch.train.optim import make_optimizer
    from gssd_torch.train.steps import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank.device
    model, priors = recipe_model("float32")
    model = model.to(device)
    priors = torch.tensor(priors, device=device)
    opt, ocfg = make_optimizer(model, _optim()), _optim()
    params = dict(model.named_parameters())
    rows = rank.rows or slice(None)
    losses, ms, after = [], [], []
    for step, batch in enumerate(batches):
        start = starts[step] if starts else None
        if start is not None:
            model.load_state_dict(start["state"])
            for name, buf in start["momenta"].items():
                opt.state[params[name]]["momentum_buffer"] = buf.to(device).clone()
        b = {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m = train_step(model, opt, priors, b, LossConfig(), ocfg, step)
        losses.append(float(m["loss"]))  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
        after.append({"state": {k: v.cpu().clone() for k, v in model.state_dict().items()},
                      "momenta": {n: opt.state[p]["momentum_buffer"].cpu().clone()
                                  for n, p in params.items()}})
    return {"losses": losses, "ms": ms, "after": after}


def _tensor_errs(want, got, model):
    """{name: (kind, max |got - want| / max |want|)} over a step's state
    and momenta; kind "param", "stat", "momentum" or "structural_zero"."""
    params = dict(model.named_parameters())
    out = {}
    for part, kind in (("state", "param"), ("momenta", "momentum")):
        for name, w in want[part].items():
            if not w.is_floating_point():
                continue
            k = kind
            if name in params and _structural_zero(name, model, model.cfg):
                k = "structural_zero"
            elif ".running_" in name:
                k = "stat"
            err = float((got[part][name] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            out[f"{part}:{name}"] = (k, err)
    return out


def _l2_errs(want, got, model):
    """{kind: ||got - want|| / ||want||} over the model's tensors of each
    kind (the structural zeros left out)."""
    import torch

    sums = {}
    errs = _tensor_errs(want, got, model)
    for key, (kind, _) in errs.items():
        if kind == "structural_zero":
            continue
        part, name = key.split(":", 1)
        w = want[part][name].double()
        d, n = sums.get(kind, (0.0, 0.0))
        sums[kind] = (d + float(torch.sum((got[part][name].double() - w) ** 2)),
                      n + float(torch.sum(w * w)))
    return {kind: math.sqrt(d / n) for kind, (d, n) in sums.items()}


def dp_planted(rank, batches):
    """Rank body: the first step of ``dp_steps`` twice, each with a
    planted fault -> {fault: the result}: "bn_local", BatchNorm
    statistics over the rank's rows alone; "loss_local", the MultiBox
    normaliser over the rank's positives alone."""
    import gssd_torch.ops.layers as layers
    import gssd_torch.ops.losses as losses

    out = {}
    for fault, mod, name, fake in (("bn_local", layers, "group_size", lambda: 1),
                                   ("loss_local", losses, "all_reduce_", lambda t: t)):
        real = getattr(mod, name)
        setattr(mod, name, fake)
        try:
            out[fault] = dp_steps(rank, batches[:1])
        finally:
            setattr(mod, name, real)
    return out


def dp_compare(one, rev, ranks, label):
    """The ranks of a run against the one-rank run (``one``), step by step
    (see DP_TOL; ``rev``: the one-rank run on reversed rows, from the same
    states), and against each other (bit for bit) -> the readings."""
    import torch

    model, _ = recipe_model("float32")
    res = {"losses_1_rank": one["losses"], "losses_reversed_rows": rev["losses"],
           "losses": [r["losses"] for r in ranks], "steps": []}
    for s in range(len(one["losses"])):
        want = one["after"][s]
        loss_err = max(abs(r["losses"][s] - one["losses"][s]) / abs(one["losses"][s])
                       for r in ranks)
        l2 = _l2_errs(want, ranks[0]["after"][s], model)
        spread = _tensor_errs(want, rev["after"][s], model)
        errs = _tensor_errs(want, ranks[0]["after"][s], model)
        spread_l2 = _l2_errs(want, rev["after"][s], model)
        bit_equal = all(torch.equal(ranks[0]["after"][s][part][k], r["after"][s][part][k])
                        for r in ranks[1:] for part in ("state", "momenta")
                        for k in ranks[0]["after"][s][part])

        def over(e):
            return sum(1 for kind, x in e.values() if kind != "structural_zero" and x > DP_TOL)

        def worst(e):
            key = max((k for k, (kind, _) in e.items() if kind != "structural_zero"),
                      key=lambda k: e[k][1])
            return [key, e[key][1]]

        step = {"loss_rel_err": loss_err, "l2_rel_err": l2, "l2_rel_err_reversed_rows": spread_l2,
                "tensors": len(errs), "tensors_over_tol": over(errs),
                "tensors_over_tol_reversed_rows": over(spread), "worst": worst(errs),
                "worst_reversed_rows": worst(spread), "ranks_bit_equal": bit_equal}
        res["steps"].append(step)
        print(f"data parallelism ({label}), step {s}: loss rel err {loss_err:.3e}; relative "
              f"L2 {', '.join(f'{k} {v:.3e}' for k, v in l2.items())} (one rank on reversed "
              f"rows: {', '.join(f'{k} {v:.3e}' for k, v in spread_l2.items())}); tensors "
              f"beyond DP_TOL of their max: {step['tensors_over_tol']} of {len(errs)} (reversed "
              f"rows {step['tensors_over_tol_reversed_rows']}), worst {step['worst']} (reversed "
              f"rows {step['worst_reversed_rows']}); ranks bit-equal {bit_equal} (limit "
              f"{DP_TOL}, momenta {DP_GRAD_TOL})", flush=True)
        check(loss_err <= DP_TOL, f"{label} step {s}: loss {res['losses']} vs {one['losses']}")
        for kind, err in l2.items():
            limit = DP_GRAD_TOL if kind == "momentum" else DP_TOL
            check(err <= limit, f"{label} step {s}: {kind} relative L2 {err:.3e} > {limit:.3e}")
        check(bit_equal, f"{label} step {s}: the ranks' state or momenta differ")
    res["ms_per_step"] = [r["ms"] for r in ranks]
    res["ms_per_step_1_rank"] = one["ms"]
    return res


def dp_infer(rank, weights, data, eval_batch, tail_piece=None):
    """Rank body of phase 31's split evaluation: GSSD++ 300 bf16 on
    ``hat`` from the checkpoint ``weights``, every image of the synthetic
    set ``data`` (its test, validation and training ids) through
    ``plan_infer_step`` at ``eval_batch`` -> the detections [n, C, K, 5]
    on the host, the seconds of that evaluation (the host transform, the
    forwards and the gathers, synchronised), then of the same forwards
    again on the transformed chunks, their launches, and whether the two
    passes gave the same bits. With ``tail_piece``, the last chunk runs in
    pieces of that many rows: the shapes that ranks splitting it give it."""
    import torch

    from gssd_torch.config import DetectConfig
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.eval.ap_iobb import _stream_batches
    from gssd_torch.parallel.mesh import plan_infer_step
    from gssd_torch.train.checkpoint import load_weights_partial
    from gssd_torch.train.steps import make_infer_step

    device = rank.device
    model, priors = recipe_model("bfloat16")
    model = model.to(device)
    load_weights_partial(model, weights, verbose=False)
    step = plan_infer_step(make_infer_step(model, torch.tensor(priors, device=device),
                                           DetectConfig(num_classes=2)), rank, eval_batch)
    sp = DataSplitter(data, 1, 4)
    dataset = LesionDataset(data, sp.data_test + sp.data_cv_eval[0] + sp.data_cv_train[0])
    tf = BaseTransform(300, 0.0, False, True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(batch, last):
        if last and tail_piece:
            return torch.cat([step(batch[i:i + tail_piece])
                              for i in range(0, len(batch), tail_piece)])
        return step(batch)

    chunks, first = [], []
    sync()
    t0 = time.perf_counter()
    for start, batch, _ in _stream_batches(dataset, tf, eval_batch, {}):
        chunks.append(batch)
        first.append(run(batch, start + eval_batch >= len(dataset)).cpu())
    seconds = time.perf_counter() - t0
    _reset_launches()
    dets = []
    sync()
    t0 = time.perf_counter()
    for i, batch in enumerate(chunks):
        dets.append(run(batch, i == len(chunks) - 1))
    sync()
    forward_s = time.perf_counter() - t0
    dets = torch.cat([d.cpu() for d in dets])
    return {"detections": dets, "seconds": seconds, "forward_s": forward_s,
            "launches": _launches(), "repeat_bit_equal": torch.equal(torch.cat(first), dets)}


def dp_split_check(ranks, one, whole, eval_batch, label):
    """Phase 31's split evaluation (``dp_infer`` on the ranks at
    ``eval_batch``) against one rank at its share (``one``: the tail in
    the ranks' pieces): the ranks' detections the same bits, and the one
    rank's bits; each rank's launches GSSD_FORWARD_LAUNCHES a chunk; the
    max difference from one rank at ``eval_batch`` (``whole``: the tail in
    one forward of another shape)."""
    import torch

    n = one["detections"].shape[0]
    full = n // eval_batch * eval_batch
    got = ranks[0]["detections"]
    check(all(torch.equal(got, r["detections"]) for r in ranks[1:]),
          f"{label}: the ranks' gathered detections differ")
    check(torch.equal(got, one["detections"]),
          f"{label}: the detections differ from one rank's at eval_batch "
          f"{eval_batch // len(ranks)}: max |diff| "
          f"{float((got - one['detections']).abs().max())}")
    tail = float((got[full:] - whole["detections"][full:]).abs().max()) if full < n else 0.0
    # the same on each class's scores sorted
    scores = [torch.sort(d[full:, ..., 0], dim=-1).values for d in (got, whole["detections"])]
    tail_scores = float((scores[0] - scores[1]).abs().max()) if full < n else 0.0
    chunks = -(-n // eval_batch)
    for i, r in enumerate(ranks):
        want = {k: GSSD_FORWARD_LAUNCHES.get(k, 0) * chunks for k in r["launches"]}
        check(r["launches"] == want and r["repeat_bit_equal"],
              f"{label} rank {i}: launches {r['launches']}, want {want}; the same bits twice "
              f"{r['repeat_bit_equal']}")
    piece = -(-(n - full) // len(ranks))
    print(f"split evaluation ({label}): {n} images at eval_batch {eval_batch}, every row "
          f"bit-equal to one rank at {eval_batch // len(ranks)} (its {n - full}-row tail in "
          f"pieces of {piece}, the ranks' shapes); the tail against one rank's single forward "
          f"of {n - full} rows: max |diff| {tail:.3e}, of the sorted scores {tail_scores:.3e}; "
          f"launches a rank {ranks[0]['launches']}", flush=True)
    return {"images": n, "eval_batch": eval_batch, "rows_bit_equal": n,
            "tail_rows": n - full, "tail_piece": piece,
            "tail_max_abs_diff_one_forward": tail,
            "tail_max_abs_diff_sorted_scores_one_forward": tail_scores,
            "launches_per_rank": [r["launches"] for r in ranks],
            "seconds": [r["seconds"] for r in ranks],
            "forward_s": [r["forward_s"] for r in ranks]}


def dp_eval_phase(tmp, data, run, argv, two_card, smi, device="cuda"):
    """Phase 31's evaluation split over the ranks: (a) the two-rank
    trainer ``run`` (``argv``) evaluated at its last iteration, its valid
    and test AP/IoBB against one rank's evaluation of the checkpoint it
    wrote (``--test --checkpoint`` and the validation set); (b)
    ``dp_infer`` on two ranks at eval_batch 16 against one rank at 8, and
    timed beside one rank at 16; (c) PixelLink++ 4s ``--test`` on the two
    ranks against one rank (phase 16's checkpoint, or a one-step run's)."""
    import torch

    from gssd_torch import train as trainer
    from gssd_torch import train_pixellink
    from gssd_torch.config import DetectConfig
    from gssd_torch.data import BaseTransform, DataSplitter, LesionDataset
    from gssd_torch.eval import run_detection_eval
    from gssd_torch.parallel.launch import launch
    from gssd_torch.parallel.mesh import plan_parallelism
    from gssd_torch.train.checkpoint import checkpoint_path, load_weights_partial
    from gssd_torch.train.steps import make_infer_step

    res = {}
    splitter = DataSplitter(data, 1, 4)
    last = DP_ITERS - 1
    evals = run["evals"]
    check([e["iter"] for e in evals] == [last], f"two-rank trainer evaluations {evals}")
    weights = evals[0]["checkpoint"]
    tested = trainer.main(argv + ["--test", "True", "--checkpoint", str(last)],
                          devices=[f"{device}:0"])["test"]
    model, priors = recipe_model("bfloat16")
    model = model.to(device)
    load_weights_partial(model, weights, verbose=False)
    infer = make_infer_step(model, torch.tensor(priors, device=device),
                            DetectConfig(num_classes=2))
    valid = run_detection_eval(
        lambda b: infer(b).cpu().numpy(), LesionDataset(data, splitter.data_cv_eval[0]),
        BaseTransform(300, 0.0, False, True), (0.3, 0.5, 0.7), (0.3, 0.5, 0.7), 0.2, False, 16)
    del model
    print(f"split evaluation (trainer, two ranks): valid {evals[0]['valid']}, test "
          f"{evals[0]['test']}; one rank from its checkpoint: valid {valid}, --test {tested}",
          flush=True)
    check(evals[0]["test"] == tested and evals[0]["valid"] == valid,
          f"the two ranks' evaluation differs from one rank's: {evals[0]} vs valid {valid}, "
          f"--test {tested}")
    res["trainer"] = {"valid": evals[0]["valid"], "test": evals[0]["test"],
                      "one_rank_valid": valid, "one_rank_test": tested}

    alone = plan_parallelism(1, 16, [f"{device}:0"])
    n_images = len(splitter.data_test) + len(splitter.data_cv_eval[0]) \
        + len(splitter.data_cv_train[0])
    # the shapes two ranks give the tail chunk: ceil(tail / 2) rows a rank
    one8 = launch(dp_infer, alone, weights, data, 8, -(-(n_images % 16 or 16) // 2))[0]
    one16 = launch(dp_infer, alone, weights, data, 16)[0]
    two = launch(dp_infer, plan_parallelism(1, 16, two_card), weights, data, 16, deadline=600)
    res["gloo_one_card"] = dp_split_check(two, one8, one16, 16, "2 gloo ranks on one card")
    res["one_rank_seconds"], res["one_rank_forward_s"] = one16["seconds"], one16["forward_s"]
    tail16 = float((two[0]["detections"] - one16["detections"]).abs().max())
    print(f"split evaluation seconds ({smi}): {one8['detections'].shape[0]} images at "
          f"eval_batch 16, one rank {one16['seconds']:.3f} s (its forwards again on the "
          f"transformed chunks {one16['forward_s']:.3f} s), two gloo ranks sharing the card "
          f"{max(r['seconds'] for r in two):.3f} s (forwards and gathers "
          f"{max(r['forward_s'] for r in two):.3f} s): two ranks on one card are not a "
          f"speed-up, and each rank transforms every chunk on the host; max |two ranks - one "
          f"rank at 16| {tail16:.3e}", flush=True)
    res["max_abs_diff_one_rank_16"] = tail16

    pl_out, pl_iter = "pl_eval_4s", 1
    with wide_conv():
        if not os.path.exists(checkpoint_path(os.path.join(tmp, pl_out, "checkpoints"),
                                              "pixellink_plusplus", pl_iter)):
            pl_out, pl_iter = "pl_dp", 0
            train_pixellink.main(pl_argv(tmp, data, pl_out, "--max_iter", "1", "--val_every",
                                         "1", "--speedrun", "0", "--device", device))
        argv_pl = pl_argv(tmp, data, pl_out, "--test", "True", "--checkpoint", str(pl_iter),
                          "--device", device)
        t0 = time.perf_counter()
        one_pl = train_pixellink.main(argv_pl, devices=[f"{device}:0"])["test"]
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two_pl = train_pixellink.main(argv_pl, devices=two_card)
        two_s = time.perf_counter() - t0
    forwards = -(-len(splitter.data_test) // PL_BATCH)
    want = {k: PL_FORWARD_LAUNCHES["4s"].get(k, 0) * forwards
            for k in two_pl["ranks"][0]["launches"]}
    for i, r in enumerate(two_pl["ranks"]):
        check(r["test"] == one_pl, f"PixelLink++ --test rank {i}: {r['test']} vs one rank {one_pl}")
        check(r["launches"] == want, f"PixelLink++ --test rank {i}: launches {r['launches']}, "
                                     f"want {want}")
    print(f"split evaluation (PixelLink++ 4s --test --checkpoint {pl_iter}, two ranks): "
          f"{two_pl['test']} = one rank's; launches a rank {two_pl['ranks'][0]['launches']}; "
          f"{two_s:.2f} s with the ranks' start against {one_s:.2f} s in this process",
          flush=True)
    res["pixellink_test"] = {"test": two_pl["test"], "one_rank_test": one_pl,
                             "launches_per_rank": [r["launches"] for r in two_pl["ranks"]],
                             "seconds_two_ranks": two_s, "seconds_one_rank": one_s}
    return res, (one8, one16), weights


def dp_phase(tmp, data, device="cuda", smi=""):
    """Phase 31, data parallelism (``gssd_torch.parallel``): (1) two gloo
    ranks sharing the card (``cuda:0`` twice, through the launcher's device
    list) against one rank at global batch DP_BATCH, GSSD++ 300 f32 on
    ``hat``, DP_ITERS steps each from the one-rank run's state before it,
    beside the one-rank run on reversed rows (``dp_compare``), and two
    planted faults that must fail the same checks (``dp_planted``); (2) the same two ranks through
    ``gssd_torch.train.main`` at the recipe's batch 32, bf16,
    ``device_cached``, DP_ITERS steps: the parallelism line, exactly 12 + 12
    attention and 1 + 1 hat DCN launches a step on each rank, finite
    losses, the ranks' states bit-equal, ms/step (two ranks sharing one
    card: not a speed-up), and an evaluation at its last iteration split
    over the ranks, with the split evaluation's checks (``dp_eval_phase``;
    ``smi``, the card's name and power limit, printed beside its seconds);
    (3) with two cards or more, (1) and the split evaluation (``dp_infer``)
    on NCCL, one rank a card, and the trainer at batch 32 a card (ms/step,
    slices/s); with one card, a line saying that the NCCL run was not
    made. (``device="cpu"`` rehearses it on the CPU, gloo ranks in place
    of the card's.)"""
    import torch

    from gssd_torch import train as trainer
    from gssd_torch.data import DataSplitter
    from gssd_torch.parallel.launch import launch
    from gssd_torch.parallel.mesh import plan_parallelism

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    host = fixed_batch(data, DP_BATCH * DP_ITERS, "cpu")
    batches = [{k: v[i * DP_BATCH:(i + 1) * DP_BATCH].numpy() for k, v in host.items()}
               for i in range(DP_ITERS)]
    alone = plan_parallelism(1, DP_BATCH, [f"{device}:0"])
    one = launch(dp_steps, alone, batches)[0]
    starts = [None] + one["after"][:-1]
    rev = launch(dp_steps, alone, [{k: v[::-1].copy() for k, v in b.items()} for b in batches],
                 starts)[0]
    two_card = [f"{device}:0"] * 2
    plan = plan_parallelism(1, DP_BATCH, two_card)
    check((plan.describe(), plan.backend) == ("mesh(data=2)", "gloo"), f"plan {plan}")
    res = {"gloo_one_card": dp_compare(
        one, rev, launch(dp_steps, plan, batches, starts, deadline=600),
        f"2 gloo ranks on {device}:0")}
    model, _ = recipe_model("float32")
    res["planted"] = {}
    for fault, got in launch(dp_planted, plan, batches, deadline=600)[0].items():
        loss_err = abs(got["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        l2 = _l2_errs(one["after"][0], got["after"][0], model)
        res["planted"][fault] = {"loss_rel_err": loss_err, "l2_rel_err": l2}
        print(f"data parallelism, planted {fault}: loss rel err {loss_err:.3e}; relative L2 "
              f"{', '.join(f'{k} {v:.3e}' for k, v in l2.items())}", flush=True)
        check(loss_err > DP_TOL or l2["param"] > DP_TOL or l2["stat"] > DP_TOL
              or l2["momentum"] > DP_GRAD_TOL, f"planted {fault} passed the checks")

    argv = train_argv(tmp, "hat", TRAIN_BATCH, DP_ITERS, out="run_dp", device=device) + [
        "--aug_method", "device_cached", "--val_every", str(DP_ITERS), "--speedrun", "0"]
    run = trainer.main(argv, devices=two_card)
    # the steps, then the evaluation at the last iteration split over the
    # ranks: each runs one forward a chunk (and the validation-loss batch)
    fwd = _eval_forwards(DataSplitter(data, 1, 4), 16)
    want = {name: ROUTE_LAUNCHES["hat"].get(name, 0) * DP_ITERS
            + GSSD_FORWARD_LAUNCHES.get(name, 0) * fwd for name in run["ranks"][0]["launches"]}
    for r, rank in enumerate(run["ranks"]):
        check(rank["launches"] == want, f"rank {r}: launches {rank['launches']}, want {want}")
    losses = [rec["loss"] for rec in run["records"]]
    check(len(losses) == DP_ITERS and all(math.isfinite(v) for v in losses),
          f"two-rank trainer losses {losses}")
    digests = [rank["state_digests"] for rank in run["ranks"]]
    check(digests[0] == digests[1], f"the ranks' states differ: {digests}")
    median = run["median_step_ms"]
    print(f"data parallelism (trainer, two ranks sharing one card, bf16, global batch "
          f"{TRAIN_BATCH}): median {median:.2f} ms/step; not a speed-up; launches a rank "
          f"{run['ranks'][0]['launches']}; losses {losses}", flush=True)
    res["trainer_one_card"] = {"batch": TRAIN_BATCH, "steps": DP_ITERS, "losses": losses,
                               "ms_per_step": [rec["ms"] for rec in run["records"]],
                               "median_ms_per_step": median,
                               "launches_per_rank": [rank["launches"] for rank in run["ranks"]],
                               "evaluation_forwards_per_rank": fwd,
                               "states_bit_equal": True}
    t_eval = time.perf_counter()
    res["split_evaluation"], (one8, one16), weights = dp_eval_phase(tmp, data, run, argv,
                                                                    two_card, smi, device)
    res["split_evaluation"]["seconds"] = time.perf_counter() - t_eval

    cards = torch.cuda.device_count() if device == "cuda" else 0
    res["cards"] = cards
    if cards >= 2:
        devs = [f"cuda:{i}" for i in range(cards)]
        nccl = plan_parallelism(1, DP_BATCH, devs[:2])
        check(nccl.backend == "nccl", f"plan {nccl}")
        res["nccl"] = dp_compare(one, rev, launch(dp_steps, nccl, batches, starts, deadline=600),
                                 "2 NCCL ranks on cuda:0 and cuda:1")
        res["nccl_split_evaluation"] = dp_split_check(
            launch(dp_infer, plan_parallelism(1, 16, devs[:2]), weights, data, 16, deadline=600),
            one8, one16, 16, "2 NCCL ranks on cuda:0 and cuda:1")
        argv = train_argv(tmp, "hat", TRAIN_BATCH * cards, DP_ITERS, out="run_nccl") + [
            "--aug_method", "device_cached"]
        run = trainer.main(argv, devices=devs)
        median = run["median_step_ms"]
        res["nccl_trainer"] = {"cards": cards, "batch_per_card": TRAIN_BATCH,
                               "median_ms_per_step": median,
                               "slices_per_s": TRAIN_BATCH * cards / median * 1e3}
        print(f"data parallelism (NCCL, {cards} cards, batch {TRAIN_BATCH} a card): median "
              f"{median:.2f} ms/step, {res['nccl_trainer']['slices_per_s']:.1f} slices/s",
              flush=True)
    else:
        res["nccl"] = None
        print("data parallelism: the NCCL run across cards was not made: this machine has "
              f"{cards} card (torch.cuda.device_count() == {cards})", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"phase 31 (data parallelism): {res['seconds']:.1f} s", flush=True)
    return res


def data_parallel_only(smi) -> int:
    """``--data-parallel``: the kernels built and phase 31 alone, on a
    synthetic set of its own; prints its JSON line and no result line."""
    from gssd_torch.data import make_synthetic_dataset
    from gssd_torch.ops.kernels import KERNELS, build

    try:
        build(KERNELS.values())
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "train_ml")
            make_synthetic_dataset(data)
            dp = dp_phase(tmp, data, smi=smi)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"data_parallel": dp, "power": smi}))
    return 0


def _kernel_numbers(site):
    return {k: site[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}


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

    if sys.argv[1:2] == ["--deterministic-step"]:
        (pl2_repeat_step if sys.argv[3:4] == ["pixellink2s"] else deterministic_step)(sys.argv[2])
        return 0

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
    if sys.argv[1:2] == ["--data-parallel"]:
        return data_parallel_only(smi)

    try:
        t0 = time.perf_counter()
        built = build(KERNELS.values())
        print(f"built {built} in {time.perf_counter() - t0:.1f} s", flush=True)
        attn_sites = check_flash()
        attn_bwd_sites = check_flash_bwd()
        dcn_site = check_dcn()
        dcn_bwd_site = check_dcn_bwd()
        sample_sites = check_sample()
        stem_sites = check_stem()
        stem_f32_sites = check_stem_f32()
        pl_sites = check_pixellink_sites()
        with tempfile.TemporaryDirectory() as tmp:
            launches, lat, data, weights = serve(tmp)
            parts = breakdown()
            errs = parity(data)
            t_train = time.perf_counter()
            train_launches, train_res, train_data = train(tmp)
            losses, split = descend_and_split(train_data)
            train_par = train_parity(train_data)
            train_s = time.perf_counter() - t_train
            pallas_serve_launches, pallas_lat = serve_pallas(tmp, data, weights)
            routes = {impl: train(tmp, impl, iters=ROUTE_ITERS) for impl in ("pallas", "fused")}
            harness = eval_resume_test(tmp)
            t_pl = time.perf_counter()
            pl = pixellink(tmp, train_data)
            pl_parity = pixellink_parity(train_data)
            pl_s = time.perf_counter() - t_pl
            repeat_calls = repeat_kernels()
            det_step = deterministic_step_check(train_data)
            pl_pallas = pixellink_pallas(tmp, train_data)
            t_in = time.perf_counter()
            inputs = input_paths(tmp)
            resumes = exact_resume(tmp)
            warp_res = warp_check(train_data)
            wire = wire_dtype_wait(train_data)
            inputs_s = time.perf_counter() - t_in
            big = gssd_512(tmp, data)
            folds = folds_phase(tmp)
            pl2 = pixellink_2s(tmp, train_data)
            routes512 = gssd_512_routes(tmp, data, sum(c for *_, c in big["attention_sites"]))
            fssd = fssd_family(tmp, data, train_data)
            unet = unet_phase(tmp, train_data)
            native = native_phase(tmp)
            visual = visualize_phase(tmp, train_data)
            voc = voc_phase(tmp)
            raw_drop = raw_drop_phase(tmp, harness)
            dp = dp_phase(tmp, train_data, smi=smi)
        dcn_grad_cos = dcn_grads()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    def per_forward(key, sites=attn_sites, count="per_forward"):
        return sum(s[key] * s[count] for s in sites)

    def per_step(key):
        return per_forward(key, attn_bwd_sites, "per_step")

    flash_bound, flash_by, _ = attn_bound(per_forward("ops"), per_forward("exps"),
                                          per_forward("bytes"))
    flash_bwd_bound, flash_bwd_by, _ = attn_bound(per_step("ops"), per_step("exps"),
                                                  per_step("bytes"))
    kernels = [
        dict(name="flash_attn_fwd", route="cuda", source="gssd_torch/csrc/flash_attn_fwd.cu",
             replaces="gssd_tpu/ops/pallas/flash_attn.py:64",
             launches=launches["flash_attn_fwd"],
             max_abs_err=max(s["max_abs_err"] for s in attn_sites),
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
             bound_ms=flash_bound, bound_by=flash_by,
             library_ms=per_forward("library_ms"),
             note=f"times summed over the 12 serving sites of one batch-{BATCH} forward",
             ms_train_batch=per_step("fwd_ms"),
             library_ms_train_batch=per_step("fwd_library_ms"),
             bound_ms_train_batch=attn_bound(per_step("fwd_ops"), per_step("exps"),
                                             per_step("fwd_bytes"))[0],
             sites=attn_sites),
        dict(name="deform_conv_fwd", route="cuda", source="gssd_torch/csrc/deform_conv_fwd.cu",
             replaces="gssd_tpu/ops/pallas/deform_hat.py:314",
             launches=launches["deform_conv_fwd"], max_abs_err=dcn_site["max_abs_err"],
             ms=dcn_site["ms"], plain_ms=dcn_site["plain_ms"], bound_ms=dcn_site["bound_ms"],
             bound_by=dcn_site["bound_by"], library_ms=None,
             note=f"one batch-{BATCH} call at the 38x38 serving site",
             ms_train_batch=dcn_bwd_site["fwd_ms"],
             bound_ms_train_batch=dcn_bwd_site["fwd_bound_ms"], sites=[dcn_site]),
        dict(name="flash_attn_bwd", route="cuda", source="gssd_torch/csrc/flash_attn_bwd.cu",
             replaces="gssd_tpu/ops/pallas/flash_attn.py:74",
             launches=train_launches["flash_attn_bwd"],
             max_abs_err=max(s["max_abs_err"] for s in attn_bwd_sites),
             ms=per_step("ms"), plain_ms=per_step("plain_ms"),
             bound_ms=flash_bwd_bound, bound_by=flash_bwd_by,
             library_ms=per_step("library_ms"),
             note=(f"times summed over the 12 sites of one batch-{TRAIN_BATCH} train step; "
                   "one launch runs the dV and the dK/dQ kernels; library_ms is the "
                   "backward of F.scaled_dot_product_attention(scale=1)"),
             sites=attn_bwd_sites),
        dict(name="deform_conv_bwd", route="cuda", source="gssd_torch/csrc/deform_conv_bwd.cu",
             replaces="gssd_tpu/ops/pallas/deform_hat.py:587",
             launches=train_launches["deform_conv_bwd"],
             max_abs_err=dcn_bwd_site["max_abs_err"], ms=dcn_bwd_site["ms"],
             plain_ms=dcn_bwd_site["plain_ms"], bound_ms=dcn_bwd_site["bound_ms"],
             bound_by=dcn_bwd_site["bound_by"], library_ms=None,
             note=(f"one batch-{TRAIN_BATCH} call at the 38x38 training site; one launch "
                   "runs dU with the corner terms, the dx buckets and gather, the dW "
                   "partials and their sum"),
             sites=[dcn_bwd_site]),
    ]
    pallas_launches = routes["pallas"][0]
    sample_note = ("times per launch at the 38x38 site (the 75x75 site of PixelLink++ in "
                   "sites); bound_ms counts the work these hat rows need, dense_bound_ms in "
                   "sites the dense contraction's; library_ms is one torch.einsum of the same "
                   "function, never called by the port")
    kernels += [
        dict(name="deform_sample_fwd", route="cuda",
             source="gssd_torch/csrc/deform_sample_fwd.cu",
             replaces="gssd_tpu/ops/pallas/deform_sample.py:66",
             launches=pallas_serve_launches["deform_sample_fwd"],
             **_kernel_numbers(sample_sites["fwd_b8"]),
             note=(f"{sample_note}; one batch-{BATCH} call (one tap; 9 per forward); "
                   f"launches from the pallas serving run, "
                   f"{pallas_launches['deform_sample_fwd']} in the pallas training run"),
             ms_train_batch=sample_sites[f"fwd_b{TRAIN_BATCH}"]["ms"],
             sites=[sample_sites["fwd_b8"], sample_sites[f"fwd_b{TRAIN_BATCH}"],
                    sample_sites["fwd_75"]]),
        dict(name="deform_sample_dx", route="cuda", source="gssd_torch/csrc/deform_sample_dx.cu",
             replaces="gssd_tpu/ops/pallas/deform_sample.py:79",
             launches=pallas_launches["deform_sample_dx"],
             **_kernel_numbers(sample_sites["dx"]),
             note=(f"{sample_note}; one batch-{TRAIN_BATCH} call (one tap; 9 per step); launches "
                   f"from the pallas training run, {routes['fused'][0]['deform_sample_dx']} in "
                   f"the fused one"),
             sites=[sample_sites["dx"], sample_sites["dx_75"]]),
        dict(name="deform_sample_dab", route="cuda",
             source="gssd_torch/csrc/deform_sample_dab.cu",
             replaces="gssd_tpu/ops/pallas/deform_sample.py:104",
             launches=pallas_launches["deform_sample_dab"],
             **_kernel_numbers(sample_sites["dab"]),
             note=(f"{sample_note} (two einsums: dA and dB); one batch-{TRAIN_BATCH} call "
                   "(one tap; 9 per step) runs the ranges, the buckets, the dA and the dB "
                   f"pass; PixelLink++ pallas: {pl_pallas['launches']['deform_sample_dab']} "
                   f"over {PL_PALLAS_ITERS} steps"),
             sites=[sample_sites["dab"], sample_sites["dab_75"]]),
    ]
    def stem_sum(key):
        return sum(site[key] for site in stem_sites)

    stem_fwd_bound = bound(stem_sum("ops"), stem_sum("fwd_bytes"))
    stem_bwd_bound = bound(sum(s["ops"] * (2 if s["need_dx"] else 1) for s in stem_sites),
                           stem_sum("bwd_bytes"))
    stem_note = (f"times summed over conv1_1 and conv1_2 of one batch-{PL_BATCH} PixelLink++ "
                 "step at 300x300 (bf16, 4 groups); library_ms is cuDNN (F.conv2d, "
                 "aten.convolution_backward), never called by the port; launches from the "
                 f"PixelLink++ training run ({PL_ITERS} steps)")
    kernels += [
        dict(name="stem_conv_fwd", route="cuda", source="gssd_torch/csrc/stem_conv_fwd.cu",
             replaces="gssd_tpu/ops/pallas/stem_conv.py:64",
             launches=pl["launches"]["stem_conv_fwd"],
             max_abs_err=max(s["max_abs_err"] for s in stem_sites),
             ms=stem_sum("fwd_ms"), plain_ms=stem_sum("fwd_plain_ms"),
             bound_ms=stem_fwd_bound[0], bound_by=stem_fwd_bound[1],
             library_ms=stem_sum("fwd_library_ms"), note=stem_note, sites=stem_sites,
             f32_sites=stem_f32_sites),
        dict(name="stem_conv_bwd", route="cuda", source="gssd_torch/csrc/stem_conv_bwd.cu",
             replaces="gssd_tpu/ops/pallas/stem_conv.py:97",
             launches=pl["launches"]["stem_conv_bwd"],
             max_abs_err=max(s["max_abs_err"] for s in stem_sites),
             ms=stem_sum("bwd_ms"), plain_ms=stem_sum("bwd_plain_ms"),
             bound_ms=stem_bwd_bound[0], bound_by=stem_bwd_bound[1],
             library_ms=stem_sum("bwd_library_ms"),
             note=stem_note + "; one launch runs the dx kernel (not at conv1_1), the dW "
                              "partial sums and their reduction", sites=stem_sites),
    ]
    sample_150, sample_64 = pl2["kernels"]["sample_150"], routes512["kernels"]["sample_64"]
    fssd_launches = {t: {"serving": m["serving"]["launches"],
                         "training": m["training"]["launches"]}
                     for t, m in fssd["models"].items()}
    for entry in kernels:
        if entry["name"].startswith("stem_conv"):
            entry["fssd_sites"] = fssd["kernels"]
            entry["fssd_launches"] = fssd_launches
        if entry["name"].startswith("flash_attn"):
            entry["pixellink_sites"] = pl_sites["attention"]
            entry["sites_512"] = big["kernels"]["attention"]
            entry["sites_2s"] = pl2["kernels"]["attention"]
        elif entry["name"].startswith("deform_conv"):
            entry["pixellink_site"] = pl_sites["hat_dcn_75"]
            entry["sites_512"] = big["kernels"]["hat_dcn_64"]
            entry["pixellink_2s_site"] = pl2["kernels"]["hat_dcn_150"]
        elif entry["name"].startswith("deform_sample"):
            part = entry["name"].removeprefix("deform_sample_")
            entry["sites_150"] = [v for k, v in sample_150.items() if k.startswith(part)]
            entry["sites_512"] = [v for k, v in sample_64.items() if k.startswith(part)]
        if entry["name"].startswith(("flash_attn", "deform_conv")):
            entry["raw_drop_launches"] = {"training": raw_drop["launches"][entry["name"]],
                                          "test": raw_drop["test_launches"][entry["name"]]}
    recs = train_res["records"]
    print(json.dumps({"pixellink": {"batch": PL_BATCH, "steps": PL_ITERS,
                                    "ms_per_step": [r["ms"] for r in pl["records"]],
                                    "input_wait_ms": [r["wait_ms"] for r in pl["records"]],
                                    "losses": [r["loss"] for r in pl["records"]],
                                    "median_ms_per_step": pl["median_step_ms"],
                                    "launches": pl["launches"], "evaluation": pl["evaluation"],
                                    "test": pl["test"], "test_s": pl["test_s"],
                                    "test_decode_s": pl["test_decode_s"],
                                    "test_decode_numpy_s": pl["test_decode_numpy_s"],
                                    "test_s_numpy_decode": pl["test_s_numpy_decode"],
                                    "test_boxes": pl["test_boxes"],
                                    "test_native_calls": pl["test_native_calls"],
                                    "test_images": pl["test_images"],
                                    "test_launches": pl["test_launches"],
                                    "switch_off_launches": pl["switch_off_launches"],
                                    "switch_off_ms_per_step": [
                                        r["ms"] for r in pl["switch_off_records"]],
                                    "switch_off_median_ms_per_step":
                                        pl["switch_off_median_step_ms"],
                                    "parity": pl_parity, "seconds": pl_s,
                                    "pallas": pl_pallas, "power": smi}}))
    print(json.dumps({"routes": {
        impl: {"batch": TRAIN_BATCH, "steps": len(res["records"]),
               "ms_per_step": [r["ms"] for r in res["records"]],
               "losses": [r["loss"] for r in res["records"]],
               "median_ms_per_step": res["median_step_ms"], "launches": lc}
        for impl, (lc, res, _) in routes.items()},
        "pallas_serving": {"batch": BATCH, "latency_ms_per_image": pallas_lat},
        "harness": harness, "dcn_grad_cosines": dcn_grad_cos, "power": smi}))
    print(json.dumps({"input_paths": {"batch": TRAIN_BATCH, "paths": inputs,
                                      "trace_steps": list(INPUT_TRACE), "exact_resume": resumes,
                                      "warp": warp_res, "wire_wait_ms": wire,
                                      "nproc": os.cpu_count(), "seconds": inputs_s,
                                      "power": smi}}))
    print(json.dumps({"gssd512": {k: v for k, v in big.items() if k != "kernels"},
                      "power": smi}))
    print(json.dumps({"folds": folds, "power": smi}))
    print(json.dumps({"pixellink2s": {k: v for k, v in pl2.items() if k != "kernels"},
                      "power": smi}))
    print(json.dumps({"gssd512_routes": {k: v for k, v in routes512.items() if k != "kernels"},
                      "power": smi}))
    print(json.dumps({"fssd_family": {k: v for k, v in fssd.items() if k != "kernels"},
                      "power": smi}))
    print(json.dumps({"unet": unet, "power": smi}))
    print(json.dumps({"native": native, "visualize": visual, "voc": voc, "power": smi}))
    print(json.dumps({"preprocessing": raw_drop, "power": smi}))
    print(json.dumps({"data_parallel": dp, "power": smi}))
    print(json.dumps({"repeatability": {"bit_equal_calls": repeat_calls,
                                        "deterministic_step": det_step, "batch": DET_BATCH,
                                        "power": smi}}))
    print(json.dumps({"serving": {"batch": BATCH, "latency_ms_per_image": lat,
                                  "breakdown_ms_per_batch": parts,
                                  "parity_rel_err": errs, "power": smi},
                      "training": {"batch": TRAIN_BATCH, "steps": len(recs),
                                   "ms_per_step": [r["ms"] for r in recs],
                                   "input_wait_ms": [r["wait_ms"] for r in recs],
                                   "losses": [r["loss"] for r in recs],
                                   "median_ms_per_step": train_res["median_step_ms"],
                                   "slices_per_s": TRAIN_BATCH / train_res["median_step_ms"] * 1e3,
                                   "repeated_batch_losses": losses,
                                   "step_split_ms": split, "parity": train_par,
                                   "seconds": train_s, "power": smi},
                      "seconds": time.perf_counter() - t_start}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
