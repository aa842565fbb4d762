#!/usr/bin/env python3
"""What it costs to hand a training batch from a worker process to the
trainer on this host: a batch-32 GSSD++ image batch ([32, 300, 300, 12]
f32, 138 MB) passed three ways, then staged for the card.

    python3 tools/shm_batches.py [--batches 5]

- ``fresh``: the worker copies each batch into a new shared-memory
  tensor (``torch.multiprocessing``), the parent copies it out;
- ``pickle``: the worker puts the numpy array on a
  ``multiprocessing.Queue`` (pickled through a pipe);
- ``slots``: two shared-memory tensors made before the fork, refilled in
  turn by the worker, a slot handed back once the parent has copied it
  out (``gssd_torch.data.MPBatchLoader``'s scheme).

Per batch: the worker's ms to hand it over, the parent's ms to receive
it and to copy it into a pinned buffer. Then the pinned staging copy
from ordinary memory in f32 and cast to bf16, and the host-to-device
copy of each. Prints one JSON line, with the card's name and power
limit; needs a CUDA card (the parent holds a CUDA context, as the
trainer does).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import statistics
import subprocess
import sys
import time

SHAPE = (32, 300, 300, 12)


def _source():
    import numpy as np

    return np.random.default_rng(0).uniform(0, 1, SHAPE).astype(np.float32)


def _fresh(q, n):
    import torch

    torch.set_num_threads(1)
    src = _source()
    for _ in range(n):
        t0 = time.perf_counter()
        t = torch.empty(SHAPE, dtype=torch.float32).share_memory_()
        t.numpy()[...] = src
        q.put((t, time.perf_counter() - t0))
    time.sleep(600)  # the parent must receive the fds from a live sender


def _pickle(q, n):
    src = _source()
    for i in range(n):
        t0 = time.perf_counter()
        q.put((src + i, time.perf_counter() - t0))
    time.sleep(600)


def _slots(q, free, slots, n):
    import torch

    torch.set_num_threads(1)
    src = _source()
    for _ in range(n):
        k = free.get()
        t0 = time.perf_counter()
        slots[k].numpy()[...] = src
        q.put((k, time.perf_counter() - t0))
    time.sleep(600)


def _run(ctx, target, q, extra, n, receive, release=None):
    import torch

    pinned = torch.empty(SHAPE, dtype=torch.float32).pin_memory()
    p = ctx.Process(target=target, args=(q, *extra, n), daemon=True)
    p.start()
    rows = []
    try:
        for _ in range(n):
            item, worker_s = q.get(timeout=120)
            t0 = time.perf_counter()
            img = receive(item)
            t1 = time.perf_counter()
            pinned.copy_(img)
            t2 = time.perf_counter()
            if release is not None:
                release(item)
            rows.append({"worker_ms": worker_s * 1e3, "receive_ms": (t1 - t0) * 1e3,
                         "to_pinned_ms": (t2 - t1) * 1e3})
    finally:
        p.terminate()
        p.join(timeout=10)
    return rows


def main() -> int:
    import torch
    import torch.multiprocessing as tmp

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=5)
    n = ap.parse_args().batches
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.zeros(1, device="cuda")  # the parent holds a CUDA context, as the trainer
    ctx = tmp.get_context("fork")
    out = {"fresh": _run(ctx, _fresh, ctx.Queue(2), (), n, lambda t: t)}
    pctx = mp.get_context("fork")
    out["pickle"] = _run(pctx, _pickle, pctx.Queue(2), (), n, torch.from_numpy)
    slots = [torch.empty(SHAPE, dtype=torch.float32).share_memory_() for _ in range(2)]
    free = ctx.SimpleQueue()
    for k in range(len(slots)):
        free.put(k)
    out["slots"] = _run(ctx, _slots, ctx.Queue(2), (free, slots), n, lambda k: slots[k],
                        free.put)
    src = torch.from_numpy(_source())
    staging = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        buf = torch.empty(SHAPE, dtype=dtype).pin_memory()
        copy, h2d = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            buf.copy_(src)
            copy.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
        staging[name] = {"to_pinned_ms": statistics.median(copy[1:]),
                         "h2d_ms": statistics.median(h2d[1:])}
    for way, rows in out.items():
        print(f"{way}: " + "; ".join(f"worker {r['worker_ms']:.1f} ms, receive "
                                     f"{r['receive_ms']:.1f}, to pinned {r['to_pinned_ms']:.1f}"
                                     for r in rows), flush=True)
    print(json.dumps({"batch_shape": SHAPE, "ways": out, "staging": staging, "power": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
