"""Serving traffic: ``python -m gssd_torch.infer``'s loop, one client,
closed: each request is handed in when the one before it has come back.

A request is a pageable f32 host array of ``batch`` slices, already
through the serving transform (as ``infer.py`` prepares its chunks before
its timed loop), taken in turn from a pool of ``pool`` slices made from
the seed. It goes through the port's ``make_infer_step`` (the copy to the
card, the eval forward, the softmax, Detect/NMS) and ``.cpu()``; its time
runs from the hand-in to the detections on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import check, data, program
from benchmark.reference.infer import detect, scores_boxes
from benchmark.reference.model import param_spec
from benchmark.reference.quant import bf16, fp8
from benchmark.trace import Trace, capture
from benchmark.weights import calibrate_batchnorm, make_weights


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.window_stats: Dict = {}
        self.served: List[Tuple[int, torch.Tensor]] = []  # (chunk, detections) of the window

    def setup(self) -> None:
        from gssd_torch.train.steps import make_infer_step

        cfg, tr, dev = self.config, self.traffic, self.device
        ct, _ = data.lesion_slices(cfg["slices"], cfg["model"]["size"], self.seed, dev,
                                   tr["max_lesions"])
        pool = data.base_transform(ct).cpu().numpy()
        del ct
        self.chunks = [np.ascontiguousarray(pool[i:i + self.batch])
                       for i in range(0, len(pool) - self.batch + 1, self.batch)]
        self.w0 = make_weights(param_spec(cfg["model"]), self.seed, dev)
        calibrate_batchnorm(cfg["model"], self.w0,
                            [torch.from_numpy(c).to(dev) for c in self.chunks])
        model, priors = program.model_and_priors(cfg, self.w0, dev)
        self.infer_step = make_infer_step(model, priors, program.detect_config(cfg))
        self.sent = 0
        for _ in range(tr["warm_requests"]):
            self.request()

    def request(self) -> Tuple[int, torch.Tensor, float]:
        chunk = self.sent % len(self.chunks)
        self.sent += 1
        t0 = time.perf_counter()
        det = self.infer_step(self.chunks[chunk]).cpu()
        return chunk, det, time.perf_counter() - t0

    def window(self, seconds: float) -> Dict[str, float]:
        lat, failed = [], 0
        t0 = time.perf_counter()
        while True:
            chunk, det, dt = self.request()
            lat.append(dt)
            self.served.append((chunk, det))
            failed += not bool(torch.isfinite(det).all())
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.window_stats = {"requests": len(lat), "wall_s": wall, "latencies_s": lat,
                             "slices": len(lat) * self.batch}
        return {"infer_slices_per_s": len(lat) * self.batch / wall,
                "infer_batch_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "attempted": len(lat), "failed": failed}

    def traced(self) -> Trace:
        return capture(lambda i: self.request(), self.traffic["trace_requests"],
                       program.kernel_counters())

    def release(self) -> None:
        self.infer_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """Indices of the window's requests that the comparison reads,
        drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        k = min(self.traffic["check_requests"], len(self.served))
        return sorted(rng.choice(len(self.served), size=k, replace=False).tolist())

    def reference(self, chunk: int, quant=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's scores and boxes of ``chunk`` (float64, TF32 off)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = torch.from_numpy(self.chunks[chunk]).to(self.device)
        return scores_boxes(self.config["model"], self.w0, x, self.config["detect"]["variance"],
                            quant)

    def stats(self, det: torch.Tensor, chunk: int) -> Dict[str, float]:
        if chunk not in self.refs:
            self.refs[chunk] = self.reference(chunk)
        d = self.config["detect"]
        return check.detection_stats(det, *self.refs[chunk], d["nms_thresh"], d["conf_thresh"])

    def reference_detect(self, chunk: int, quant) -> torch.Tensor:
        d = self.config["detect"]
        return detect(*self.reference(chunk, quant), d["top_k"], d["conf_thresh"],
                      d["nms_thresh"])

    def check(self) -> Dict[str, float]:
        self.refs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        prog = yard = None
        yards: Dict[int, Dict[str, float]] = {}
        for r in self.sample():
            chunk, det = self.served[r]
            if chunk not in yards:
                yards[chunk] = self.stats(self.reference_detect(chunk, bf16), chunk)
            st = self.stats(det, chunk)
            prog = st if prog is None else check.merge(prog, st)
            yard = yards[chunk] if yard is None else check.merge(yard, yards[chunk])
        self.yard = yard
        return check.serve_numbers(prog, yard)

    def control(self) -> Dict[str, Dict[str, float]]:
        """After ``check``: the numbers of the reference put in the
        program's place in fp8, with the reference's own Detect/NMS, over
        the same sampled requests."""
        ctl = None
        for r in self.sample():
            chunk = self.served[r][0]
            st = self.stats(self.reference_detect(chunk, fp8), chunk)
            ctl = st if ctl is None else check.merge(ctl, st)
        return {"fp8": check.serve_numbers(ctl, self.yard)}
