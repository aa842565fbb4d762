"""A traced stretch of a run, read from ``torch.profiler`` (CUPTI) events.

``Trace`` holds, for ``units`` steps or requests run under the profiler:
the device operations (kernels, copies, sets) with their start and
length, the host's runtime calls (kernel launches among them) and the
host's operator spans, the window's wall seconds on the host clock, and
the port's own launch counters (``KERNELS[name].launches``) over the
stretch. The per-layer metrics' readers (``benchmark/metrics``) read it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@dataclass
class Trace:
    units: int
    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start s, dur s)
    runtime: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    launch_counts: Dict[str, int] = field(default_factory=dict)

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(("Memcpy", "Memset"))]

    def seconds_of(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        names = tuple(names)
        return sum(d for n, _, d in self.kernels() if any(x in n for x in names))

    def copies_s(self, kind: str) -> float:
        """Device seconds of the copies of ``kind`` ('HtoD', 'DtoH')."""
        return sum(d for n, _, d in self.device if n.startswith("Memcpy") and kind in n)

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.runtime if n in LAUNCH_CALLS)

    def busy_s(self, events=None) -> float:
        """Length of the union of the intervals of ``events`` (default:
        every device operation)."""
        spans = sorted((s, s + d) for _, s, d in (self.device if events is None else events))
        total, end = 0.0, float("-inf")
        for s, e in spans:
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, _, d in self.device:
            by[n] = by.get(n, 0.0) + d
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle gaps inside the stretch, summed by the host
        operation that spans each gap's start (the innermost one)."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        ops = sorted(self.host_ops, key=lambda o: o[1])
        by: Dict[str, float] = {}
        active: List[Tuple[str, float, float]] = []
        at = 0
        for g0, g1 in gaps:
            while at < len(ops) and ops[at][1] <= g0:
                active.append(ops[at])
                at += 1
            if len(active) > 4096:  # operators that ended before g0 never span a later gap
                active = [o for o in active if o[1] + o[2] > g0]
            # the latest-started operator still open at g0 is the innermost
            name = "host (no operator)"
            for n, s, d in reversed(active):
                if s + d > g0:
                    name = n
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _events(prof):
    for e in prof.profiler.kineto_results.events():
        try:
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        except AttributeError:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        yield e.name(), str(e.device_type()), start, dur


def capture(run_unit: Callable[[int], None], units: int,
            counters: Optional[Dict[str, object]] = None) -> Trace:
    """Run ``run_unit(i)`` for i < ``units`` under the profiler (the
    caller's unit ends by reading its result on the host, so the device
    has finished) and read the events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = {k: c.launches for k, c in (counters or {}).items()}
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            run_unit(i)
        if card:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    tr = Trace(units=units, window_s=window)
    tr.launch_counts = {k: c.launches - before[k] for k, c in (counters or {}).items()}
    for name, dev, start, dur in _events(prof):
        if "CUDA" in dev:
            tr.device.append((name, start, dur))
        elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            tr.runtime.append((name, start, dur))
        else:
            tr.host_ops.append((name, start, dur))
    return tr
