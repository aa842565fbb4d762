"""Kernel-launch calls of the CUDA runtime a served request, from the
profiler's trace of the traced requests (Detect/NMS's greedy sweep is
most of them); the port's own counters are printed beside it."""

from benchmark.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
