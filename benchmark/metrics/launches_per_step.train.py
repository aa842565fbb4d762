"""Kernel-launch calls of the CUDA runtime a training step, from the
profiler's trace of the traced steps; the port's own counters
(``KERNELS[*].launches``) are printed beside it."""

from benchmark.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
