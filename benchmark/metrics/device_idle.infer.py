"""The device's idle share in the traced infer stretch: one minus the union
of the kernels' intervals over the traced window (copies count as idle)."""

from benchmark.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
