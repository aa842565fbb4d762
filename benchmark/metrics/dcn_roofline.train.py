"""The deformable conv's share of its roofline in the train cell: its least
time, forward and backward, from the cell's shapes
(``benchmark/work.py``), over the device time of the port's DCN kernels
in the traced stretch."""

from benchmark.readers import DCN_KERNELS, roofline


def read(ctx):
    return roofline(ctx, "dcn", DCN_KERNELS, backward=True)
