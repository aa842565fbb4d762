"""Attention's share of its roofline in the infer cell: the least time of
softmax(q k^T) v over every site, from the cell's shapes
(``benchmark/work.py``), over the device time of the port's attention
kernels in the traced requests."""

from benchmark.readers import ATTN_KERNELS, roofline


def read(ctx):
    return roofline(ctx, "attention", ATTN_KERNELS, backward=False)
