"""Attention's share of its roofline in the train cell: the least time of
softmax(q k^T) v over every site, forward and backward, from the cell's shapes
(``benchmark/work.py``), over the device time of the port's attention
kernels in the traced steps."""

from benchmark.readers import ATTN_KERNELS, roofline


def read(ctx):
    return roofline(ctx, "attention", ATTN_KERNELS, backward=True)
