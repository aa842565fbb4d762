"""The whole infer step's share of the card's bf16 peak, from the trace:
the plain reference's FLOPs a slice (forward) times the traced slices,
over the traced span on the device's clock (idle gaps included)."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, backward=False)
