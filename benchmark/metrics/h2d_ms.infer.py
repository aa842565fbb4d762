"""The serving copy: device milliseconds of the host-to-device copies a
request (the pageable batch to the card), from the profiler's trace of
the traced requests."""


def read(ctx):
    ms = 1e3 * ctx.trace.copies_s("HtoD") / ctx.trace.units
    return ms if ms > 0 else None
