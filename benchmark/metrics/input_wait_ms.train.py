"""The training input's wait: host milliseconds blocked in ``next()`` of
the batch stream (the trainer's ``wait_ms``), the mean over every step of
the window."""


def read(ctx):
    waits = ctx.window.get("waits_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
