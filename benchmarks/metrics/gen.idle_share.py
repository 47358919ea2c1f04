"""The share of the profiled stretch of transfer batches in which no
operation ran on the card: 1 - (union of the device operations'
intervals) / the stretch's wall time, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "batch_device_ms" not in ctx or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
