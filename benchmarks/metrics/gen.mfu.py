"""The transfer batch's share of the card's peak in the configuration's
precision: the reference's FLOPs of one batch times the window's batches,
over the window's seconds, over the peak (`peaks.py`), in %."""
from benchmarks import peaks


def read(ctx):
    flops = ctx.get("batch_flops")
    if flops is None or not ctx.get("batches"):
        return None
    peak = peaks.peak(ctx["device_kind"], ctx["dtype"])
    if peak is None:
        return None
    return 100.0 * flops * ctx["batches"] / ctx["window_s"] / peak
