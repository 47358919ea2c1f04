"""The training step's share of the card's peak in the configuration's
precision: the reference's FLOPs of one step times the window's steps,
over the window's seconds, over the peak (`peaks.py`), in %."""
from benchmarks import peaks


def read(ctx):
    flops = ctx.get("step_flops")
    if flops is None or not ctx.get("steps"):
        return None
    peak = peaks.peak(ctx["device_kind"], ctx["dtype"])
    if peak is None:
        return None
    return 100.0 * flops * ctx["steps"] / ctx["window_s"] / peak
