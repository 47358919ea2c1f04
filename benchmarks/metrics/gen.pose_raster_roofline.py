"""The pose raster kernel's share of its roofline: the bytes it must move
(its [B, K, 3] float32 keypoints read once, its [B, H, W, K] float32 maps
written once) at the card's memory bandwidth (`peaks.py`), over its mean
device time in the profiled stretch (the profiler's records of the
program's kernel `pose_raster_kernel`), in %. It is bound by bytes: its
only arithmetic is an integer disc test per row."""
from benchmarks import peaks

KERNEL = "pose_raster_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "batch_device_ms" not in ctx:
        return None
    times = trace.kernel_seconds(KERNEL)
    bw = peaks.peak(ctx["device_kind"], "hbm_bytes_per_s")
    if not times or bw is None:
        return None
    n, b = ctx["config"]["nets"], ctx["traffic"]["batch_size"]
    k = n["keypoints"]
    moved = 4 * b * k * (3 + n["img_H"] * n["img_W"])
    return 100.0 * (moved / bw) / (sum(times) / len(times))
