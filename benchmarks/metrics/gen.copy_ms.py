"""Host ms per transfer batch in the two copies: `batch_to_device` (the
copy-in, synchronized) and the images' copy out to host memory, the mean
over the window."""


def read(ctx):
    ms = ctx.get("copy_ms")
    return sum(ms) / len(ms) if ms else None
