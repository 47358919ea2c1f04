"""Device ms per transfer batch: CUDA events around
`ConditionalTransferTester.transfer_step`, the mean over the window."""


def read(ctx):
    ms = ctx.get("batch_device_ms")
    return sum(ms) / len(ms) if ms else None
