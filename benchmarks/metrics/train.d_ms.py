"""Device ms per training step in the D's forward and backward passes
(`train_step`'s `d_forward_backward` phase), the mean over the window."""


def read(ctx):
    ms = (ctx.get("phases_ms") or {}).get("d_forward_backward")
    return sum(ms) / len(ms) if ms else None
