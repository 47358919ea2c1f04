"""Device ms per training step on the G side: `train_step`'s `g_forward`,
`g_backward` and `g_reforward` phases (CUDA events at its `mark` calls),
the mean over the window's steps."""
PHASES = ("g_forward", "g_backward", "g_reforward")


def read(ctx):
    phases = ctx.get("phases_ms")
    if not phases or any(p not in phases for p in PHASES):
        return None
    n = len(phases[PHASES[0]])
    return sum(sum(phases[p]) for p in PHASES) / n
