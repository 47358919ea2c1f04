"""Device ms per training step in the two optimizer updates
(`train_step`'s `g_update` and `d_update` phases), the mean over the
window."""
PHASES = ("g_update", "d_update")


def read(ctx):
    phases = ctx.get("phases_ms")
    if not phases or any(p not in phases for p in PHASES):
        return None
    return sum(sum(phases[p]) for p in PHASES) / len(phases[PHASES[0]])
