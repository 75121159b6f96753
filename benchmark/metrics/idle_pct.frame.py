"""idle_pct.frame: the share of the traced steps' wall time in which no
operation ran on the card: 100 x (1 - the union of the device intervals /
the window)."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
