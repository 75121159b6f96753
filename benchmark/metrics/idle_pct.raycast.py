"""idle_pct.raycast: the share of the program's `raycast` spans' wall time in
which no operation ran on the card: 100 x the card's idle time inside
them (their children included) / their wall time, over the steps traced
with the program's span recorder on (`benchmark/spans.py`)."""


def read(ctx):
    idle, wall = ctx.get("span_idle", {}).get("raycast", (0, 0))
    return 100.0 * idle / wall if wall else None
