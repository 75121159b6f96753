"""k1_roofline_pct: K1's (`integrate_kernel`) share of its roofline over the
traced steps: the sum of each launch's least time (`counts/k1.py`, from
the live blocks of that step's work list) over the sum of its launches'
device times. One launch a step; where the trace holds another number of
launches than steps, nothing is read."""

from benchmark.counts import k1


def read(ctx):
    times = ctx.get("kernels", {}).get("integrate_kernel")
    live = ctx.get("k1_live")
    if not times or not live or len(times) != len(live):
        return None
    cam = ctx["camera"]
    px = cam["width"] * cam["height"]
    return 100.0 * sum(k1.bound(n, ctx["k1_entries"], px) for n in live) / sum(times)
