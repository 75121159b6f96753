"""k2_roofline_pct: K2's (`march_kernel`) share of its roofline: over every
k-th traced step (the traffic's `k2_count_every`), the sum of each
launch's least time (`counts/k2.py`, from the reference march's walk of
that step's grid and pose) over the sum of those launches' device times.
One launch a step; where the trace holds another number of launches than
steps, nothing is read."""

from benchmark.counts import k2


def read(ctx):
    times = ctx.get("kernels", {}).get("march_kernel")
    stats = ctx.get("k2_stats")
    if not times or not stats or len(times) != ctx["steps_traced"]:
        return None
    cam = ctx["camera"]
    bound = sum(k2.bound(s, cam["width"], cam["height"]) for s in stats.values())
    return 100.0 * bound / sum(times[i] for i in stats)
