"""k3_roofline_pct: K3's (`fuse_kernel`) share of its roofline over the
traced fragment: the sum of each launch's least time (`counts/k3.py`, from
the live rows of that frame's work list, which the reference's replay of
the fragment counts) over the sum of its launches' device times. One
launch a frame; where the trace holds another number of launches than
frames, nothing is read."""

from benchmark.counts import k3


def read(ctx):
    times = ctx.get("kernels", {}).get("fuse_kernel")
    live = ctx.get("k3_live")
    if not times or not live or len(times) != len(live):
        return None
    return 100.0 * sum(k3.bound(n, ctx["k3_entries"]) for n in live) / sum(times)
