"""One reader a per-layer metric, `metrics/<metric name>.py`, each with
`read(ctx) -> float | None`. `ctx` is what the traced run gathered
(`drivers/*.py`): "layers" ({layer: [ms of each call]}), "steps_traced",
"host_reads", "busy_s" and "window_s", "kernels" ({kernel: [ms of each
launch]}), the work the kernel counts need ("k1_live", "k1_entries",
"k2_stats") and "camera". A reader that finds nothing to read returns
None, and the metric is left out of the line."""


def mean(xs):
    return sum(xs) / len(xs) if xs else None
