"""gn_iters_per_frame: the Gauss-Newton iterations of the track a frame,
over all pyramid levels: the program's counter `odometry.gn_iterations`
over the steps traced with its span recorder on (`benchmark/spans.py`)."""


def read(ctx):
    n = ctx.get("span_counts", {}).get("odometry.gn_iterations")
    return None if n is None else n / ctx["span_steps"]
