"""pose_graph_ms: the mean ms of a fragment's pose-graph optimisation
(`pose_graph.global_optimization`, CUDA-event pairs) over the traced
fragment."""

from benchmark.metrics import mean


def read(ctx):
    return mean(ctx.get("layers", {}).get("pose_graph", []))
