"""track_ms: the mean ms a call of the program's track layer takes on the card,
from CUDA-event pairs around its public function over the traced steps
(`dense_slam.track_frame_to_model`)."""

from benchmark.metrics import mean


def read(ctx):
    return mean(ctx.get("layers", {}).get("track", []))
