"""raycast_ms: the mean ms a call of the program's raycast layer takes on the card,
from CUDA-event pairs around its public function over the traced steps
(`dense_slam.synthesize_model_frame`)."""

from benchmark.metrics import mean


def read(ctx):
    return mean(ctx.get("layers", {}).get("raycast", []))
