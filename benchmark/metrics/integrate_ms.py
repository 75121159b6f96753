"""integrate_ms: the mean ms a call of the program's integrate layer takes on the card,
from CUDA-event pairs around its public function over the traced steps
(`dense_slam.integrate_frame`)."""

from benchmark.metrics import mean


def read(ctx):
    return mean(ctx.get("layers", {}).get("integrate", []))
