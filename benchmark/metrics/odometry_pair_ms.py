"""odometry_pair_ms: the mean ms of one odometry pair of a fragment on the
card: CUDA-event pairs around `odometry.rgbd_odometry_multi_scale` and
`odometry.compute_odometry_information_matrix`, summed over the traced
fragment and divided by its pairs."""


def read(ctx):
    layers = ctx.get("layers", {})
    if not ctx.get("pairs"):
        return None
    return (sum(layers["odometry"]) + sum(layers.get("information", []))) / ctx["pairs"]
