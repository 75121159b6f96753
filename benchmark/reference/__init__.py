"""The plain reference that decides `correct`: plain PyTorch, on whatever
device it is given, importing nothing of the program (`open3d_tpu_torch`),
of JAX or of the JAX package.

`grid.py` is the TSDF voxel block grid (hash, touch, integrate, raycast),
`track.py` frame-to-model point-to-plane odometry, `slam.py` the two
together as a live session, and `check.py` the comparison of a run's
outputs with them. Each file names the source lines of the port it froze.

Every function takes `low`: False computes as the configuration states
(float32); True rounds the main float quantities of each stage through
bfloat16, the nearest precision below, which is the control that the
comparison has to fail.
"""

import torch


def rounder(low: bool):
    """x -> x, or x rounded through bfloat16 when `low`."""
    if not low:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (the CUDA kernels' fmaf): the product
    of two float32 values is exact in float64 and the sum is rounded to
    float32 from there. Python scalars are taken as float32."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).double() for x in (a, b, c))
    return (a * b + c).float()
