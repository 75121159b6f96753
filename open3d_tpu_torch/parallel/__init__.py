"""Multi-process parallelism over torch.distributed (port of
open3d_tpu/parallel/): the DeviceMesh replacement of the reference's
multiprocessing.Pool fragment scaling."""

from open3d_tpu_torch.parallel.fragments import (  # noqa: F401
    make_mesh,
    multiway_align,
    multiway_gn_step,
)
