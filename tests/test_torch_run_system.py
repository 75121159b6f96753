"""The port's offline system end to end on the CPU: run_system at
tests/test_reconstruction.py's configuration (8 frames of the synthetic
room at 160x120, span 0.5, fragments of 4), then the scene mesh, with that
test's bars and artifacts: the trajectory within 0.05 m ATE of the truth,
trajectory.log and the scene pose graphs written, the scene grid active.
The mesh's kept vertices lie on the scene's SDF (median |sdf| under one
voxel, q90 under two, the chip smoke's bars).
"""

import os

import numpy as np
import pytest
import torch

from open3d_tpu_torch import io as tio
from open3d_tpu_torch.core import lie
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.pipelines import reconstruction as trc
from test_torch_reconstruction import Sequence

torch.set_num_threads(2)


def test_run_system_ate_and_artifacts(tmp_path):
    intr = TIntr(160, 120, 131.25, 131.25, 79.5, 59.5)
    d, c, e, _ = tsyn.render_sequence(8, intrinsic=intr, span=0.5, device="cpu")
    seq = Sequence(intr, d.numpy(), c.numpy())
    cfg = trc.ReconstructionConfig(
        fragment_size=4, n_keyframes_per_n_frame=3, depth_max=4.0, voxel_size=0.02,
        block_count=8192, block_resolution=8, trunc_voxel_multiplier=4.0,
        downsample_voxel_size=0.05, registration_point_capacity=8192,
        fragment_point_capacity=65536, path_output=str(tmp_path / "out"),
    )
    vbg, traj, graph = trc.run_system(seq, cfg, device="cpu")
    gt = (e[0] @ torch.linalg.inv(e)).numpy()
    assert traj.shape == (8, 4, 4)
    ate = trc.absolute_trajectory_error(traj, gt)
    assert ate < 0.05, f"ATE {ate}"
    for rel in ("trajectory.log", "scene/global_registration.json",
                "scene/refined_registration.json", "fragments/fragment_001.json"):
        assert os.path.isfile(os.path.join(cfg.path_output, rel)), rel
    np.testing.assert_allclose(tio.read_trajectory_log(os.path.join(cfg.path_output,
                                                                    "trajectory.log")),
                               traj, atol=1e-6, rtol=0)
    assert graph.poses.shape == (2, 4, 4) and int(vbg.num_active_blocks()) > 50

    mesh = trc.extract_scene_mesh(vbg)
    v = mesh.vertices[mesh.vertex_mask & _referenced(mesh)]
    sdf = tsyn.default_scene_sdf(lie.transform_points(lie.invert_se3(e[0]), v)).abs()
    assert v.shape[0] > 10000
    assert float(sdf.median()) < cfg.voxel_size
    assert float(torch.quantile(sdf, 0.9)) < 2 * cfg.voxel_size

    # the mesh path (tests/test_torch_parallel_pipeline.py) refuses what is
    # not a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        trc.run_system(seq, cfg, mesh=object(), device="cpu")


def _referenced(mesh) -> torch.Tensor:
    used = torch.zeros(mesh.vertices.shape[0], dtype=torch.bool)
    used[mesh.triangles[mesh.triangle_mask].reshape(-1).long()] = True
    return used
