"""Port parity for tools/cli.py, the command line the system starts from.

Bars:
- `info` and `convert` on a PLY cloud and an OBJ mesh print what the JAX
  package's command prints, and `convert` writes the same bytes;
- `slam --device cpu --frames 3` on a 160x120 TUM directory (8 frames of
  the synthetic room, span 0.5, written by the port): its trajectory.log
  equals, byte for byte, the one written from the port's own slam_step
  loop over the decoded frames, and it writes mesh.ply;
- `reconstruct`: tests/test_torch_cli_reconstruct.py.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from open3d_tpu.tools import cli as jcli
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.data import dataset as tds
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.models import dense_slam
from open3d_tpu_torch.tools import cli as tcli

INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tum"))
    d, c, e, _ = tsyn.render_sequence(8, intrinsic=TIntr(*INTR), span=0.5, device="cpu")
    return tds.write_tum_sequence(out, d, c, np.linalg.inv(e.numpy()), TIntr(*INTR))


@pytest.fixture()
def files(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    ply = str(tmp_path / "cloud.ply")
    tio.write_point_cloud(ply, PointCloud.create(pts, normals=pts / np.linalg.norm(
        pts, axis=1, keepdims=True), device="cpu"))
    obj = str(tmp_path / "m.obj")
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]], np.float32)
    t = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    tio.write_triangle_mesh(obj, TriangleMesh.create(v, t, device="cpu"))
    return ply, obj


@pytest.mark.parametrize("which", [0, 1], ids=["ply", "obj"])
def test_info_prints_what_the_reference_prints(files, capsys, which):
    path = files[which]
    jcli.main(["info", path])
    want = capsys.readouterr().out
    tcli.main(["info", path, "--device", "cpu"])
    assert capsys.readouterr().out == want and want


@pytest.mark.parametrize("which,ext", [(0, ".ply"), (1, ".ply")], ids=["cloud", "mesh"])
def test_convert_writes_what_the_reference_writes(files, tmp_path, capsys, which, ext):
    src = files[which]
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    args = ["--points"] if which == 0 else []
    jcli.main(["convert", src, b, *args])
    want = capsys.readouterr().out
    tcli.main(["convert", src, a, *args, "--device", "cpu"])
    assert capsys.readouterr().out == want.replace(b, a)
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_slam_command_equals_the_slam_step_loop(tum_dir, tmp_path, capsys):
    out = str(tmp_path / "slam")
    torch.set_num_threads(2)  # the command and the loop on the same threads
    tcli.main(["slam", tum_dir, "--device", "cpu", "--frames", "3", "--output", out])
    assert "wrote" in capsys.readouterr().out
    assert os.path.getsize(os.path.join(out, "mesh.ply")) > 1000

    seq = tds.load_tum_sequence(tum_dir)
    cfg = dense_slam.SLAMConfig()
    model = dense_slam.create_model(cfg, device="cpu")
    md = None
    poses = []
    for i in range(3):
        depth, color = (torch.from_numpy(x) for x in seq.read_frame(i))
        depth = torch.where((depth > 0) & (depth < cfg.depth_max), depth, 0.0)
        md = torch.zeros_like(depth) if md is None else md
        res = dense_slam.slam_step(model, depth, color, md, seq.intrinsic)
        model, md = res.model, res.raycast_depth
        poses.append(model.T_frame_to_world.numpy())
    tio.write_trajectory_log(str(tmp_path / "loop.log"), np.stack(poses))
    assert Path(out, "trajectory.log").read_bytes() == (tmp_path / "loop.log").read_bytes()
    gt = seq.gt_trajectory
    truth = np.linalg.inv(gt[0]) @ gt[:3]
    assert np.abs(np.stack(poses)[:, :3, 3] - truth[:, :3, 3]).max() < 0.05
