"""IO facade (port of open3d_tpu/io/__init__.py): point clouds, the
VoxelBlockGrid npz checkpoint and pose graphs.

`read_point_cloud` and `write_point_cloud` dispatch on the extension, as in
the JAX package; only `.ply` is ported, and every other format raises
NotImplementedError until the IO formats are ported (ROADMAP item 10). The
grid checkpoint and the pose-graph JSON are the JAX package's formats, so a
file written by either package reads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.io import ply as ply_io
from open3d_tpu_torch.pipelines import pose_graph
from open3d_tpu_torch.io.ply import read_ply, write_ply


def _require_ply(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext != ".ply":
        raise NotImplementedError(f"point cloud format {ext!r} is not ported yet; only .ply is")


def read_point_cloud(path: str, capacity: Optional[int] = None, device=None):
    """A PointCloud from a file, padded to `capacity`, on `device`
    (default: the card)."""
    _require_ply(path)
    data = ply_io.read_ply(path)["vertex"]
    pos = np.stack([data["x"], data["y"], data["z"]], axis=-1)
    kw = {}
    if "nx" in data:
        kw["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], axis=-1)
    if "red" in data:
        kw["colors"] = (
            np.stack([data["red"], data["green"], data["blue"]], axis=-1).astype(np.float32) / 255.0
        )
    return PointCloud.create(pos, capacity=capacity, device=device, **kw)


def write_point_cloud(path: str, pcd) -> None:
    """Write the cloud's valid rows; masked-out rows are dropped."""
    _require_ply(path)
    d = pcd.to_numpy()
    ply_io.write_ply(path, d["positions"], normals=d.get("normals"), colors=d.get("colors"))


def write_voxel_block_grid(path: str, vbg) -> None:
    """npz: {table, tw, color, voxel_size, block_resolution, sdf_trunc},
    the payload flat (C+1, B^3); a grid without colour stores an empty
    (C+1, 0) colour."""
    np.savez_compressed(path, **convert.vbg_to_numpy(vbg))


def read_voxel_block_grid(path: str, device=None):
    """A grid from the npz checkpoint, on `device` (default: the card)."""
    with np.load(path) as d:
        return convert.vbg_from_numpy(**{k: d[k] for k in d.files}, device=device)


def read_pose_graph(path: str, device=None):
    """A PoseGraph from the reference's JSON schema, on `device` (default:
    the card)."""
    return pose_graph.read_pose_graph(path, device=device)


def write_pose_graph(path: str, graph) -> None:
    pose_graph.write_pose_graph(path, graph)


__all__ = ["read_point_cloud", "write_point_cloud", "read_ply", "write_ply",
           "read_voxel_block_grid", "write_voxel_block_grid", "read_pose_graph",
           "write_pose_graph"]
