"""IO facade (port of open3d_tpu/io/__init__.py): point clouds, triangle
meshes, images (PNG, io/image_io.py), camera trajectories, the
VoxelBlockGrid npz checkpoint and pose graphs.

`read_point_cloud` and `write_point_cloud` dispatch on the extension, as in
the JAX package; only `.ply` is ported, and every other format raises
NotImplementedError until the IO formats are ported (ROADMAP item 10).
Triangle meshes read and write `.ply` and `.obj`; STL, OFF and glTF raise
NotImplementedError likewise. The grid checkpoint, the pose-graph JSON and
the trajectory files are the JAX package's formats, so a file written by
either package reads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.io import ply as ply_io
from open3d_tpu_torch.io.image_io import read_depth, read_image, write_depth, write_image
from open3d_tpu_torch.io.ply import read_ply, write_ply
from open3d_tpu_torch.io.trajectory import (
    read_trajectory_log,
    read_trajectory_tum,
    write_trajectory_log,
    write_trajectory_tum,
)
from open3d_tpu_torch.pipelines import pose_graph

_QUEUED_MESH_FORMATS = (".stl", ".off", ".gltf", ".glb")


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


def _mesh_ext(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in _QUEUED_MESH_FORMATS:
        raise NotImplementedError(f"mesh format {ext!r} is not ported yet; .ply and .obj are")
    if ext not in (".ply", ".obj"):
        raise ValueError(f"unsupported mesh format: {ext}")
    return ext


def read_triangle_mesh(path: str, device=None):
    """A TriangleMesh from a .ply (vertices, faces, colours, normals) or
    .obj (vertices and faces, polygons fan-triangulated) file, on `device`
    (default: the card)."""
    if _mesh_ext(path) == ".ply":
        data = ply_io.read_ply(path)
        v = data["vertex"]
        pos = np.stack([v["x"], v["y"], v["z"]], axis=-1)
        face = data.get("face", {})
        tris = face.get("vertex_indices", face.get("vertex_index"))
        vattrs = {}
        if "red" in v:
            vattrs["colors"] = (
                np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32) / 255.0
            )
        if "nx" in v:
            vattrs["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1)
        return TriangleMesh.create(pos, np.asarray(tris, np.int32), vertex_attrs=vattrs,
                                   device=device)
    verts, tris = [], []
    with open(path) as f:
        for ln in f:
            p = ln.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                ids = [int(t.split("/")[0]) - 1 for t in p[1:]]
                for k in range(1, len(ids) - 1):  # fan-triangulate
                    tris.append([ids[0], ids[k], ids[k + 1]])
    return TriangleMesh.create(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                               device=device)


def write_triangle_mesh(path: str, mesh) -> None:
    """The mesh's live triangles over its merged vertices (`compact`)."""
    ext = _mesh_ext(path)
    verts, tris = mesh.compact()
    if ext == ".ply":
        ply_io.write_ply(path, verts, triangles=tris)
        return
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.7f} {v[1]:.7f} {v[2]:.7f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


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


__all__ = ["read_point_cloud", "write_point_cloud", "read_triangle_mesh",
           "write_triangle_mesh", "read_ply", "write_ply", "read_trajectory_log",
           "write_trajectory_log", "read_trajectory_tum", "write_trajectory_tum",
           "read_voxel_block_grid", "write_voxel_block_grid", "read_pose_graph",
           "write_pose_graph", "read_image", "write_image", "read_depth", "write_depth"]
