"""IO facade (port of open3d_tpu/io/__init__.py): point clouds, triangle
meshes, images (PNG, JPEG through PIL; io/image_io.py), camera
trajectories, the VoxelBlockGrid npz checkpoint and pose graphs.

`read_point_cloud` and `write_point_cloud` dispatch on the extension as the
JAX package does: .ply, .pcd (io/pcd.py), .xyz, .xyzn, .pts, .npz and
.splat (io/splat.py). Triangle meshes: .ply, .obj, .stl, .off, .gltf and
.glb (io/mesh_formats.py). Any other extension raises ValueError. Every
format is the JAX package's, so a file written by either package reads in
the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.io import mesh_formats
from open3d_tpu_torch.io import pcd as pcd_io
from open3d_tpu_torch.io import ply as ply_io
from open3d_tpu_torch.io import splat as splat_io
from open3d_tpu_torch.io.image_io import read_depth, read_image, write_depth, write_image
from open3d_tpu_torch.io.ply import read_ply, write_ply
from open3d_tpu_torch.io.trajectory import (
    read_trajectory_log,
    read_trajectory_tum,
    write_trajectory_log,
    write_trajectory_tum,
)
from open3d_tpu_torch.pipelines import pose_graph


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def _rgb(r, g, b) -> np.ndarray:
    return np.stack([r, g, b], axis=-1).astype(np.float32) / 255.0


def read_point_cloud(path: str, capacity: Optional[int] = None, device=None):
    """A PointCloud from a file, padded to `capacity`, on `device`
    (default: the card)."""
    ext = _ext(path)
    kw = {}
    if ext == ".ply":
        data = ply_io.read_ply(path)["vertex"]
        pos = np.stack([data["x"], data["y"], data["z"]], axis=-1)
        if "nx" in data:
            kw["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], axis=-1)
        if "red" in data:
            kw["colors"] = _rgb(data["red"], data["green"], data["blue"])
        return PointCloud.create(pos, capacity=capacity, device=device, **kw)
    if ext == ".pcd":
        data = pcd_io.read_pcd(path)
        pos = np.stack([data["x"], data["y"], data["z"]], axis=-1)
        if "normal_x" in data:
            kw["normals"] = np.stack([data["normal_x"], data["normal_y"], data["normal_z"]],
                                     axis=-1)
        if "rgb" in data:
            rgb = data["rgb"].view(np.uint32)
            kw["colors"] = _rgb(rgb >> 16 & 255, rgb >> 8 & 255, rgb & 255)
        return PointCloud.create(pos, capacity=capacity, device=device, **kw)
    if ext in (".xyz", ".xyzn", ".pts"):
        arr = np.loadtxt(path, dtype=np.float32, ndmin=2)
        if ext == ".xyzn" and arr.shape[1] >= 6:
            kw["normals"] = arr[:, 3:6]
        return PointCloud.create(arr[:, :3], capacity=capacity, device=device, **kw)
    if ext == ".npz":
        with np.load(path) as d:
            kw = {k: d[k] for k in d.files if k not in ("positions", "mask")}
            return PointCloud.create(d["positions"], capacity=capacity,
                                     mask=d["mask"] if "mask" in d.files else None,
                                     device=device, **kw)
    if ext == ".splat":
        return splat_io.read_splat(path, capacity=capacity, device=device)
    raise ValueError(f"unsupported point cloud format: {ext}")


def write_point_cloud(path: str, pcd) -> None:
    """Write the cloud's valid rows; masked-out rows are dropped. Text
    formats print 7 decimals."""
    ext = _ext(path)
    d = pcd.to_numpy()
    pos = d["positions"]
    normals = d.get("normals")
    if ext == ".ply":
        ply_io.write_ply(path, pos, normals=normals, colors=d.get("colors"))
    elif ext == ".pcd":
        pcd_io.write_pcd(path, pos, normals=normals, colors=d.get("colors"))
    elif ext in (".xyz", ".pts"):
        np.savetxt(path, pos, fmt="%.7f")
    elif ext == ".xyzn":
        nn = normals if normals is not None else np.zeros_like(pos)
        np.savetxt(path, np.concatenate([pos, nn], axis=1), fmt="%.7f")
    elif ext == ".npz":
        np.savez(path, **d)
    elif ext == ".splat":
        splat_io.write_splat(path, pcd)
    else:
        raise ValueError(f"unsupported point cloud format: {ext}")


def read_triangle_mesh(path: str, device=None):
    """A TriangleMesh from .ply (vertices, faces, colours, normals), .obj
    (polygons fan-triangulated), .stl (welded), .off, .gltf or .glb, on
    `device` (default: the card)."""
    ext = _ext(path)
    if ext == ".ply":
        data = ply_io.read_ply(path)
        v = data["vertex"]
        pos = np.stack([v["x"], v["y"], v["z"]], axis=-1)
        face = data.get("face", {})
        tris = face.get("vertex_indices", face.get("vertex_index"))
        vattrs = {}
        if "red" in v:
            vattrs["colors"] = _rgb(v["red"], v["green"], v["blue"])
        if "nx" in v:
            vattrs["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1)
        return TriangleMesh.create(pos, np.asarray(tris, np.int32), vertex_attrs=vattrs,
                                   device=device)
    if ext == ".obj":
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
        verts, tris = np.asarray(verts, np.float32), np.asarray(tris, np.int32)
    elif ext == ".stl":
        verts, tris = mesh_formats.read_stl(path)
    elif ext == ".off":
        verts, tris = mesh_formats.read_off(path)
    elif ext in (".gltf", ".glb"):
        verts, tris = mesh_formats.read_glb(path)
    else:
        raise ValueError(f"unsupported mesh format: {ext}")
    return TriangleMesh.create(verts, tris, device=device)


def write_triangle_mesh(path: str, mesh) -> None:
    """The mesh's live triangles over its merged vertices (`compact`)."""
    ext = _ext(path)
    if ext not in (".ply", ".obj", ".stl", ".off", ".gltf", ".glb"):
        raise ValueError(f"unsupported mesh format: {ext}")
    verts, tris = mesh.compact()
    if ext == ".ply":
        ply_io.write_ply(path, verts, triangles=tris)
    elif ext == ".obj":
        with open(path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.7f} {v[1]:.7f} {v[2]:.7f}\n")
            for t in tris:
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    elif ext == ".stl":
        mesh_formats.write_stl(path, verts, tris)
    elif ext == ".off":
        mesh_formats.write_off(path, verts, tris)
    else:
        mesh_formats.write_glb(path, verts, tris)


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
