"""Carry state between the JAX package and the port through numpy.

The grid's arrays use the flat (C+1, B^3) schema of the JAX package's
VoxelBlockGrid checkpoint (`write_voxel_block_grid`: table, tw, color,
voxel_size, block_resolution, sdf_trunc), so a checkpoint written by the
JAX package loads here with `vbg_from_numpy(**np.load(path))` and without
importing JAX. Any block resolution carries over: an 8^3 grid's payload is
(C+1, 4, 128) in both packages. Pose graphs carry their seven arrays by
field name, point clouds their full-capacity positions, mask and attributes,
triangle meshes their full-capacity arrays, masks and attribute dicts,
SLAC control grids their table, positions and grid size; a BVH, a VoxelGrid
and an Octree carry their fields by name (an Octree's levels as one
(max_depth, N) array).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.bvh import BVH
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.geometry.voxel_block_grid import VoxelBlockGrid, payload_shape
from open3d_tpu_torch.geometry.voxelgrid import Octree, VoxelGrid
from open3d_tpu_torch.models.dense_slam import SLAMConfig, SLAMModel
from open3d_tpu_torch.pipelines.pose_graph import PoseGraph
from open3d_tpu_torch.pipelines.slac import ControlGrid

POSE_GRAPH_FIELDS = ("poses", "edges", "transformations", "informations", "uncertain",
                     "confidence", "edge_valid")


def pose_graph_from_numpy(arrays: dict, device=None) -> PoseGraph:
    """A PoseGraph from a dict of its seven arrays (POSE_GRAPH_FIELDS)."""
    dev = default_device(device)
    return PoseGraph(**{f: torch.from_numpy(np.array(arrays[f])).to(dev) for f in POSE_GRAPH_FIELDS})


def pose_graph_to_numpy(graph: PoseGraph) -> dict:
    return {f: getattr(graph, f).cpu().numpy() for f in POSE_GRAPH_FIELDS}


def point_cloud_from_numpy(arrays: dict, device=None) -> PointCloud:
    """A PointCloud from {"positions", "mask", attribute: ...} at full
    capacity, rows kept as they are (invalid rows included)."""
    dev = default_device(device)
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()}
    return PointCloud(positions=t.pop("positions"), mask=t.pop("mask"), attrs=t)


def point_cloud_to_numpy(pcd: PointCloud) -> dict:
    out = {"positions": pcd.positions.cpu().numpy(), "mask": pcd.mask.cpu().numpy()}
    out.update({k: v.cpu().numpy() for k, v in pcd.attrs.items()})
    return out


def control_grid_from_numpy(arrays: dict, device=None) -> ControlGrid:
    """A SLAC ControlGrid from {"table", "positions", "grid_size"}."""
    dev = default_device(device)
    return ControlGrid(table=torch.from_numpy(np.array(arrays["table"])).to(dev),
                       positions=torch.from_numpy(np.array(arrays["positions"])).to(dev),
                       grid_size=float(arrays["grid_size"]))


def control_grid_to_numpy(cg: ControlGrid) -> dict:
    return {"table": cg.table.cpu().numpy(), "positions": cg.positions.cpu().numpy(),
            "grid_size": cg.grid_size}


MESH_FIELDS = ("vertices", "triangles", "vertex_mask", "triangle_mask")


def triangle_mesh_from_numpy(arrays: dict, device=None) -> TriangleMesh:
    """A TriangleMesh from {MESH_FIELDS..., "vertex_attrs": {...},
    "triangle_attrs": {...}} at full capacity, rows kept as they are."""
    dev = default_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)

    return TriangleMesh(
        **{f: t(arrays[f]) for f in MESH_FIELDS},
        vertex_attrs={k: t(v) for k, v in arrays.get("vertex_attrs", {}).items()},
        triangle_attrs={k: t(v) for k, v in arrays.get("triangle_attrs", {}).items()},
    )


def triangle_mesh_to_numpy(mesh: TriangleMesh) -> dict:
    out = {f: getattr(mesh, f).cpu().numpy() for f in MESH_FIELDS}
    out["vertex_attrs"] = {k: v.cpu().numpy() for k, v in mesh.vertex_attrs.items()}
    out["triangle_attrs"] = {k: v.cpu().numpy() for k, v in mesh.triangle_attrs.items()}
    return out


def vbg_from_numpy(
    table, tw, color, voxel_size, block_resolution, sdf_trunc, device=None
) -> VoxelBlockGrid:
    """A VoxelBlockGrid from the checkpoint schema's arrays; `tw` and
    `color` may be flat (C+1, B^3) or (C+1, R, L); an empty `color` means
    no colour."""
    dev = default_device(device)
    B3 = int(block_resolution) ** 3
    R, L = payload_shape(B3)
    tw = np.asarray(tw, dtype=np.int32)
    C1 = tw.shape[0]
    color = np.asarray(color, dtype=np.int32)
    col = None if color.size == 0 else torch.from_numpy(color.reshape(C1, R, L).copy()).to(dev)
    return VoxelBlockGrid(
        table=torch.from_numpy(np.asarray(table, dtype=np.int32).copy()).to(dev),
        tw=torch.from_numpy(tw.reshape(C1, R, L).copy()).to(dev),
        color=col,
        voxel_size=float(voxel_size),
        block_resolution=int(block_resolution),
        sdf_trunc=float(sdf_trunc),
    )


def vbg_to_numpy(vbg: VoxelBlockGrid) -> dict:
    """The checkpoint schema's arrays (flat payload), as numpy."""
    C1 = vbg.tw.shape[0]
    color = (
        np.zeros((C1, 0), np.int32)
        if vbg.color is None
        else vbg.color.reshape(C1, -1).cpu().numpy()
    )
    return {
        "table": vbg.table.cpu().numpy(),
        "tw": vbg.tw.reshape(C1, -1).cpu().numpy(),
        "color": color,
        "voxel_size": np.float64(vbg.voxel_size),
        "block_resolution": np.int64(vbg.block_resolution),
        "sdf_trunc": np.float64(vbg.sdf_trunc),
    }


def slam_model_from_numpy(state: dict, device=None) -> SLAMModel:
    """A SLAMModel from `slam_model_to_numpy`'s dict: the grid's arrays,
    T_frame_to_world (4, 4), frame_id and config (a dict of SLAMConfig's
    fields)."""
    dev = default_device(device)
    vbg = vbg_from_numpy(
        state["table"], state["tw"], state["color"], state["voxel_size"],
        state["block_resolution"], state["sdf_trunc"], device=dev,
    )
    return SLAMModel(
        vbg=vbg,
        T_frame_to_world=torch.tensor(
            np.asarray(state["T_frame_to_world"], np.float32), device=dev
        ),
        frame_id=int(state["frame_id"]),
        config=SLAMConfig(**dict(state["config"])),
    )


def slam_model_to_numpy(model: SLAMModel) -> dict:
    out = vbg_to_numpy(model.vbg)
    out["T_frame_to_world"] = model.T_frame_to_world.cpu().numpy()
    out["frame_id"] = np.int64(model.frame_id)
    out["config"] = dataclasses.asdict(model.config)
    return out


def _tensor(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dev)


def bvh_from_numpy(arrays: dict, device=None) -> BVH:
    """A BVH from a dict of its fields (BVH._fields)."""
    dev = default_device(device)
    return BVH(**{f: int(arrays[f]) if f == "n_leaves" else _tensor(arrays[f], dev)
                  for f in BVH._fields})


def bvh_to_numpy(bvh: BVH) -> dict:
    return {f: int(v) if f == "n_leaves" else v.cpu().numpy() for f, v in bvh._asdict().items()}


VOXEL_GRID_FIELDS = ("coords", "colors", "num_voxels", "origin")


def voxel_grid_from_numpy(arrays: dict, device=None) -> VoxelGrid:
    """A VoxelGrid from {VOXEL_GRID_FIELDS..., "voxel_size"}."""
    dev = default_device(device)
    return VoxelGrid(**{f: _tensor(arrays[f], dev) for f in VOXEL_GRID_FIELDS},
                     voxel_size=float(arrays["voxel_size"]))


def voxel_grid_to_numpy(grid: VoxelGrid) -> dict:
    out = {f: getattr(grid, f).cpu().numpy() for f in VOXEL_GRID_FIELDS}
    out["voxel_size"] = grid.voxel_size
    return out


def octree_from_numpy(arrays: dict, device=None) -> Octree:
    """An Octree from {"point_codes", "point_order", "level_codes" (a
    sequence of (N,) arrays or one (max_depth, N) array), "level_counts",
    "origin", "size", "max_depth"}."""
    dev = default_device(device)
    return Octree(point_codes=_tensor(arrays["point_codes"], dev),
                  point_order=_tensor(arrays["point_order"], dev),
                  level_codes=tuple(_tensor(c, dev) for c in arrays["level_codes"]),
                  level_counts=tuple(_tensor(c, dev) for c in arrays["level_counts"]),
                  origin=_tensor(arrays["origin"], dev), size=float(arrays["size"]),
                  max_depth=int(arrays["max_depth"]))


def octree_to_numpy(tree: Octree) -> dict:
    return {"point_codes": tree.point_codes.cpu().numpy(),
            "point_order": tree.point_order.cpu().numpy(),
            "level_codes": np.stack([c.cpu().numpy() for c in tree.level_codes]),
            "level_counts": np.stack([c.cpu().numpy() for c in tree.level_counts]),
            "origin": tree.origin.cpu().numpy(), "size": tree.size, "max_depth": tree.max_depth}
