"""RGB-D image pair and unprojection to point clouds (port of
open3d_tpu/geometry/rgbd.py).

`pointcloud_from_depth` unprojects a depth (and colour) image into a
fixed-capacity world-frame cloud; `project_to_rgbd` splats a cloud back
into a depth (and colour) image with a scatter-min z-buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_tpu_torch.core.masking import FAR_COORD, _scatter_add
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.image import create_vertex_map
from open3d_tpu_torch.geometry.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class RGBDImage:
    color: torch.Tensor  # (H, W, 3) float32 in [0, 1] (or (H, W) intensity)
    depth: torch.Tensor  # (H, W) float32 metric; 0 = invalid


def pointcloud_from_depth(
    depth: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: Optional[torch.Tensor] = None,
    stride: int = 1,
    color: Optional[torch.Tensor] = None,
) -> PointCloud:
    """Unproject a depth (+ colour) image into a world-frame cloud of
    capacity (H/stride)(W/stride), masked by depth validity. `extrinsic`
    is world -> camera; without it the points stay in the camera frame."""
    d = depth[::stride, ::stride]
    vm = create_vertex_map(d, intrinsic.scaled(1.0 / stride) if stride > 1 else intrinsic)
    pts = vm.reshape(-1, 3)
    valid = (d > 0.0).reshape(-1)
    if extrinsic is not None:
        E = extrinsic.to(device=pts.device, dtype=torch.float32)
        pts = (pts - E[:3, 3]) @ E[:3, :3]  # world = R^T (cam - t)
    pts = torch.where(valid[:, None], pts, FAR_COORD)
    attrs = {}
    if color is not None:
        c = color[::stride, ::stride]
        attrs["colors"] = c.reshape(-1, c.shape[-1]) if c.ndim == 3 else c.reshape(-1, 1)
    return PointCloud(positions=pts, mask=valid, attrs=attrs)


def pointcloud_from_rgbd(
    rgbd: RGBDImage,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> PointCloud:
    return pointcloud_from_depth(rgbd.depth, intrinsic, extrinsic, stride, color=rgbd.color)


def project_to_rgbd(
    pcd: PointCloud,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: Optional[torch.Tensor] = None,
    depth_max: float = 10.0,
) -> RGBDImage:
    """Splat a cloud into a depth (+ colour) image: the nearest point of a
    pixel wins (scatter-min); its colour is the mean of the points within
    1e-6 m of the winning depth."""
    H, W = intrinsic.height, intrinsic.width
    pts = pcd.positions
    dev = pts.device
    if extrinsic is not None:
        E = extrinsic.to(device=dev, dtype=torch.float32)
        pts = pts @ E[:3, :3].T + E[:3, 3]
    z = pts[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = torch.round(pts[:, 0] / zs * intrinsic.fx + intrinsic.cx).to(torch.int32)
    v = torch.round(pts[:, 1] / zs * intrinsic.fy + intrinsic.cy).to(torch.int32)
    ok = pcd.mask & (z > 0) & (z < depth_max) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    flat = torch.where(ok, v * W + u, H * W).to(torch.int64)  # the rest into a dump slot
    depth = torch.full((H * W + 1,), float("inf"), dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, flat, torch.where(ok, z, float("inf")), "amin")
    depth_img = depth[: H * W].reshape(H, W)
    depth_img = torch.where(torch.isfinite(depth_img), depth_img, 0.0)
    colors = pcd.colors
    if colors is not None:
        win = ok & (z <= depth[torch.clamp(flat, 0, H * W - 1)] + 1e-6)
        cbuf = _scatter_add(torch.where(win[:, None], colors.to(torch.float32), 0.0), flat,
                            H * W + 1)
        wbuf = _scatter_add(win[:, None].to(torch.float32), flat, H * W + 1)
        color_img = (cbuf[: H * W] / torch.clamp(wbuf[: H * W], min=1.0)).reshape(H, W, -1)
    else:
        color_img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    return RGBDImage(color=color_img, depth=depth_img)
