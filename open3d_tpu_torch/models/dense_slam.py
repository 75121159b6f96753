"""Dense RGB-D SLAM: frame-to-model tracking over a TSDF voxel block grid
(port of open3d_tpu/models/dense_slam.py).

Each frame: track the input depth against the last model raycast
(point-to-plane odometry), update the pose, integrate the frame, raycast
the model from the new pose for the next frame.

The JAX package jits the whole step and donates the grid; here the step
runs eagerly and the grid's payload tensors are updated in place, so the
SLAMModel passed in shares its grid with the one returned. Pose, fitness
and the frame-0 and tracking-failure rules stay on the device (torch.where);
the host syncs only inside the odometry and hash loops.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.geometry.voxel_block_grid import VoxelBlockGrid
from open3d_tpu_torch.pipelines import odometry as odom


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Same fields and defaults as the JAX package's SLAMConfig."""

    voxel_size: float = 3.0 / 512
    block_resolution: int = 16
    block_count: int = 40960
    depth_scale: float = 1000.0
    depth_min: float = 0.1
    depth_max: float = 3.0
    trunc_voxel_multiplier: float = 8.0
    odometry_method: str = odom.POINT_TO_PLANE
    frame_block_capacity: int = 4096
    # the JAX package's sphere-trace step count; the port raycasts by the
    # tile march, which has none, so it reads this field nowhere. It stays so
    # that a JAX model's config carries over field for field.
    raycast_max_steps: int = 96
    with_color: bool = True
    raycast_color: bool = False
    raycast_normals: bool = False
    model_raycast_stride: int = 1


@dataclasses.dataclass
class SLAMModel:
    vbg: VoxelBlockGrid
    T_frame_to_world: torch.Tensor  # (4, 4) f32 on the grid's device
    frame_id: int
    config: SLAMConfig


class FrameResult(NamedTuple):
    model: SLAMModel
    tracking_ok: torch.Tensor  # () bool
    fitness: torch.Tensor
    inlier_rmse: torch.Tensor
    raycast_depth: torch.Tensor  # (H, W) model frame for the NEXT track
    raycast_color: torch.Tensor  # (H, W, 3)
    raycast_normal: Optional[torch.Tensor]
    touched_blocks: torch.Tensor  # () int32 pre-clamp touch count


def create_model(
    config: SLAMConfig = SLAMConfig(), T_init: Optional[torch.Tensor] = None, device=None
) -> SLAMModel:
    if config.model_raycast_stride not in (1, 2, 4, 8):
        raise ValueError(
            "model_raycast_stride must be a power of two in {1,2,4,8}: the "
            "tracking input downsamples through halving pyrdown levels"
        )
    dev = default_device(device)
    vbg = vbg_mod.create(
        voxel_size=config.voxel_size,
        block_resolution=config.block_resolution,
        block_count=config.block_count,
        sdf_trunc=config.trunc_voxel_multiplier * config.voxel_size,
        with_color=config.with_color,
        device=dev,
    )
    T = (
        torch.eye(4, dtype=torch.float32, device=dev)
        if T_init is None
        else torch.as_tensor(T_init, dtype=torch.float32).to(dev)
    )
    return SLAMModel(vbg=vbg, T_frame_to_world=T, frame_id=0, config=config)


def synthesize_model_frame(model: SLAMModel, intrinsic: PinholeCameraIntrinsic):
    """Raycast the TSDF from the current pose."""
    cfg = model.config
    if cfg.model_raycast_stride > 1:
        intrinsic = intrinsic.scaled(1.0 / cfg.model_raycast_stride)
    extrinsic = lie.invert_se3(model.T_frame_to_world)
    return vbg_mod.raycast(
        model.vbg,
        intrinsic,
        extrinsic,
        depth_min=cfg.depth_min,
        depth_max=cfg.depth_max,
        max_steps=cfg.raycast_max_steps,
        with_color=cfg.with_color and cfg.raycast_color,
        with_normals=cfg.raycast_normals,
    )


def track_frame_to_model(
    model: SLAMModel,
    input_depth: torch.Tensor,
    model_depth: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    criteria=(
        odom.OdometryConvergenceCriteria(6),
        odom.OdometryConvergenceCriteria(3),
        odom.OdometryConvergenceCriteria(1),
    ),
    model_normals=None,
) -> odom.OdometryResult:
    """Frame-to-model odometry: source = input frame, target = the model
    raycast at the previous pose; T maps input-frame points into it."""
    stride = model.config.model_raycast_stride
    if stride > 1:
        for _ in range(int(stride).bit_length() - 1):
            input_depth = im.pyrdown_depth(input_depth)
        intrinsic = intrinsic.scaled(1.0 / stride)
    src = RGBDImage(color=torch.zeros_like(input_depth), depth=input_depth)
    tgt = RGBDImage(color=torch.zeros_like(model_depth), depth=model_depth)
    return odom.rgbd_odometry_multi_scale(
        src, tgt, intrinsic,
        method=model.config.odometry_method,
        criteria=criteria,
        target_normals=model_normals,
    )


def integrate_frame(
    model: SLAMModel,
    depth: torch.Tensor,
    color: Optional[torch.Tensor],
    intrinsic: PinholeCameraIntrinsic,
):
    """Touch + integrate. Returns (model, touched_count), the count taken
    before the frame_block_capacity clamp so truncation is detectable."""
    cfg = model.config
    extrinsic = lie.invert_se3(model.T_frame_to_world)
    keys, touched = vbg_mod.compute_unique_block_coordinates(
        model.vbg, depth, intrinsic, extrinsic,
        depth_max=cfg.depth_max,
        frame_block_capacity=cfg.frame_block_capacity,
    )
    new_vbg = vbg_mod.integrate(
        model.vbg, keys, depth, color, intrinsic, extrinsic, depth_max=cfg.depth_max
    )
    return dataclasses.replace(model, vbg=new_vbg), touched


def slam_step(
    model: SLAMModel,
    depth: torch.Tensor,  # metric f32 (already clip_transform'ed)
    color: Optional[torch.Tensor],
    model_depth: torch.Tensor,  # raycast from the previous step (zeros on frame 0)
    intrinsic: PinholeCameraIntrinsic,
    fitness_threshold: float = 0.1,
    model_normal: Optional[torch.Tensor] = None,
) -> FrameResult:
    """One dense-SLAM frame: track -> update pose -> integrate -> raycast.
    A tracking failure (fitness below the threshold) keeps the previous
    pose; frame 0 keeps the initial pose."""
    is_first = model.frame_id == 0
    result = track_frame_to_model(model, depth, model_depth, intrinsic, model_normals=model_normal)
    eye = torch.eye(4, dtype=torch.float32, device=depth.device)
    ok = (result.fitness > fitness_threshold) & (not is_first)
    delta = torch.where(ok, result.transformation, eye)
    # the delta maps new-frame points into the previous frame (src -> tgt)
    T_new = model.T_frame_to_world @ (eye if is_first else delta)
    model = dataclasses.replace(model, T_frame_to_world=T_new)

    model, touched = integrate_frame(model, depth, color, intrinsic)
    ray = synthesize_model_frame(model, intrinsic)
    model = dataclasses.replace(model, frame_id=model.frame_id + 1)
    return FrameResult(
        model=model,
        tracking_ok=ok | is_first,
        fitness=result.fitness,
        inlier_rmse=result.inlier_rmse,
        raycast_depth=ray.depth,
        raycast_color=ray.color,
        raycast_normal=ray.normal,
        touched_blocks=touched,
    )
