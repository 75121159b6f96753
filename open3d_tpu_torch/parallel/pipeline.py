"""Distributed reconstruction pipeline stages (port of
open3d_tpu/parallel/pipeline.py) over a 1-D DeviceMesh axis "fragments".

The reference system scales with a multiprocessing.Pool over fragments and
fragment pairs (make_fragments.py:180-186, register_fragments.py:167-171);
the JAX package shards them over a mesh axis. Here every rank receives the
whole input, pads it to a multiple of the axis size as the JAX package
does (padded entries carry valid=False), runs its own contiguous slice one
entry after another, and all-gathers the results, padded rows included:

- stage 1 `make_fragments_sharded`: per fragment, odometry on the chain and
  keyframe loop-closure pairs, the robust pose-graph optimisation, the
  TSDF integrate of every frame into an 8^3-block grid and the surface
  extraction (`_fragment_chain`);
- stage 2 `register_pairs_sharded`: point-to-plane ICP and the information
  matrix per candidate fragment pair;
- stage 3 is parallel/fragments.py's `multiway_gn_step` on the 2-D mesh.

Kernel: the 8^3 integrate of `_fragment_chain` runs the row fuse K3
(ops/kernels/tsdf.py). A padding fragment integrates all-zero depth, so
K3 receives a work list of dump rows only and leaves the grid as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.parallel import multihost
from open3d_tpu_torch.parallel.multihost import _all_gather, _axis_size, _shard
from open3d_tpu_torch.pipelines import odometry as odo
from open3d_tpu_torch.pipelines import pose_graph as pg
from open3d_tpu_torch.pipelines import registration as reg


def make_pipeline_mesh(n_devices: Optional[int] = None, devices=None, device=None):
    """1-D mesh with axis "fragments" over `n_devices` of the group's ranks
    (`devices`, default: all), on `device` (default: the card)."""
    dev = default_device(device)
    ranks = multihost._mesh_ranks(n_devices, devices, dev)
    return multihost.make_mesh(("fragments",), devices=ranks, device=dev)


def _pad_to_multiple(x: torch.Tensor, m: int, fill=0):
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])


class FragmentBatch(NamedTuple):
    """Stage-1 output: fixed-capacity fragment clouds + per-frame poses."""

    positions: torch.Tensor  # (F, P, 3)
    normals: torch.Tensor  # (F, P, 3)
    mask: torch.Tensor  # (F, P) bool
    poses: torch.Tensor  # (F, T, 4, 4) frame -> fragment frame
    valid: torch.Tensor  # (F,) bool: False for padding fragments


def _fragment_edges(T: int, kf: int):
    """Intra-fragment edge list: the odometry chain, then keyframe loop
    closures (every kf-th frame against the frames 2..kf after it; ref:
    make_posegraph_for_fragment, make_fragments.py:60-103). Returns
    (src, tgt, uncertain) as lists."""
    src, tgt, unc = [], [], []
    for i in range(T - 1):
        src.append(i)
        tgt.append(i + 1)
        unc.append(False)
    if kf > 0:
        for i in range(0, T - 1, kf):
            for j in range(i + 2, min(i + kf + 1, T)):
                src.append(i)
                tgt.append(j)
                unc.append(True)
    return src, tgt, unc


def _fragment_chain(
    dep,  # (T, H, W) metric depth, 0 invalid
    col,  # (T, H, W, 3)
    intrinsic: PinholeCameraIntrinsic,
    voxel_size: float,
    block_count: int,
    block_resolution: int,
    point_capacity: int,
    depth_max: float,
    frame_block_capacity: int,
    ok: bool,  # a real fragment (False: padding)
    keyframe_interval: int = 5,
    sdf_trunc: Optional[float] = None,
):
    """Odometry chain + keyframe loop closures -> the fragment's pose-graph
    optimisation (30 LM iterations, the default line-process preference,
    every chain edge kept and a loop closure where its fitness exceeds 0.3)
    -> TSDF integrate -> extract, the JAX package's chain step for step.
    Returns (positions, normals, mask, poses (T, 4, 4))."""
    dev = dep.device
    T = dep.shape[0]
    src, tgt, unc = _fragment_edges(T, keyframe_interval)
    trans, infos, fits = [], [], []
    for si, ti in zip(src, tgt):
        res = odo.rgbd_odometry_multi_scale(
            RGBDImage(color=col[si], depth=dep[si]),
            RGBDImage(color=col[ti], depth=dep[ti]),
            intrinsic,
        )
        infos.append(odo.compute_odometry_information_matrix(
            dep[si], dep[ti], intrinsic, res.transformation))
        # odometry convention: tgt_pt = T @ src_pt -> edge X = inv(T)
        trans.append(lie.invert_se3(res.transformation))
        fits.append(res.fitness)
    trans, infos, fits = torch.stack(trans), torch.stack(infos), torch.stack(fits)
    unc = torch.tensor(unc, dtype=torch.bool, device=dev)
    poses = [torch.eye(4, dtype=torch.float32, device=dev)]
    for X in trans[:T - 1]:  # chain init poses from the odometry edges
        poses.append(poses[-1] @ X)
    graph = pg.PoseGraph(
        poses=torch.stack(poses),
        edges=torch.tensor([src, tgt], dtype=torch.int32, device=dev).T.contiguous(),
        transformations=trans,
        informations=infos,
        uncertain=unc,
        confidence=torch.ones(len(src), dtype=torch.float32, device=dev),
        edge_valid=~unc | (fits > 0.3),
    )
    graph = pg.global_optimization(
        graph,
        pg.GlobalOptimizationOption(max_correspondence_distance=voxel_size * 1.4),
        pg.GlobalOptimizationConvergenceCriteria(max_iteration=30),
    )
    poses = graph.poses

    vbg = vbg_mod.create(voxel_size=voxel_size, block_resolution=block_resolution,
                         block_count=block_count, sdf_trunc=sdf_trunc, with_color=True,
                         device=dev)
    if not ok:  # padding fragments integrate nothing (no touched blocks)
        dep = torch.zeros_like(dep)
    for d, c, pose in zip(dep, col, poses):
        extr = lie.invert_se3(pose)
        keys, _ = vbg_mod.compute_unique_block_coordinates(
            vbg, d, intrinsic, extr, depth_max=depth_max,
            frame_block_capacity=frame_block_capacity,
        )
        # the JAX package takes its XLA fuse here (use_pallas=False); the
        # port has one path, so an 8^3 grid fuses through K3
        vbg = vbg_mod.integrate(vbg, keys, d, c, intrinsic, extr, depth_max=depth_max)
    pcd = vbg_mod.extract_point_cloud(vbg, point_capacity=point_capacity, weight_threshold=2.0)
    return pcd.positions, pcd.attrs["normals"], pcd.mask & ok, poses


def make_fragments_sharded(
    depths: torch.Tensor,  # (F, T, H, W) metric float32, 0 = invalid
    colors: torch.Tensor,  # (F, T, H, W, 3)
    intrinsic: PinholeCameraIntrinsic,
    mesh,
    voxel_size: float = 0.01,
    block_count: int = 4096,
    block_resolution: int = 8,
    point_capacity: int = 32768,
    depth_max: float = 3.0,
    frame_block_capacity: int = 2048,
    keyframe_interval: int = 5,
    sdf_trunc: Optional[float] = None,
) -> FragmentBatch:
    """Stage 1, sharded: each rank builds its fragments end to end, and the
    batch is gathered on every rank. Fragments are padded to a multiple of
    the "fragments" axis; padded entries return valid=False and empty
    clouds."""
    n_dev = _axis_size(mesh, "fragments")
    valid = [True] * depths.shape[0] + [False] * ((-depths.shape[0]) % n_dev)
    depths = _shard(_pad_to_multiple(depths, n_dev), mesh, "fragments")
    colors = _shard(_pad_to_multiple(colors, n_dev), mesh, "fragments")
    mine = _shard(torch.tensor(valid), mesh, "fragments").tolist()
    outs = [
        _fragment_chain(dep, col, intrinsic, voxel_size, block_count, block_resolution,
                        point_capacity, depth_max, frame_block_capacity, ok,
                        keyframe_interval=keyframe_interval, sdf_trunc=sdf_trunc)
        for dep, col, ok in zip(depths, colors, mine)
    ]
    pos, nrm, msk, poses = (_all_gather(torch.stack(x), mesh, "fragments") for x in zip(*outs))
    return FragmentBatch(positions=pos, normals=nrm, mask=msk, poses=poses,
                         valid=torch.tensor(valid, device=pos.device))


class PairRegistrationBatch(NamedTuple):
    """Stage-2 output, one row per candidate pair (padded rows valid=False)."""

    transformations: torch.Tensor  # (E, 4, 4) src -> tgt
    informations: torch.Tensor  # (E, 6, 6)
    fitness: torch.Tensor  # (E,)
    inlier_rmse: torch.Tensor  # (E,)
    valid: torch.Tensor  # (E,) bool


def register_pairs_sharded(
    fragments: FragmentBatch,
    pairs: torch.Tensor,  # (E, 2) int32 (src_fragment, tgt_fragment)
    mesh,
    max_correspondence_distance: float,
    pair_valid: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,  # (E, 4, 4) initial guesses
    max_iteration: int = 30,
) -> PairRegistrationBatch:
    """Stage 2, sharded: point-to-plane ICP + information matrix per
    candidate pair (ref: register_point_cloud_pair,
    register_fragments.py:40-99), each rank its slice of the pairs, the
    results gathered on every rank."""
    dev = fragments.positions.device
    E = pairs.shape[0]
    n_dev = _axis_size(mesh, "fragments")
    pv = torch.ones(E, dtype=torch.bool, device=dev) if pair_valid is None else pair_valid
    pv = _pad_to_multiple(pv, n_dev, False)
    pairs = _pad_to_multiple(pairs, n_dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    if init is None:
        init = eye.expand(E, 4, 4)
    # padding rows must stay a valid pose (identity), not zeros
    init = torch.where(pv[:, None, None], _pad_to_multiple(init, n_dev), eye)

    est = reg.TransformationEstimationPointToPlane()
    crit = reg.ICPConvergenceCriteria(max_iteration=max_iteration)
    outs = []
    for pair, v, T0 in zip(_shard(pairs, mesh, "fragments").tolist(),
                           _shard(pv, mesh, "fragments"), _shard(init, mesh, "fragments")):
        s, t = pair
        src = PointCloud(positions=fragments.positions[s], mask=fragments.mask[s] & v, attrs={})
        tgt = PointCloud(positions=fragments.positions[t], mask=fragments.mask[t] & v,
                         attrs={"normals": fragments.normals[t]})
        res = reg.icp(src, tgt, max_correspondence_distance, init=T0, estimation=est,
                      criteria=crit)
        info = reg.get_information_matrix(src, tgt, max_correspondence_distance,
                                          res.transformation)
        outs.append((res.transformation, info, res.fitness, res.inlier_rmse))
    T, info, fit, rmse = (_all_gather(torch.stack(x), mesh, "fragments") for x in zip(*outs))
    return PairRegistrationBatch(transformations=T, informations=info, fitness=fit,
                                 inlier_rmse=rmse, valid=pv)
