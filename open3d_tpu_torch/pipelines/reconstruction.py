"""Offline reconstruction system, stage 1 (port of the make_fragments path
of open3d_tpu/pipelines/reconstruction.py).

Per fragment of `fragment_size` frames: HYBRID (or the configured) RGB-D
odometry on consecutive pairs and on keyframe loop-closure pairs, an
information matrix per edge, the robust pose-graph optimisation, a TSDF
integrate of every frame into an 8^3-block fragment grid (the row fuse K3,
`ops/kernels/tsdf.py`), and the fragment point cloud. Each fragment writes
`fragments/fragment_NNN.ply` and its pose graph `fragment_NNN.json`, so a
rerun skips what exists, as in the JAX package.

A sequence is any object with `intrinsic`, `__len__` and
`read_frame(i) -> (depth (H, W), color (H, W, 3))`, numpy or torch; frames
move to `device` (default: the card). Stages 2-4 (register, refine,
integrate scene) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from open3d_tpu_torch import io as pcio
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.pipelines import odometry as odo
from open3d_tpu_torch.pipelines import pose_graph as pg


@dataclasses.dataclass
class ReconstructionConfig:
    """Knob names follow t_reconstruction_system/default_config.yml."""

    name: str = "reconstruction"
    fragment_size: int = 40
    n_keyframes_per_n_frame: int = 5
    depth_scale: float = 1000.0
    depth_max: float = 3.0
    voxel_size: float = 0.0058
    block_count: int = 40000
    block_resolution: int = 16
    trunc_voxel_multiplier: float = 8.0
    odometry_method: str = "hybrid"  # point_to_plane | intensity | hybrid
    icp_method: str = "point_to_plane"  # point_to_point | point_to_plane | colored
    global_registration: str = "ransac"  # ransac | fgr
    preference_loop_closure_odometry: float = 0.1
    preference_loop_closure_registration: float = 5.0
    downsample_voxel_size: float = 0.02
    fragment_point_capacity: int = 131072
    registration_point_capacity: int = 16384
    path_dataset: str = ""
    path_output: str = "output"

    @staticmethod
    def from_yaml(path: str) -> "ReconstructionConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(ReconstructionConfig)}
        return ReconstructionConfig(**{k: v for k, v in d.items() if k in known})

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f)


def _fragment_dir(cfg):
    d = os.path.join(cfg.path_output, "fragments")
    os.makedirs(d, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# Stage 1: make fragments
# ---------------------------------------------------------------------------


def _fragment_ranges(n_frames: int, fragment_size: int):
    return [(s, min(s + fragment_size, n_frames)) for s in range(0, n_frames, fragment_size)]


def make_fragments(sequence, cfg: ReconstructionConfig, mesh=None, device=None) -> List[str]:
    """Stage 1, one fragment after another on `device`. Returns the fragment
    PLY paths; fragments whose PLY exists are skipped. `mesh` (the JAX
    package's data-parallel stage 1) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError("the sharded stage 1 is not ported yet")
    dev = default_device(device)
    frag_dir = _fragment_dir(cfg)
    ranges = _fragment_ranges(len(sequence), cfg.fragment_size)
    paths = [os.path.join(frag_dir, f"fragment_{fid:03d}.ply") for fid in range(len(ranges))]
    for fid, (s, e) in enumerate(ranges):
        if not os.path.isfile(paths[fid]):
            _process_single_fragment(sequence, cfg, fid, s, e, frag_dir, paths[fid], dev)
    return paths


def _odometry_pair(src_rgbd, tgt_rgbd, intr, cfg, init=None):
    res = odo.rgbd_odometry_multi_scale(
        src_rgbd, tgt_rgbd, intr, init=init, method=cfg.odometry_method
    )
    info = odo.compute_odometry_information_matrix(
        src_rgbd.depth, tgt_rgbd.depth, intr, res.transformation
    )
    return res, info


def _to_device(x, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=dev, dtype=torch.float32)


def _read_rgbd(sequence, i, cfg, dev) -> RGBDImage:
    depth, color = (_to_device(x, dev) for x in sequence.read_frame(i))
    depth = torch.where((depth > 0) & (depth < cfg.depth_max), depth, 0.0)
    return RGBDImage(color=color, depth=depth)


def _fragment_pose_graph(rgbds, intr, cfg, dev) -> pg.PoseGraph:
    """Odometry chain + keyframe loop closures, optimised (ref:
    make_posegraph_for_fragment, make_fragments.py:60-103)."""
    n = len(rgbds)
    edges, trans, infos, unc = [], [], [], []
    odom = [np.eye(4, dtype=np.float32)]
    kf = cfg.n_keyframes_per_n_frame
    for i in range(n - 1):
        res, info = _odometry_pair(rgbds[i], rgbds[i + 1], intr, cfg)
        T = res.transformation.cpu().numpy()
        edges.append((i, i + 1))
        # odometry convention: tgt_pt = T @ src_pt -> pose_{i+1} = pose_i @ inv(T)
        trans.append(np.linalg.inv(T))
        infos.append(info.cpu().numpy())
        unc.append(False)
        odom.append(odom[-1] @ np.linalg.inv(T))
        if kf > 0 and i % kf == 0:
            for j in range(i + 2, min(i + kf + 1, n)):
                res2, info2 = _odometry_pair(rgbds[i], rgbds[j], intr, cfg)
                if float(res2.fitness) > 0.3:
                    edges.append((i, j))
                    trans.append(np.linalg.inv(res2.transformation.cpu().numpy()))
                    infos.append(info2.cpu().numpy())
                    unc.append(True)

    graph = pg.PoseGraph.create(
        np.stack(odom), np.asarray(edges, np.int32), np.stack(trans),
        informations=np.stack(infos), uncertain=np.asarray(unc), device=dev,
    )
    return pg.global_optimization(
        graph,
        pg.GlobalOptimizationOption(
            max_correspondence_distance=cfg.voxel_size * 1.4,
            preference_loop_closure=cfg.preference_loop_closure_odometry,
        ),
    )


def create_fragment_grid(cfg: ReconstructionConfig, device) -> vbg_mod.VoxelBlockGrid:
    """The fragment-level grid: twice the scene voxel, 8^3 blocks."""
    return vbg_mod.create(
        voxel_size=cfg.voxel_size * 2,
        block_resolution=8,
        block_count=min(cfg.block_count, 8192),
        sdf_trunc=cfg.trunc_voxel_multiplier * cfg.voxel_size,
        with_color=True,
        device=device,
    )


def integrate_fragment_frame(vbg, rgbd: RGBDImage, pose, intr, cfg):
    """Touch, activate and fuse one frame at its frame -> world `pose`
    (ref: integrate_rgb_frames_for_fragment, make_fragments.py:108)."""
    extr = torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32).to(vbg.device)
    keys, _ = vbg_mod.compute_unique_block_coordinates(
        vbg, rgbd.depth, intr, extr, depth_max=cfg.depth_max, frame_block_capacity=4096,
    )
    return vbg_mod.integrate(vbg, keys, rgbd.depth, rgbd.color, intr, extr, depth_max=cfg.depth_max)


def _process_single_fragment(sequence, cfg, fid, s, e, frag_dir, ply_path, dev):
    intr = sequence.intrinsic
    rgbds = [_read_rgbd(sequence, i, cfg, dev) for i in range(s, e)]
    graph = _fragment_pose_graph(rgbds, intr, cfg, dev)
    pg.write_pose_graph(os.path.join(frag_dir, f"fragment_{fid:03d}.json"), graph)

    vbg = create_fragment_grid(cfg, dev)
    poses = graph.poses.cpu().numpy()
    for i, rgbd in enumerate(rgbds):
        vbg = integrate_fragment_frame(vbg, rgbd, poses[i], intr, cfg)
    pcd = vbg_mod.extract_point_cloud(
        vbg, point_capacity=cfg.fragment_point_capacity, weight_threshold=2.0
    )
    pcio.write_point_cloud(ply_path, pcd)


# ---------------------------------------------------------------------------
# Evaluation: ATE (Horn alignment + RMSE)
# ---------------------------------------------------------------------------


def align_trajectories_horn(est: np.ndarray, gt: np.ndarray):
    """Closed-form similarity alignment (Horn) of trajectory translations;
    returns (aligned_est_positions, R, t)."""
    p = np.asarray(est)[:, :3, 3]
    q = np.asarray(gt)[:, :3, 3]
    mp, mq = p.mean(0), q.mean(0)
    Pc, Qc = p - mp, q - mq
    U, S, Vt = np.linalg.svd(Pc.T @ Qc)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T
    t = mq - R @ mp
    return (R @ p.T).T + t, R, t


def absolute_trajectory_error(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE RMSE after Horn alignment (TUM benchmark metric)."""
    aligned, _, _ = align_trajectories_horn(est, gt)
    q = np.asarray(gt)[:, :3, 3]
    return float(np.sqrt(((aligned - q) ** 2).sum(1).mean()))
