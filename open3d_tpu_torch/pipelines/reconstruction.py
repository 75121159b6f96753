"""Offline reconstruction system (port of open3d_tpu/pipelines/reconstruction.py):
fragments -> register -> refine -> integrate the scene, then the scene mesh.

1. make_fragments: per fragment of `fragment_size` frames, HYBRID (or the
   configured) RGB-D odometry on consecutive pairs and on keyframe
   loop-closure pairs, an information matrix per edge, the robust
   pose-graph optimisation, and a TSDF integrate of every frame into an
   8^3-block fragment grid (the row fuse K3, `ops/kernels/tsdf.py`); each
   fragment writes `fragments/fragment_NNN.ply` and its pose graph
   `fragment_NNN.json`, and a rerun skips the fragments that exist.
2. register_fragments: each fragment cloud read at
   `registration_point_capacity` rows, down-sampled, normals and FPFH;
   adjacent pairs ICP from the identity, the others from RANSAC (or FGR);
   the overlap gate, the scene pose graph, two-pass optimisation ->
   `scene/global_registration.json`.
3. refine_registration: multi-scale ICP on every surviving edge, the
   information matrices anew, two-pass optimisation ->
   `scene/refined_registration.json`.
4. integrate_scene: every frame at scene_pose[fragment] @ fragment_pose
   into a grid at the configured voxel and block size (16^3 by default, so
   the integrate kernel K1, `ops/kernels/integrate2.py`) ->
   `trajectory.log`.

A sequence is any object with `intrinsic`, `__len__` and
`read_frame(i) -> (depth (H, W), color (H, W, 3))`, numpy or torch (a
dataset loaded from disk by data/dataset.py is one); frames move to
`device` (default: the card). Random draws (RANSAC, FGR) come from one
torch.Generator seeded 3 on that device, drawn from in pair order.

With a mesh (a 1-D "fragments" DeviceMesh, parallel/pipeline.py), stage 1
runs data-parallel over the mesh's ranks: every rank loads the frames,
builds its share of the fragments (`make_fragments_sharded`, whose chain
integrates through K3) and receives all of them. Under a launcher every
rank runs run_system; rank 0 alone writes the run's files, the fragments
to build are decided on rank 0, and the ranks meet at a barrier before
stage 2 reads the fragments. Stages 2-4 run on every rank alike.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from open3d_tpu_torch import io as pcio
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.ops import mesh as mops
from open3d_tpu_torch.ops import pointcloud as pc_ops
from open3d_tpu_torch.parallel import multihost
from open3d_tpu_torch.parallel import pipeline as pp
from open3d_tpu_torch.pipelines import features
from open3d_tpu_torch.pipelines import global_registration as gr
from open3d_tpu_torch.pipelines import odometry as odo
from open3d_tpu_torch.pipelines import pose_graph as pg
from open3d_tpu_torch.pipelines import registration as reg


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


def _writes_here() -> bool:
    """Whether this process writes the run's files: rank 0 of a process
    group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _fragment_dir(cfg):
    d = os.path.join(cfg.path_output, "fragments")
    os.makedirs(d, exist_ok=True)
    return d


def _scene_dir(cfg):
    d = os.path.join(cfg.path_output, "scene")
    os.makedirs(d, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# Stage 1: make fragments
# ---------------------------------------------------------------------------


def _fragment_ranges(n_frames: int, fragment_size: int):
    return [(s, min(s + fragment_size, n_frames)) for s in range(0, n_frames, fragment_size)]


def make_fragments(sequence, cfg: ReconstructionConfig, mesh=None, device=None) -> List[str]:
    """Stage 1 on `device`. Returns the fragment PLY paths; fragments whose
    PLY exists are skipped. Without `mesh`, one fragment after another.
    With `mesh` (a "fragments" DeviceMesh of `device`'s type; every rank
    calls this), the fragments are built data-parallel over its ranks by
    make_fragments_sharded at the JAX package's mesh-path settings (twice
    the voxel, 8^3 blocks, at most 8192 of them, 4096 a frame, the
    fragment's chain pose graph written beside it); rank 0 decides which
    fragments to build and writes them, and every rank returns after the
    files exist."""
    dev = default_device(device)
    frag_dir = _fragment_dir(cfg)
    ranges = _fragment_ranges(len(sequence), cfg.fragment_size)
    paths = [os.path.join(frag_dir, f"fragment_{fid:03d}.ply") for fid in range(len(ranges))]
    todo = [fid for fid, p in enumerate(paths) if not os.path.isfile(p)]
    if mesh is not None:
        multihost._check_mesh(mesh, "fragments", dev)
        group = mesh.get_group("fragments")
        flags = torch.zeros(len(paths), dtype=torch.int32, device=dev)
        flags[todo] = 1
        dist.broadcast(flags, src=dist.get_global_rank(group, 0), group=group)
        todo = torch.nonzero(flags).flatten().tolist()
        if todo:
            _make_fragments_via_mesh(sequence, cfg, mesh, ranges, frag_dir, paths, todo, dev)
        # the barrier: no rank reads the fragments before rank 0 wrote them
        done = torch.zeros(1, device=dev)
        dist.all_reduce(done, group=group)
        done.item()
        return paths
    for fid in todo:
        s, e = ranges[fid]
        _process_single_fragment(sequence, cfg, fid, s, e, frag_dir, paths[fid], dev)
    return paths


def _make_fragments_via_mesh(sequence, cfg, mesh, ranges, frag_dir, paths, todo, dev):
    """Sharded stage 1: stack the frames (F, T, H, W), short tail fragments
    padded with empty frames, run the sharded chain, write the same PLY and
    pose-graph JSON files as the host path (rank 0)."""
    T = max(e - s for s, e in ranges)
    deps, cols = [], []
    for fid in todo:
        s, e = ranges[fid]
        rgbds = [_read_rgbd(sequence, i, cfg, dev) for i in range(s, e)]
        dd = torch.stack([r.depth for r in rgbds])
        cc = torch.stack([r.color for r in rgbds])
        deps.append(torch.cat([dd, dd.new_zeros((T - len(rgbds),) + dd.shape[1:])]))
        cols.append(torch.cat([cc, cc.new_zeros((T - len(rgbds),) + cc.shape[1:])]))
    batch = pp.make_fragments_sharded(
        torch.stack(deps), torch.stack(cols), sequence.intrinsic, mesh,
        voxel_size=cfg.voxel_size * 2,
        block_count=min(cfg.block_count, 8192),
        block_resolution=8,
        point_capacity=cfg.fragment_point_capacity,
        depth_max=cfg.depth_max,
        frame_block_capacity=4096,
        keyframe_interval=cfg.n_keyframes_per_n_frame,
        sdf_trunc=cfg.trunc_voxel_multiplier * cfg.voxel_size,
    )
    if not _writes_here():
        return
    for k, fid in enumerate(todo):
        s, e = ranges[fid]
        n = e - s
        pcd = PointCloud(positions=batch.positions[k], mask=batch.mask[k],
                         attrs={"normals": batch.normals[k]})
        pcio.write_point_cloud(paths[fid], pcd)
        poses = batch.poses[k][:n].cpu().numpy()
        X = [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(n - 1)]
        graph = pg.PoseGraph.create(
            poses,
            np.asarray([(i, i + 1) for i in range(n - 1)], np.int32).reshape(-1, 2),
            np.stack(X) if X else np.eye(4, dtype=np.float32)[None],
            device=dev,
        )
        pg.write_pose_graph(os.path.join(frag_dir, f"fragment_{fid:03d}.json"), graph)


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
# Stage 2: register fragments
# ---------------------------------------------------------------------------


def _preprocess_fragment(pcd: PointCloud, cfg):
    """(ref: register_fragments.py:27-38 preprocess_point_cloud)"""
    down = pc_ops.voxel_down_sample(pcd, cfg.downsample_voxel_size)
    down = pc_ops.estimate_normals(down, max_nn=30, radius=cfg.downsample_voxel_size * 2)
    fpfh = features.compute_fpfh_feature(down, radius=cfg.downsample_voxel_size * 5, max_nn=100)
    return down, fpfh


def _pair_registration(src, tgt, fs, ft, cfg, adjacent: bool, key):
    """ICP from the identity (adjacent pair) or from RANSAC / FGR on the
    FPFH matches, then the information matrix at ICP's pose (ref:
    register_point_cloud_pair, register_fragments.py:40-99)."""
    dvs = cfg.downsample_voxel_size
    if adjacent:
        init = torch.eye(4, dtype=torch.float32, device=src.positions.device)
    elif cfg.global_registration == "fgr":
        init = gr.registration_fgr_based_on_feature_matching(
            src, tgt, fs, ft, option=gr.FGROption(maximum_correspondence_distance=dvs * 1.4),
            key=key,
        ).transformation
    else:
        init = gr.registration_ransac_based_on_feature_matching(
            src, tgt, fs, ft, max_correspondence_distance=dvs * 1.4,
            criteria=gr.RANSACConvergenceCriteria(max_iteration=100000), key=key,
        ).transformation
    est = (
        reg.TransformationEstimationPointToPlane()
        if cfg.icp_method in ("point_to_plane", "colored")
        else reg.TransformationEstimationPointToPoint()
    )
    icp_res = reg.icp(src, tgt, dvs * 1.4, init=init, estimation=est)
    info = reg.get_information_matrix(src, tgt, dvs * 1.4, icp_res.transformation)
    return icp_res, info


def _scene_option(cfg) -> pg.GlobalOptimizationOption:
    return pg.GlobalOptimizationOption(
        max_correspondence_distance=cfg.downsample_voxel_size * 1.4,
        preference_loop_closure=cfg.preference_loop_closure_registration,
    )


def register_fragments(fragment_paths: List[str], cfg: ReconstructionConfig, device=None):
    """Stage 2: all-pairs fragment registration -> the optimised scene
    PoseGraph, also written to scene/global_registration.json (ref:
    register_fragments.py:100-122 make_posegraph_for_scene). An adjacent
    pair's edge is always kept (the identity where the overlap gate
    info[5, 5] / min(n) >= 0.3 fails); another pair's is kept, uncertain,
    where the gate passes and its fitness exceeds 0.3."""
    dev = default_device(device)
    n = len(fragment_paths)
    clouds, fpfhs = [], []
    for p in fragment_paths:
        pcd = pcio.read_point_cloud(p, capacity=cfg.registration_point_capacity, device=dev)
        down, fpfh = _preprocess_fragment(pcd, cfg)
        clouds.append(down)
        fpfhs.append(fpfh)

    gen = torch.Generator(device=dev).manual_seed(3)
    edges, trans, infos, unc = [], [], [], []
    odom = [np.eye(4, dtype=np.float32)]
    for s in range(n):
        for t in range(s + 1, n):
            adjacent = t == s + 1
            res, info = _pair_registration(
                clouds[s], clouds[t], fpfhs[s], fpfhs[t], cfg, adjacent, gen
            )
            T = res.transformation.cpu().numpy()
            info_np = info.cpu().numpy()
            n_min = min(int(clouds[s].count()), int(clouds[t].count()))
            ok = info_np[5, 5] / max(n_min, 1) >= 0.3  # overlap gate (:66-68)
            if adjacent:
                if not ok:
                    T = np.eye(4, dtype=np.float32)
                    info_np = np.eye(6, dtype=np.float32)
                edges.append((s, t))
                trans.append(np.linalg.inv(T))
                infos.append(info_np)
                unc.append(False)
                odom.append(odom[-1] @ np.linalg.inv(T))
            elif ok and float(res.fitness) > 0.3:
                edges.append((s, t))
                trans.append(np.linalg.inv(T))
                infos.append(info_np)
                unc.append(True)

    graph = pg.PoseGraph.create(
        np.stack(odom), np.asarray(edges, np.int32), np.stack(trans),
        informations=np.stack(infos), uncertain=np.asarray(unc), device=dev,
    )
    graph = pg.global_optimization_two_pass(graph, _scene_option(cfg))
    if _writes_here():
        pg.write_pose_graph(os.path.join(_scene_dir(cfg), "global_registration.json"), graph)
    return graph


def _refine_edge(src, tgt, init, dvs):
    res = reg.multi_scale_icp(
        src, tgt,
        voxel_sizes=[dvs * 2, dvs],
        criteria_list=[reg.ICPConvergenceCriteria(max_iteration=20)] * 2,
        max_correspondence_distances=[dvs * 4, dvs * 1.4],
        init=init,
        estimation=reg.TransformationEstimationPointToPlane(),
    )
    info = reg.get_information_matrix(src, tgt, dvs * 1.4, res.transformation)
    return res.transformation, info


def refine_registration(fragment_paths, graph: pg.PoseGraph, cfg: ReconstructionConfig,
                        device=None):
    """Stage 3: multi-scale ICP (2 x and 1 x the down-sampling voxel, 20
    iterations each) on every valid edge from its current transform, the
    information matrices anew, two-pass optimisation -> the PoseGraph, also
    written to scene/refined_registration.json (ref: refine_registration.py)."""
    dev = default_device(device)
    clouds = []
    for p in fragment_paths:
        pcd = pcio.read_point_cloud(p, capacity=cfg.registration_point_capacity, device=dev)
        down = pc_ops.voxel_down_sample(pcd, cfg.downsample_voxel_size)
        clouds.append(pc_ops.estimate_normals(down, max_nn=30))

    e_np = graph.edges.cpu().numpy()
    valid = graph.edge_valid.cpu().numpy()
    trans_np = graph.transformations.cpu().numpy()
    infos_np = graph.informations.cpu().numpy()
    new_trans, new_infos = [], []
    for i in range(e_np.shape[0]):
        if not valid[i]:
            new_trans.append(trans_np[i])
            new_infos.append(infos_np[i])
            continue
        s, t = int(e_np[i, 0]), int(e_np[i, 1])
        # the edge stores X with pose_t = pose_s @ X; ICP maps src to tgt points
        init = torch.as_tensor(np.linalg.inv(trans_np[i]), device=dev)
        T_st, info = _refine_edge(clouds[s], clouds[t], init, cfg.downsample_voxel_size)
        new_trans.append(np.linalg.inv(T_st.cpu().numpy()))
        new_infos.append(info.cpu().numpy())

    graph2 = dataclasses.replace(
        graph,
        transformations=torch.as_tensor(np.stack(new_trans), device=graph.poses.device),
        informations=torch.as_tensor(np.stack(new_infos), device=graph.poses.device),
    )
    graph2 = pg.global_optimization_two_pass(graph2, _scene_option(cfg))
    if _writes_here():
        pg.write_pose_graph(os.path.join(_scene_dir(cfg), "refined_registration.json"), graph2)
    return graph2


# ---------------------------------------------------------------------------
# Stage 4: integrate the scene
# ---------------------------------------------------------------------------


def create_scene_grid(cfg: ReconstructionConfig, device) -> vbg_mod.VoxelBlockGrid:
    """The scene grid: the configured voxel, block resolution and count."""
    return vbg_mod.create(
        voxel_size=cfg.voxel_size,
        block_resolution=cfg.block_resolution,
        block_count=cfg.block_count,
        sdf_trunc=cfg.trunc_voxel_multiplier * cfg.voxel_size,
        with_color=True,
        device=device,
    )


def integrate_scene_frame(vbg, rgbd: RGBDImage, pose, intr, cfg):
    """Touch (8192 blocks a frame at most), activate and fuse one frame at
    its frame -> world `pose` (ref: integrate_scene.py:21-51)."""
    extr = torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32).to(vbg.device)
    keys, _ = vbg_mod.compute_unique_block_coordinates(
        vbg, rgbd.depth, intr, extr, depth_max=cfg.depth_max, frame_block_capacity=8192,
    )
    return vbg_mod.integrate(vbg, keys, rgbd.depth, rgbd.color, intr, extr,
                             depth_max=cfg.depth_max)


def integrate_scene(sequence, scene_graph: pg.PoseGraph, cfg: ReconstructionConfig,
                    device=None):
    """Stage 4: a TSDF of every frame at scene_pose[fragment] @
    fragment_pose[frame]. Returns (the grid, the trajectory (N, 4, 4)),
    the trajectory also written to trajectory.log."""
    dev = default_device(device)
    intr = sequence.intrinsic
    frag_dir = _fragment_dir(cfg)
    ranges = _fragment_ranges(len(sequence), cfg.fragment_size)
    scene_poses = scene_graph.poses.cpu().numpy()

    vbg = create_scene_grid(cfg, dev)
    trajectory = []
    for fid, (s, e) in enumerate(ranges):
        fg = pg.read_pose_graph(os.path.join(frag_dir, f"fragment_{fid:03d}.json"), device="cpu")
        fposes = fg.poses.numpy()
        for k, i in enumerate(range(s, e)):
            pose = scene_poses[fid] @ fposes[k]
            trajectory.append(pose)
            vbg = integrate_scene_frame(vbg, _read_rgbd(sequence, i, cfg, dev), pose, intr, cfg)
    if _writes_here():
        pcio.write_trajectory_log(os.path.join(cfg.path_output, "trajectory.log"),
                                  np.stack(trajectory))
    return vbg, np.stack(trajectory)


def run_system(sequence, cfg: ReconstructionConfig, mesh=None, device=None):
    """The four stages (ref: run_system.py:107-137). Returns (grid,
    trajectory (N, 4, 4), scene graph). With `mesh` (a 1-D "fragments"
    DeviceMesh from parallel.pipeline.make_pipeline_mesh; every rank calls
    this), stage 1 runs data-parallel over its ranks (make_fragments) and
    stages 2-4 run on every rank alike; rank 0 writes the files."""
    os.makedirs(cfg.path_output, exist_ok=True)
    frags = make_fragments(sequence, cfg, mesh=mesh, device=device)
    graph = register_fragments(frags, cfg, device=device)
    graph = refine_registration(frags, graph, cfg, device=device)
    vbg, traj = integrate_scene(sequence, graph, cfg, device=device)
    return vbg, traj, graph


def extract_scene_mesh(
    vbg,
    triangle_capacity: int = 400_000,
    min_component_triangles: int = 32,
):
    """The indexed marching-tetrahedra mesh of the scene grid, its
    connected components under `min_component_triangles` triangles masked
    out (the reconstruction demos' cluster_connected_triangles cleanup)."""
    m = vbg_mod.extract_triangle_mesh(vbg, triangle_capacity=triangle_capacity)
    if min_component_triangles > 0:
        m = mops.remove_small_components(m, min_triangles=min_component_triangles)
    return m


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
