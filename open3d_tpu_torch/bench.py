"""The benchmark suite (port of the JAX package's bench.py), on the card.

    python -m open3d_tpu_torch.bench [--device cpu]
    python -m open3d_tpu_torch.tools.cli bench [--device cpu]

Headline: TSDF VoxelBlockGrid integration throughput (frames/second) at the
reference workload: 640x480, voxel 3/512 m, 16^3 blocks, 40 960 blocks,
2048 touched a frame (Open3D's native CUDA kernels reach ~100 Hz on a GTX
1070, docs/tutorial/t_reconstruction_system/integration.rst:43).
vs_baseline = fps / 100.

extra carries the secondary metrics, under the JAX package's keys:
  raycast_fps          640x480 raycast of the integrated grid (target 30),
                       with raycast_median_err_mm and raycast_miss_in_range
                       against the synthetic truth
  slam_fps             the dense-SLAM step: track + integrate + raycast;
                       slam_half_res_track_fps with the model frame raycast
                       at half resolution (model_raycast_stride=2)
  icp_iters_per_s      point-to-plane ICP, 10 iterations, at the reference
                       harness config (voxel 0.02, dmax 0.05 —
                       benchmarks/t/pipelines/registration/Registration.cpp:16-42),
                       with the per-iteration breakdown icp_nn_ms,
                       icp_estimation_ms, icp_other_ms and the band's
                       icp_band_shortfall
  odometry_fps         RGBD hybrid odometry frame pairs / s
  fpfh_ransac_s        FPFH + RANSAC global registration wall-clock

Every number is host wall time around work that ends in
torch.cuda.synchronize(): one warm call, then the timed passes, one sync,
the mean per call. The suite runs on the card unless the caller names the
CPU (`device="cpu"`, `--device cpu`), where nothing needs a sync.
BENCH_SMALL=1 selects the small configuration (160x128, two frames, small
grids and capacities), the JAX package's CPU smoke-test sizes.
"""

from __future__ import annotations

import json
import os
import time

import torch

from open3d_tpu_torch.core.platform import default_device

BASELINE_FPS = 100.0  # reference CUDA kernels, GTX 1070
RAYCAST_TARGET_FPS = 30.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_loop(fn, args_list, n_reps=3, device=None):
    """Wall-clock per call over n_reps passes of args_list: one warm call,
    the passes, one sync, the mean."""
    dev = default_device(device)
    fn(*args_list[0])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_reps):
        for a in args_list:
            fn(*a)
    _sync(dev)
    return (time.perf_counter() - t0) / (n_reps * len(args_list))


def _intrinsic(small: bool):
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic

    if small:
        return PinholeCameraIntrinsic(160, 120, 131.25, 131.25, 79.5, 59.5)
    return PinholeCameraIntrinsic(640, 480, 525.0, 525.0, 319.5, 239.5)


def bench_integration(intrinsic, depths, colors, extrinsics, small=False, device=None):
    """(frames/s, the grid): one warm frame, then 3 passes over the frames,
    the grid updated in place."""
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod

    dev = default_device(device)
    n_frames = depths.shape[0]
    FBC = 256 if small else 2048

    def step(vbg, depth, color, extrinsic):
        keys, _ = vbg_mod.compute_unique_block_coordinates(
            vbg, depth, intrinsic, extrinsic, depth_max=3.0, frame_block_capacity=FBC
        )
        return vbg_mod.integrate(vbg, keys, depth, color, intrinsic, extrinsic, depth_max=3.0)

    vbg = vbg_mod.create(
        voxel_size=3.0 / 512 if not small else 0.02,
        block_resolution=16,
        block_count=2048 if small else 40960,
        with_color=True,
        device=dev,
    )
    vbg = step(vbg, depths[0], colors[0], extrinsics[0])
    _sync(dev)
    n_reps = 3
    t0 = time.perf_counter()
    for _ in range(n_reps):
        for i in range(n_frames):
            vbg = step(vbg, depths[i], colors[i], extrinsics[i])
    _sync(dev)
    dt = (time.perf_counter() - t0) / (n_reps * n_frames)
    return 1.0 / dt, vbg


def bench_raycast(vbg, intrinsic, extrinsic, gt_depth=None):
    """Returns (fps, accuracy dict): speed must not silently buy holes, so
    the benchmark also reports median |raycast - GT| and the in-range miss
    fraction against the synthetic ground-truth depth."""
    import numpy as np

    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod

    def f(v, E):
        return vbg_mod.raycast(
            v, intrinsic, E, depth_min=0.1, depth_max=3.0, with_color=False
        ).depth

    dt = timed_loop(f, [(vbg, extrinsic)], n_reps=8, device=vbg.tw.device)
    acc = {}
    if gt_depth is not None:
        dn = f(vbg, extrinsic).cpu().numpy()
        dt_np = gt_depth.cpu().numpy()
        in_range = (dt_np > 0) & (dt_np < 2.9)
        both = (dn > 0) & in_range
        err = np.abs(dn - dt_np)[both]
        acc = {
            "raycast_median_err_mm": round(float(np.median(err)) * 1000, 2),
            "raycast_miss_in_range": round(float(((dn == 0) & in_range).mean()), 4),
        }
    return 1.0 / dt, acc


def bench_slam(intrinsic, depths, colors, small=False, stride=1, device=None):
    """stride > 1 renders the TRACKING model frame at reduced resolution
    (model_raycast_stride), reported as a separate metric; the default
    config stays reference-faithful full-res. One warm step, then 2 passes
    over the frames, carrying the model and its raycast depth."""
    from open3d_tpu_torch.models import dense_slam

    dev = default_device(device)
    if small:
        cfg = dense_slam.SLAMConfig(
            voxel_size=0.02, block_count=2048, frame_block_capacity=256,
            model_raycast_stride=stride,
        )
    else:
        cfg = dense_slam.SLAMConfig(
            block_count=40960, frame_block_capacity=2048, model_raycast_stride=stride,
        )
    model = dense_slam.create_model(cfg, device=dev)
    H, W = depths[0].shape
    md = torch.zeros((H // stride, W // stride), dtype=depths.dtype, device=dev)
    res = dense_slam.slam_step(model, depths[0], colors[0], md, intrinsic)
    model, md = res.model, res.raycast_depth
    _sync(dev)
    n = depths.shape[0]
    t0 = time.perf_counter()
    for rep in range(2):
        for i in range(n):
            res = dense_slam.slam_step(model, depths[i], colors[i], md, intrinsic)
            model, md = res.model, res.raycast_depth
    _sync(dev)
    return (2 * n) / (time.perf_counter() - t0)


def bench_icp(key, small=False, device=None):
    """Reference harness config: voxel 0.02 downsample, dmax 0.05, 10 iters
    (cpp/benchmarks/t/pipelines/registration/Registration.cpp:16-42).
    Returns (iterations/s, breakdown). `key` (a torch.Generator) is unused,
    as in the JAX package."""
    from open3d_tpu_torch.core import nns
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.rgbd import pointcloud_from_depth
    from open3d_tpu_torch.ops import pointcloud as pc_ops
    from open3d_tpu_torch.pipelines import registration as reg

    dev = default_device(device)
    intr = _intrinsic(small)
    depths, _, extr, _ = synthetic.render_sequence(2, intrinsic=intr, span=0.15, device=dev)
    clouds = []
    # fixed-capacity shapes drive the compute: shrink the downsampled
    # clouds to a realistic capacity or ICP pays full 307k-row NNS
    cap = 2048 if small else 40960
    for i in range(2):
        pcd = pointcloud_from_depth(depths[i], intr, extr[i])
        down = pc_ops.voxel_down_sample(pcd, 0.02, capacity=cap)
        clouds.append(pc_ops.estimate_normals(down, max_nn=30))
    N_ITER = 10
    est = reg.TransformationEstimationPointToPlane()
    criteria = reg.ICPConvergenceCriteria(
        max_iteration=N_ITER, relative_fitness=0.0, relative_rmse=0.0
    )

    def f(s, t):
        return reg.icp(s, t, 0.05, estimation=est, criteria=criteria).transformation

    dt = timed_loop(f, [(clouds[0], clouds[1])], n_reps=3, device=dev)

    # per-stage breakdown: N_ITER dependent iterations a call, each query
    # moved by the last one's sum so that no iteration can be skipped
    src, tgt = clouds
    b = nns.banded_build(tgt.positions, tgt.mask, est.corr_extras(tgt), window=2048)
    qkey = torch.where(src.mask, nns.banded_query_key(b, src.positions), 3e38)
    order = torch.argsort(qkey, stable=True)
    qs, qm = src.positions[order], src.mask[order]

    def loop_nn(qq):
        acc = torch.zeros((), device=dev)
        for _ in range(N_ITER):
            _, d2, _, _ = nns.banded_one_nn(b, qq + acc * 1e-12, 0.05, qmask=qm)
            acc = acc + torch.sum(d2)
        return acc

    def loop_nn_est(qq):
        acc = torch.zeros((), device=dev)
        for _ in range(N_ITER):
            idx, d2, sel, _ = nns.banded_one_nn(b, qq + acc * 1e-12, 0.05, qmask=qm)
            up = est.compute(qq, {}, tgt, idx, qm & (idx >= 0), None, corr_rows=sel)
            acc = acc + up[0, 3]
        return acc

    t_nn = timed_loop(loop_nn, [(qs,)], n_reps=3, device=dev) / N_ITER
    t_nn_est = timed_loop(loop_nn_est, [(qs,)], n_reps=3, device=dev) / N_ITER
    _, _, _, short = nns.banded_one_nn(b, qs, 0.05, qmask=qm)
    breakdown = {
        "icp_nn_ms": round(t_nn * 1e3, 3),
        "icp_estimation_ms": round(max(t_nn_est - t_nn, 0.0) * 1e3, 3),
        "icp_other_ms": round(max(dt / N_ITER - t_nn_est, 0.0) * 1e3, 3),
        "icp_band_shortfall": int(short),
    }
    return N_ITER / dt, breakdown


def bench_odometry(intrinsic, depths, colors):
    """Hybrid RGBD odometry, frame 0 to frame 1: pairs / s over 5 reps."""
    from open3d_tpu_torch.geometry.rgbd import RGBDImage
    from open3d_tpu_torch.pipelines import odometry as odo

    def f(d0, c0, d1, c1):
        return odo.rgbd_odometry_multi_scale(
            RGBDImage(color=c0, depth=d0),
            RGBDImage(color=c1, depth=d1),
            intrinsic,
            method=odo.HYBRID,
        ).transformation

    dt = timed_loop(f, [(depths[0], colors[0], depths[1], colors[1])], n_reps=5,
                    device=depths.device)
    return 1.0 / dt


def bench_fpfh_ransac(key, small=False, device=None):
    """Seconds for one FPFH preparation of a frame plus one RANSAC
    registration of the pair (4096 hypotheses drawn from `key`, a
    torch.Generator, reset to its state on entry before every call, as the
    JAX package passes one fixed key)."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.rgbd import pointcloud_from_depth
    from open3d_tpu_torch.ops import pointcloud as pc_ops
    from open3d_tpu_torch.pipelines import features
    from open3d_tpu_torch.pipelines import global_registration as gr

    dev = default_device(device)
    intr = _intrinsic(small)
    depths, _, extr, _ = synthetic.render_sequence(2, intrinsic=intr, span=0.4, device=dev)
    clouds, fpfhs = [], []

    cap = 1024 if small else 16384

    def prep(depth, E):
        pcd = pointcloud_from_depth(depth, intr, E)
        down = pc_ops.voxel_down_sample(pcd, 0.05, capacity=cap)
        down = pc_ops.estimate_normals(down, max_nn=30, radius=0.1)
        return down, features.compute_fpfh_feature(down, radius=0.25, max_nn=64)

    for i in range(2):
        d, f = prep(depths[i], extr[i])
        clouds.append(d)
        fpfhs.append(f)
    state = key.get_state()

    def run(s, t, fs, ft, k):
        k.set_state(state)
        return gr.registration_ransac_based_on_feature_matching(
            s, t, fs, ft, max_correspondence_distance=0.07,
            criteria=gr.RANSACConvergenceCriteria(max_iteration=4096),
            key=k,
        ).transformation

    dt_prep = timed_loop(prep, [(depths[0], extr[0])], n_reps=3, device=dev)
    dt_ransac = timed_loop(
        run, [(clouds[0], clouds[1], fpfhs[0], fpfhs[1], key)], n_reps=3, device=dev
    )
    return dt_prep + dt_ransac


def main(device=None):
    """Run every section, print the result as one JSON line and return it."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic

    dev = default_device(device)
    small = bool(os.environ.get("BENCH_SMALL"))  # CPU smoke-test config
    if small:
        intrinsic = PinholeCameraIntrinsic(160, 128, 131.25, 131.25, 79.5, 63.5)
        n_frames = 2
    else:
        intrinsic = PinholeCameraIntrinsic(640, 480, 525.0, 525.0, 319.5, 239.5)
        n_frames = 8
    depths, colors, extrinsics, _ = synthetic.render_sequence(
        n_frames, intrinsic=intrinsic, span=0.8, device=dev
    )
    _sync(dev)

    t_int, vbg = bench_integration(intrinsic, depths, colors, extrinsics, small, device=dev)
    raycast_fps, ray_acc = bench_raycast(vbg, intrinsic, extrinsics[0], gt_depth=depths[0])
    slam_fps = bench_slam(intrinsic, depths, colors, small, device=dev)
    slam_half_fps = bench_slam(intrinsic, depths, colors, small, stride=2, device=dev)
    key = torch.Generator(device=dev).manual_seed(0)
    icp_ips, icp_breakdown = bench_icp(key, small, device=dev)
    odo_fps = bench_odometry(intrinsic, depths, colors)
    fpfh_s = bench_fpfh_ransac(key, small, device=dev)

    extra = {
        "raycast_fps": round(raycast_fps, 2),
        "raycast_vs_30fps": round(raycast_fps / RAYCAST_TARGET_FPS, 3),
        "slam_fps": round(slam_fps, 2),
        "slam_vs_30fps": round(slam_fps / RAYCAST_TARGET_FPS, 3),
        "slam_half_res_track_fps": round(slam_half_fps, 2),
        "icp_iters_per_s": round(icp_ips, 1),
        **icp_breakdown,
        "odometry_fps": round(odo_fps, 2),
        "fpfh_ransac_s": round(fpfh_s, 3),
        **ray_acc,
        "sync": ("torch.cuda.synchronize" if dev.type == "cuda"
                 else "none: on the CPU every call returns when its work is done"),
    }
    out = {
        "metric": "tsdf_integration_fps",
        "value": round(t_int, 2),
        "unit": "frames/s",
        "vs_baseline": round(t_int / BASELINE_FPS, 3),
        "extra": extra,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' names the CPU)")
    main(device=ap.parse_args().device)
