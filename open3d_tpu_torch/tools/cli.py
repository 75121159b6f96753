"""`open3d-tpu` command line (port of open3d_tpu/tools/cli.py).

    python -m open3d_tpu_torch.tools.cli convert SRC DST [--voxel-down-sample V] [--points]
    python -m open3d_tpu_torch.tools.cli info PATH
    python -m open3d_tpu_torch.tools.cli reconstruct DIR [--output OUT] [--config YML]
    python -m open3d_tpu_torch.tools.cli slam DIR [--output OUT] [--voxel-size V] [--frames N]
    python -m open3d_tpu_torch.tools.cli bench
    python -m open3d_tpu_torch.tools.cli draw PATH [--output PNG] [--rpc ADDRESS]

Subcommands:
  convert       point-cloud / mesh format conversion (ConvertPointCloud.cpp)
  info          print geometry file statistics (ViewGeometry.cpp analog)
  reconstruct   the offline reconstruction system on a TUM or Redwood directory
  slam          dense SLAM over such a directory, writes trajectory.log + mesh.ply
  bench         the benchmark suite (open3d_tpu_torch.bench): one JSON line
                (BENCH_SMALL=1 for its small configuration)
  draw          render a point cloud to a PNG (matplotlib), or send it to an
                RPC viewer (msgpack over ZeroMQ)

Every subcommand takes `--device` (default: the card; `--device cpu` runs
the kernels' plain versions on the CPU). On several cards, one process a
card under torchrun, the reconstruction's stage 1 runs data-parallel:

    torchrun --nproc-per-node N -m open3d_tpu_torch.tools.cli reconstruct DIR --mesh-devices N
"""

from __future__ import annotations

import argparse
import itertools
import os


def _load_sequence(path: str):
    from open3d_tpu_torch.data import dataset as ds

    if os.path.isfile(os.path.join(path, "rgb.txt")):
        return ds.load_tum_sequence(path)
    return ds.load_redwood_sequence(path)


def cmd_convert(args):
    from open3d_tpu_torch.io import (
        read_point_cloud,
        read_triangle_mesh,
        write_point_cloud,
        write_triangle_mesh,
    )

    mesh_exts = (".stl", ".off", ".obj", ".glb", ".gltf")
    is_mesh = args.src.lower().endswith(mesh_exts) or args.dst.lower().endswith(mesh_exts)
    if is_mesh and not args.points:
        write_triangle_mesh(args.dst, read_triangle_mesh(args.src, device=args.device))
    else:
        pcd = read_point_cloud(args.src, device=args.device)
        if args.voxel_down_sample:
            from open3d_tpu_torch.ops import pointcloud as pc_ops

            pcd = pc_ops.voxel_down_sample(pcd, args.voxel_down_sample)
        write_point_cloud(args.dst, pcd)
    print(f"wrote {args.dst}")


def cmd_info(args):
    import numpy as np

    if args.path.lower().endswith((".stl", ".off", ".obj", ".glb", ".gltf")):
        from open3d_tpu_torch.io import read_triangle_mesh

        v, t = read_triangle_mesh(args.path, device=args.device).compact()
        lo, hi = np.min(np.asarray(v), 0), np.max(np.asarray(v), 0)
        print(f"TriangleMesh: {len(v)} vertices, {len(t)} triangles")
        print(f"  bounds: min {lo.tolist()} max {hi.tolist()}")
    else:
        from open3d_tpu_torch.io import read_point_cloud

        p = read_point_cloud(args.path, device=args.device)
        pts = p.to_numpy()["positions"]
        print(f"PointCloud: {len(pts)} points, attrs: {sorted(p.attrs)}")
        if len(pts):
            print(f"  bounds: min {pts.min(0).tolist()} max {pts.max(0).tolist()}")


def cmd_reconstruct(args):
    from open3d_tpu_torch.pipelines import reconstruction as rc

    seq = _load_sequence(args.dataset)
    if args.config:
        import dataclasses

        cfg = dataclasses.replace(
            rc.ReconstructionConfig.from_yaml(args.config), path_output=args.output
        )
    else:
        cfg = rc.ReconstructionConfig(path_output=args.output)
    mesh = None
    if args.mesh_devices > 1:
        from open3d_tpu_torch.parallel import multihost, pipeline as pp

        multihost.initialize(device=args.device)
        mesh = pp.make_pipeline_mesh(args.mesh_devices, device=args.device)
    vbg, traj, graph = rc.run_system(seq, cfg, mesh=mesh, device=args.device)
    print(f"trajectory + artifacts under {cfg.path_output}")
    if seq.gt_trajectory is not None:
        ate = rc.absolute_trajectory_error(traj, seq.gt_trajectory)
        print(f"ATE RMSE: {ate:.4f} m")


def cmd_slam(args):
    """The frame loop on the card: slam_step updates the grid in place (the
    JAX package jits the step and donates the model)."""
    import numpy as np
    import torch

    from open3d_tpu_torch.core.platform import default_device
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
    from open3d_tpu_torch.io import write_trajectory_log, write_triangle_mesh
    from open3d_tpu_torch.models import dense_slam

    dev = default_device(args.device)
    seq = _load_sequence(args.dataset)
    cfg = dense_slam.SLAMConfig(voxel_size=args.voxel_size)
    model = dense_slam.create_model(cfg, device=dev)
    md = None
    poses = []
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))
    for i, (depth, color) in enumerate(itertools.islice(seq.iter_frames(), n)):
        depth = torch.as_tensor(depth, device=dev)
        depth = torch.where((depth > 0) & (depth < cfg.depth_max), depth, 0.0)
        if md is None:
            md = torch.zeros_like(depth)
        res = dense_slam.slam_step(model, depth, torch.as_tensor(color, device=dev), md,
                                   seq.intrinsic)
        model, md = res.model, res.raycast_depth
        poses.append(model.T_frame_to_world.cpu().numpy())
        if i % 10 == 0:
            print(f"frame {i}/{n} fitness {float(res.fitness):.3f}")
    os.makedirs(args.output, exist_ok=True)
    write_trajectory_log(os.path.join(args.output, "trajectory.log"), np.stack(poses))
    mesh = vbg_mod.extract_triangle_mesh(model.vbg)
    write_triangle_mesh(os.path.join(args.output, "mesh.ply"), mesh)
    print(f"wrote {args.output}/trajectory.log and mesh.ply")


def cmd_bench(args):
    from open3d_tpu_torch import bench

    bench.main(device=args.device)


def cmd_draw(args):
    from open3d_tpu_torch.io import read_point_cloud
    from open3d_tpu_torch.visualization import draw as vis

    pcd = read_point_cloud(args.path, device=args.device)
    if args.rpc:
        ev = vis.ExternalVisualizer(args.rpc)
        ev.set(pcd, path=os.path.basename(args.path))
        print(f"sent to {args.rpc}")
    else:
        out = args.output or (os.path.splitext(args.path)[0] + ".png")
        vis.draw([pcd], output_path=out)
        print(f"wrote {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="open3d-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' names the CPU)")

    c = sub.add_parser("convert", parents=[common], help="convert point cloud / mesh formats")
    c.add_argument("src")
    c.add_argument("dst")
    c.add_argument("--voxel-down-sample", type=float, default=0.0)
    c.add_argument("--points", action="store_true", help="force point-cloud mode")
    c.set_defaults(fn=cmd_convert)

    c = sub.add_parser("info", parents=[common], help="print geometry statistics")
    c.add_argument("path")
    c.set_defaults(fn=cmd_info)

    c = sub.add_parser("reconstruct", parents=[common], help="offline reconstruction system")
    c.add_argument("dataset")
    c.add_argument("--output", default="recon_out")
    c.add_argument("--config", default="")
    c.add_argument("--mesh-devices", type=int, default=1)
    c.set_defaults(fn=cmd_reconstruct)

    c = sub.add_parser("slam", parents=[common], help="dense SLAM over a sequence")
    c.add_argument("dataset")
    c.add_argument("--output", default="slam_out")
    c.add_argument("--voxel-size", type=float, default=3.0 / 512)
    c.add_argument("--frames", type=int, default=0)
    c.set_defaults(fn=cmd_slam)

    c = sub.add_parser("bench", parents=[common], help="run the benchmark suite")
    c.set_defaults(fn=cmd_bench)

    c = sub.add_parser("draw", parents=[common], help="render to PNG or send to RPC viewer")
    c.add_argument("path")
    c.add_argument("--output", default="")
    c.add_argument("--rpc", default="")
    c.set_defaults(fn=cmd_draw)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
