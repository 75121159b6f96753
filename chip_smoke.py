#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card: the dense-SLAM
frame step, stage 1 of the offline reconstruction system (make_fragments),
the primitive, gather and march probes that scripts/ ran on the TPU, and
the registration path (ICP, FPFH, RANSAC, FGR).

    python3 chip_smoke.py [--profile DIR] [--kernels-only]

Phases:
  1. the card's name and power limit;
  2. build the CUDA kernels from csrc/ (nvcc, first use) and time the build;
  3. the integrate kernel K1, then its V1 mode K4 (bf16 planes), each
     against its plain PyTorch version on the card, at full width: 640x480
     PrimeSense frames, a 40960-block grid, 2048 touched blocks a frame;
     each timed warm (back-to-back launches) and cold (L2 flushed before
     each launch);
  4. the raycast march kernel K2 against its plain version on that grid,
     timed warm and cold, with the work its data asks for (sectors
     sampled, candidates walked a tile), its occupancy, and the time of
     its slowest tile marched alone (--kernels-only then times K3 on a
     synthetic fragment work list and P2 at the script's three sizes, and
     stops);
  5. the SLAM slice: slam_step over the 8-frame bench orbit at that
     configuration, pose-gated on frames 0-3 (the reference loses track
     from frame 4 too), then over the first half of that orbit, held on
     every frame to the JAX package's SLAM test gates against the synthetic
     truth; then 4 frames of that half-orbit with O3DTPU_INTEGRATE_V1 set,
     which integrate through K4. Each counted run sets the kernels' launch
     counts to 0 just before it and reads them just after;
  6. per-stage times of the frame step (CUDA events, after warm-up), peak
     device memory;
  7. with --profile: torch.profiler over the steady frame step (device
     busy share, kernels by device time, host ops by their own time), the
     trace written into DIR;
  8. the fragment slice: make_fragments on one 40-frame fragment of the
     synthetic room at ReconstructionConfig's defaults (HYBRID odometry,
     8^3-block fragment grid of 8192 blocks, 4096 touched blocks a frame),
     counted like phase 5; fragment poses gated against the truth, the
     fragment cloud against the scene's SDF, the PLY and JSON read back;
  9. the fragment grid rebuilt from those poses: the row fuse K3 against
     its plain version at frame 10's full-width work list, with and
     without colour, timed warm and cold, with its launch floor (that list
     with every entry the dump row) and occupancy; per-stage times of the
     fragment path;
 10. the probes' path, the three kernels ported from scripts/: the gather
     P2 at the script's three table sizes, the staged-block march P3 at
     T = 1200 tiles over a 40960-block table, and the 17 primitive probes
     P1 at 1000 and 9000 repeats, counted like phase 5; each held against
     its plain version on those outputs, then timed beside its plain
     version and a PyTorch call that computes the same function (P2 with
     its occupancy at each size);
 11. the raycast surface: the SLAM slice with raycast normals feeding
     tracking over the bench orbit's frames 0-3 (K2 launches counted), then
     every map at once (colour, TSDF-gradient normals, index/ratio) from
     frame 3's pose, held against the same function on a CPU copy of the
     grid and depth and against the synthetic truth; the sphere trace on
     that 16^3 grid (against K2's depth and the truth) and on phase 8's
     8^3 fragment grid (against the scene's SDF); each map's, each trace's
     and the step's time with normals on and off;
 12. the registration path at bench.py's two workloads, plain PyTorch with
     no kernel of csrc/ on it (the counts stay 0): voxel_down_sample of a
     640x480 cloud against a CPU copy and against itself; point-to-plane
     ICP on the two down-sampled frames (10 iterations, then 30 from a
     perturbed start through the band and the exact 1-NN), within 0.02 m /
     rad of the truth; the band's shortfall against a CPU copy's and the
     banded 1-NN against the exact one; FPFH, RANSAC and FGR on the bench's
     own pair (printed) and on a rigidly moved copy of frame 0's cloud,
     within 0.05 m / rad; FPFH on frame 0's cloud against a CPU copy,
     within the bar that the two neighbour tables' d2 set; the times a line
     each (the 30-iteration ICP beside the iterations it needed) and the
     peak memory.
Then one JSON line describing each kernel: its time, its plain version's,
and its bound, the larger of its bytes over the card's memory rate and its
float32 operations over the card's float32 rate (bfloat16 products over the
tensor cores' rate), both counted from this run's inputs. The last line is {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result. It
imports only torch and open3d_tpu_torch.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_F32_PER_S = 67e12  # float32 outside the tensor cores, same sheet
H100_BF16_PER_S = 989e12  # bfloat16 on the tensor cores, dense, same sheet
# float32 arithmetic (an fma counts two; min, max and compares not counted):
K1_OPS_VOXEL = 86  # integrate2.cu: 56 for tsdf and weight, 30 for colour
# The march's function needs, on the work this run's data asks for:
K2_OPS_RAY = 21  # the ray direction and its squared length, once a ray
K2_OPS_CHORD = 23  # three slab chords (7 each) and the step, per ray and (tile, block) step
K2_OPS_SAMPLE = 12  # sample position (8), voxel index (3), decode of the sampled word (1)
K2_OPS_CROSS = 35  # voxel-centre parameters of the bracket (2 x 15), interpolation (5)
# K4 is K1's function on other samples: the depth is d_hi + d_lo (one add,
# where K1 decodes d21 with one multiply), the new tsdf passes the relayout's
# hi + lo split (two), and the colour needs no byte decode (three fewer)
K4_OPS_VOXEL = K1_OPS_VOXEL - 1 + 1 + 2 - 3
# K3, colour variant, per voxel: tsdf decode 1, w_sum 1, 1/w_sum 1, the
# weighted sum 3, times inv 1, the s1.14 scale 1 (8); colour decode 6, three
# weighted means of 4 (12), three repacks of 2 (6)
K3_OPS_VOXEL = 32
K3_BYTES_VOXEL = 28  # read tsdf_new, wn, cnew, tw, colour; write tw, colour
# K1, K3 and K4 are gated at bit parity with their plain versions; the JAX
# package's own bars (weight mismatch < 1e-6, tsdf 1e-3, colour 2/255 at
# q99.9) are the outer limit
BIT_TOL = dict(weight_mismatch=0.0, max_abs_dtsdf=0.0, max_abs_dcolor=0.0)
# K2 likewise: every ray hits or misses as in the plain version, at the same
# depth; the JAX package's bars (median error under a voxel, in-range miss
# under 0.08) are the outer limit
K2_TOL = dict(hit_agree=1.0, max_abs_dz=0.0)
POSE_TOL = 0.05  # m and rad, tests/test_slam.py's gate
P3_TOL = dict(hit_agree=1.0, max_abs_dz=1e-6)  # the staged-block march, target bit parity
# Phase 11's bars against the synthetic truth at the SLAM configuration
# (640x480, 3/512 m voxels): about twice what a CPU rehearsal of the phase
# at that size read (PERF.md §2): the colour map's largest channel
# error (0.0096 median, 0.0152 q90), the normal map's angle to the scene
# SDF's gradient in degrees (0.81, 2.89), and the share of rays on which
# the sphere trace and the march agree to hit (0.989)
COLOR_TOL = dict(median=0.02, q90=0.04)
NORMAL_TOL_DEG = dict(median=2.0, q90=6.0)
TRACE_HIT_AGREE = 0.97
PROBE_KERNELS = ("micro_gather", "micro_raymarch", "micro_primitives")
# Phase 12's bars: the JAX package's own registration tests
ICP_POSE_TOL = 0.02  # m and rad, tests/test_registration.py:86-87
BAND_EXACT_TOL = 5e-4  # banded vs exact ICP pose, elementwise, tests/test_nns.py:148
GLOBAL_POSE_TOL = 0.05  # m and rad, tests/test_global_registration.py:90-93
RANSAC_MIN_FITNESS = 0.7  # the same test's bar
VDS_TOL = 1e-6  # voxel means on the card vs a CPU copy (sequential sums on both)
ICP_CAPACITY = 40960  # voxel_down_sample capacities of bench.py's ICP and FPFH workloads
FPFH_CAPACITY = 16384
# how a kernel's ms (warm, cold, floor) is read; the plain versions' and
# the library calls' times are single readings
MEDIAN_TIMES = "the median of 5 readings, each a mean over 20 launches; spread = largest - smallest"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: int, n_ops: int):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(fn):
    """(fn(), its time in ms by CUDA events around this one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def row_parity(vbg_mod, live, tw_a, col_a, tw_b, col_b) -> dict:
    """How far two payload states differ on the live rows: the weight
    mismatch share, and the largest tsdf and colour differences."""
    ta, wa = vbg_mod.unpack_tw(tw_a.reshape(tw_a.shape[0], -1)[live])
    tb, wb = vbg_mod.unpack_tw(tw_b.reshape(tw_b.shape[0], -1)[live])
    par = {
        "weight_mismatch": float((wa != wb).float().mean()),
        "max_abs_dtsdf": float((ta - tb).abs().max()),
        "max_abs_dcolor": 0.0,
    }
    if col_a is not None:
        ca = vbg_mod.unpack_rgb(col_a.reshape(col_a.shape[0], -1)[live])
        cb = vbg_mod.unpack_rgb(col_b.reshape(col_b.shape[0], -1)[live])
        par["max_abs_dcolor"] = float((ca - cb).abs().max())
    par["max_abs_err"] = max(float((wa - wb).abs().max()), par["max_abs_dtsdf"],
                             par["max_abs_dcolor"])
    return par


def check_bit_parity(name: str, par: dict) -> None:
    for k, bar in BIT_TOL.items():
        check(par[k] <= bar, f"{name} {k} {par[k]} > {bar}: {par}")


class MemorySequence:
    """What make_fragments reads: intrinsic, len and read_frame(i)."""

    def __init__(self, intrinsic, depths, colors):
        self.intrinsic, self.depths, self.colors = intrinsic, depths, colors

    def __len__(self):
        return self.depths.shape[0]

    def read_frame(self, i):
        return self.depths[i], self.colors[i]


def fragment_phases(dev, intr, n_frames: int, span: float, out_dir: str, zero_counts,
                    launch_counts, parity_frame: int = 10, profile_dir=None,
                    **cfg_overrides) -> dict:
    """Phases 8-9: the fragment slice through make_fragments, its gates, K3
    against its plain version at the slice's own work list, and the
    fragment path's stage times. Returns what the summary and the kernel
    line report."""
    import torch

    from open3d_tpu_torch import io as rio
    from open3d_tpu_torch.core import hashmap as hm
    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
    from open3d_tpu_torch.ops.kernels import tsdf as k3
    from open3d_tpu_torch.pipelines import odometry as odo
    from open3d_tpu_torch.pipelines import pose_graph as pg
    from open3d_tpu_torch.pipelines import reconstruction as rc

    # ---- 8. the fragment slice
    depths, colors, extr, _ = synthetic.render_sequence(n_frames, intrinsic=intr, span=span,
                                                        device=dev)
    seq = MemorySequence(intr, depths, colors)
    rcfg = rc.ReconstructionConfig(path_output=out_dir, **cfg_overrides)
    check(rcfg.fragment_size == n_frames, "one fragment")
    # Where make_fragments' time goes: each stage function is timed on the
    # host clock with a device sync on both sides, summed over its calls.
    # The unoptimised fragment graph is kept for timing phase 9.
    spied = {"_read_rgbd": rc, "_odometry_pair": rc, "integrate_fragment_frame": rc,
             "global_optimization": pg, "write_pose_graph": pg,
             "extract_point_cloud": vbg_mod, "write_point_cloud": rio}
    originals = {name: getattr(mod, name) for name, mod in spied.items()}
    inside_ms = {name: 0.0 for name in spied}
    graphs_in = []

    def timed(name):
        def run(*a, **kw):
            if name == "global_optimization":
                graphs_in.append((a, kw))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[name](*a, **kw)
            torch.cuda.synchronize()
            inside_ms[name] += (time.perf_counter() - t) * 1e3
            return out
        return run

    for name, mod in spied.items():
        setattr(mod, name, timed(name))
    try:
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        paths = rc.make_fragments(seq, rcfg, device=dev)
        torch.cuda.synchronize()
        make_fragments_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    finally:
        for name, mod in spied.items():
            setattr(mod, name, originals[name])
    inside_ms["rest"] = make_fragments_ms - sum(inside_ms.values())
    log(f"[8] make_fragments {make_fragments_ms:.1f} ms, launches {launches}, "
        f"peak {peak_bytes} B above the {base_bytes} B held before; inside it, ms: "
        f"{json.dumps(inside_ms)}")
    check(launches["fuse_blocks"] == n_frames, f"K3 once per integrated frame {launches}")
    check(launches["integrate_blocks_v2"] == 0 and launches["integrate_blocks_v1"] == 0,
          f"the 8^3 fragment grid takes K3 only {launches}")
    check(all(launches[n] == 0 for n in PROBE_KERNELS), f"make_fragments runs no probe {launches}")

    json_path = os.path.join(out_dir, "fragments", "fragment_000.json")
    check(paths == [os.path.join(out_dir, "fragments", "fragment_000.ply")]
          and os.path.isfile(paths[0]) and os.path.isfile(json_path), f"artifacts {paths}")
    graph = pg.read_pose_graph(json_path, device=dev)
    check(graph.poses.shape[0] == n_frames, f"{graph.poses.shape[0]} nodes")
    truth = extr[0] @ lie.invert_se3(extr)  # frame i -> frame 0
    rot, trans = lie.pose_distance(graph.poses, truth)
    n_edges_in = int(graphs_in[0][0][0].edges.shape[0])
    frag = {"max_rot_err": float(rot.max()), "max_trans_err": float(trans.max()),
            "edges": n_edges_in, "edges_kept": int(graph.edge_valid.sum()),
            "loop_closures_kept": int((graph.edge_valid & graph.uncertain).sum())}
    cloud = rio.read_point_cloud(paths[0], device=dev)
    n_pts = int(cloud.count())
    p0 = lie.transform_points(lie.invert_se3(extr[0]), cloud.positions[cloud.mask])
    sdf = synthetic.default_scene_sdf(p0).abs()
    frag.update(points=n_pts, hit_cap=n_pts >= rcfg.fragment_point_capacity,
                sdf_median_m=float(sdf.median()), sdf_q90_m=float(torch.quantile(sdf, 0.9)))
    log(f"[8] fragment {frag}; trans errs {[round(float(t), 5) for t in trans]}")
    vox = rcfg.voxel_size * 2
    check(frag["max_trans_err"] < POSE_TOL and frag["max_rot_err"] < POSE_TOL,
          f"fragment poses vs truth {frag}")
    check(n_pts > 10000, f"fragment cloud size {frag}")
    check(frag["sdf_median_m"] < vox and frag["sdf_q90_m"] < 2 * vox, f"cloud on the surface {frag}")

    # ---- 9. the fragment grid again from those poses: K3 parity at the
    # parity frame's work list, and the stage times
    rgbds = [rc._read_rgbd(seq, i, rcfg, dev) for i in range(n_frames)]
    poses = graph.poses.cpu().numpy()
    grid = rc.create_fragment_grid(rcfg, dev)
    C = grid.capacity
    integrate_ms = []
    k3_out = None
    for i in range(n_frames):
        if i == parity_frame:
            k3_out = k3_parity(grid, rgbds[i], poses[i], intr, rcfg, hm, vbg_mod, k3)
        grid, ms = event_ms(lambda: rc.integrate_fragment_frame(grid, rgbds[i], poses[i], intr,
                                                                rcfg))
        integrate_ms.append(ms)
    again = vbg_mod.extract_point_cloud(grid, point_capacity=rcfg.fragment_point_capacity,
                                        weight_threshold=2.0)
    check(int(again.count()) == n_pts, f"the PLY holds the grid's cloud: {int(again.count())}")
    extract_ms = [event_ms(lambda: vbg_mod.extract_point_cloud(
        grid, point_capacity=rcfg.fragment_point_capacity, weight_threshold=2.0))[1]
        for _ in range(3)]
    pair_ms, info_ms = [], []
    for i in range(5):
        res, ms = event_ms(lambda: odo.rgbd_odometry_multi_scale(
            rgbds[i], rgbds[i + 1], intr, method=rcfg.odometry_method))
        pair_ms.append(ms)
        info_ms.append(event_ms(lambda: odo.compute_odometry_information_matrix(
            rgbds[i].depth, rgbds[i + 1].depth, intr, res.transformation))[1])
    a, kw = graphs_in[0]
    opt_ms = [event_ms(lambda: pg.global_optimization(*a, **kw))[1] for _ in range(3)]
    times = {"make_fragments": make_fragments_ms,
             "odometry_pair": statistics.median(pair_ms),
             "information_matrix": statistics.median(info_ms),
             "global_optimization": statistics.median(opt_ms),
             "fragment_frame_integrate": statistics.median(integrate_ms),
             "extract_point_cloud": statistics.median(extract_ms)}
    log("[9] fragment stage medians ms " + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f" | {C} blocks, active {int(grid.num_active_blocks())}")
    prof = None
    if profile_dir:
        def pair(i):
            odo.rgbd_odometry_multi_scale(rgbds[i], rgbds[i + 1], intr, method=rcfg.odometry_method)

        prof = profile_steps(pair, 3, profile_dir, times["odometry_pair"], "odometry_pair")
        log("[9] profile of the odometry pair " + json.dumps(prof))
    return {"launches": launches, "fragment": frag, "times": times, "peak_bytes": peak_bytes,
            "inside_ms": inside_ms, "k3": k3_out, "profile": prof,
            # for phase 11: the 8^3 grid in frame 0's coordinates, the
            # fragment poses (frame i -> frame 0) and frame 0's world pose
            "grid": grid, "poses": graph.poses, "world_to_frame0": extr[0],
            "depth_max": rcfg.depth_max, "voxel": vox}


def k3_parity(grid, rgbd, pose, intr, rcfg, hm, vbg_mod, k3) -> dict:
    """K3 and fuse_blocks_plain from identical copies of the grid, on this
    frame's work list and `_new_voxel_values` samples, with and without
    colour; then their times and the bound."""
    import numpy as np
    import torch

    from open3d_tpu_torch.ops.kernels._timing import device_ms

    C = grid.capacity
    extr = torch.as_tensor(np.linalg.inv(pose), dtype=torch.float32).to(grid.device)
    keys, touched = vbg_mod.compute_unique_block_coordinates(
        grid, rgbd.depth, intr, extr, depth_max=rcfg.depth_max, frame_block_capacity=4096)
    table, slot, ok = hm.activate(grid.table, keys)
    rows = torch.where(ok, slot, C).to(torch.int32).contiguous()
    tsdf_new, wn, cnew = vbg_mod._new_voxel_values(
        grid, keys, rgbd.depth, rgbd.color, intr, extr, rcfg.depth_max, 1.0, ok)
    live = rows[rows < C].long()
    out = {"rows": rows.numel(), "live_rows": live.numel(), "touched": int(touched)}
    for with_color in (True, False):
        tw_a, tw_b = grid.tw_flat.clone(), grid.tw_flat.clone()
        col_a = grid.color_flat.clone() if with_color else None
        col_b = grid.color_flat.clone() if with_color else None
        c_new = cnew if with_color else None
        k3.fuse_blocks(tw_a, col_a, rows, tsdf_new, wn, c_new)
        k3.fuse_blocks_plain(tw_b, col_b, rows, tsdf_new, wn, c_new)
        torch.cuda.synchronize()
        par = row_parity(vbg_mod, live, tw_a, col_a, tw_b, col_b)
        par["rows_changed"] = int((tw_a[live] != grid.tw_flat[live]).any(-1).sum())
        name = "colour" if with_color else "no_colour"
        log(f"[9] K3 {name}: {out} {par}")
        check_bit_parity(f"K3 {name}", par)
        check(par["rows_changed"] > live.numel() // 2, f"K3 updated the live rows {par}")
        out[name] = par
        if with_color:
            out.update(k3_times(k3, tw_a, col_a, rows, tsdf_new, wn, c_new, C))
            out["plain_ms"] = device_ms(
                lambda: k3.fuse_blocks_plain(tw_b, col_b, rows, tsdf_new, wn, c_new), reps=3)
    B3 = grid.tw_flat.shape[1]
    out["bytes"] = live.numel() * B3 * K3_BYTES_VOXEL + rows.numel() * 4
    out["ops"] = live.numel() * B3 * K3_OPS_VOXEL
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["ops"])
    out["max_abs_err"] = max(out["colour"]["max_abs_err"], out["no_colour"]["max_abs_err"])
    out["occupancy"] = {"colour": k3.occupancy(True, B3), "no_colour": k3.occupancy(False, B3)}
    log(f"[9] K3 {out['ms']:.4f} ms warm (spread {out['spread_ms']:.4f}), {out['cold_ms']:.4f} ms "
        f"cold (spread {out['cold_spread_ms']:.4f}), launch floor "
        f"{out['floor_ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"by {out['bound_by']} ({out['bytes']} B, {out['ops']} flop); {out['occupancy']}")
    return out


def k3_times(k3, tw, col, rows, tsdf_new, wn, cnew, C: int) -> dict:
    """K3 warm and cold on this work list, and its launch floor: the same
    list with every entry the dump row C, warm (what this design takes for
    a list with nothing to fuse)."""
    import torch

    from open3d_tpu_torch.ops.kernels._timing import cold_ms, device_ms, median_of

    dump = torch.full_like(rows, C)
    out = {}
    for key, timer, r in (("ms", device_ms, rows), ("cold_ms", cold_ms, rows),
                          ("floor_ms", device_ms, dump)):
        out[key], out[key.replace("ms", "spread_ms")] = median_of(
            lambda: timer(lambda: k3.fuse_blocks(tw, col, r, tsdf_new, wn, cnew), reps=20))
    return out


def kernels_only_k3_p2(dev) -> None:
    """--kernels-only: K3 on a synthetic fragment-sized work list (4096
    entries, the first 395 live, an 8192-block 8^3 grid) and P2 at the
    script's three configurations, each against its plain version, timed,
    with its occupancy."""
    import torch

    from open3d_tpu_torch.ops.kernels import micro_gather as p2
    from open3d_tpu_torch.ops.kernels import tsdf as k3

    gen = torch.Generator(device=dev).manual_seed(0)
    tw, col, rows, tsdf_new, wn, cnew = k3.synthetic_work_list(gen, dev)
    C = tw.shape[0] - 1
    tw_b, col_b = tw.clone(), col.clone()
    k3.fuse_blocks(tw, col, rows, tsdf_new, wn, cnew)
    k3.fuse_blocks_plain(tw_b, col_b, rows, tsdf_new, wn, cnew)
    torch.cuda.synchronize()
    check(torch.equal(tw[:C], tw_b[:C]) and torch.equal(col[:C], col_b[:C]), "K3 bit parity")
    log(f"[k] K3 synthetic {k3_times(k3, tw, col, rows, tsdf_new, wn, cnew, C)} "
        f"{k3.occupancy(True, tw.shape[1])}")
    del tw, col, tw_b, col_b, tsdf_new, wn, cnew
    for R, s_chunk in p2.CONFIGS:
        inputs = p2.make_inputs(R, p2.n_indices(s_chunk), gen, dev)
        log(f"[k] P2 {p2_row(p2, R, s_chunk, *inputs)}")


def probe_library_call(probe, inputs):
    """One PyTorch call that computes one instance of a P1 probe's
    operation (without the loop index): its yardstick. Index tensors are
    widened to int64 here, outside the returned call."""
    import torch

    x = inputs[0]
    if probe.kind == "mul":
        return lambda: torch.mul(x, 2.0)
    if probe.kind == "reshape":
        return lambda: torch.add(x.view(probe.out_shape), 1.0)
    if probe.kind == "transpose":
        return lambda: x.t().contiguous()
    if probe.kind == "bcast":
        return lambda: x[:, :, None].expand(probe.out_shape).contiguous()
    if probe.family == "gather" or probe.kind == "maskmul":
        idx = inputs[1].long()
        return lambda: torch.gather(x, 1, idx)
    if probe.kind == "segment":
        v = x.view(x.shape[0], -1, 128)
        return lambda: torch.sum(v, dim=2)
    if probe.kind == "sublane":
        v = x.view(16, 128, x.shape[1])
        return lambda: torch.sum(v, dim=1)
    if probe.kind == "onehot":
        lanes = torch.arange(probe.out_shape[1], device=x.device, dtype=torch.int32)[None, :]
        return lambda: torch.eq(lanes, x)
    y = inputs[1]  # the products; bfloat16 in, bfloat16 out (float32 sums inside)
    return lambda: torch.matmul(x, y)


SASS_OPS = ("HGMMA", "HMMA", "FFMA")


def sass_op_counts(lib_path, kernels) -> dict:
    """For each compiled function whose name contains one of `kernels`
    (its template argument appended, as "<80>"), the number of each SASS
    instruction in SASS_OPS, read with cuobjdump from the toolkit that
    built the library."""
    from open3d_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True).stdout
    counts = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        for k in kernels:
            if k in fn:
                arg = re.search(r"ILi(\d+)E", fn)
                counts[k + (f"<{arg.group(1)}>" if arg else "")] = {
                    op: len(re.findall(r"\b" + op + r"\b", body)) for op in SASS_OPS}
    return counts


def p2_row(p2, R: int, s_chunk: int, table, idx, out=None) -> dict:
    """P2 at one configuration: `out` (the kernel's output, computed here
    when not given) bit-equal to the plain version; kernel, plain and
    torch.take times, the bound, and the kernel's occupancy."""
    import torch

    from open3d_tpu_torch.ops.kernels._timing import device_ms, median_of

    if out is None:
        out = p2.gather(table, idx)
    ref = p2.gather_plain(table, idx)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"P2 R={R} chunk={s_chunk} bit parity (max |d| {err})")
    n = idx.numel()
    b_ms, b_by = bound(p2.bytes_moved(R, n), 0)
    idx64 = idx.long()  # torch.take takes int64 indices only
    ms, spread = median_of(lambda: device_ms(lambda: p2.gather(table, idx), reps=20))
    return {"R": R, "s_chunk": s_chunk, "indices": n, "max_abs_err": err,
            "ms": ms, "spread_ms": spread,
            "plain_ms": device_ms(lambda: p2.gather_plain(table, idx), reps=5),
            "library_ms": device_ms(lambda: torch.take(table, idx64), reps=20),
            "bound_ms": b_ms, "bound_by": b_by, "occupancy": p2.occupancy(R)}


def micro_phase(dev, zero_counts, launch_counts) -> list:
    """Phase 10: the probes' path. Drives P2, P3 and P1 at the scripts' own
    sizes with the counts set to 0 just before and read just after, holds
    those outputs against the plain versions, then times each kernel, its
    plain version and its PyTorch yardstick. Returns the three kernel
    entries of the summary line."""
    import torch

    from open3d_tpu_torch.ops.kernels import _build
    from open3d_tpu_torch.ops.kernels import micro_gather as p2
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1
    from open3d_tpu_torch.ops.kernels import micro_raymarch as p3
    from open3d_tpu_torch.ops.kernels._timing import N_READINGS, device_ms, median_of

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    p2_in = [(R, s, *p2.make_inputs(R, p2.n_indices(s), gen, dev)) for R, s in p2.CONFIGS]
    tw, rows = p3.make_inputs(gen, dev)
    p1_in = [(p, p1.make_inputs(p, gen, dev)) for p in p1.PROBES]
    torch.cuda.synchronize()
    zero_counts()
    p2_out = [p2.gather(table, idx) for _, _, table, idx in p2_in]
    p3_out = p3.march(rows, tw)
    p1_out = [(p1.run_probe(p, ins, p1.ITERS_LO), p1.run_probe(p, ins, p1.ITERS_HI))
              for p, ins in p1_in]
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[10] probes' path: launches {launches}")
    check(all(launches[n] >= 1 for n in PROBE_KERNELS), f"P1-P3 ran {launches}")
    check(all(c == 0 for n, c in launches.items() if n not in PROBE_KERNELS),
          f"the probes take no kernel of the engine {launches}")

    # ---- P2 at the three configurations: bit parity, times summed over them
    configs = []
    for (R, s_chunk, table, idx), out in zip(p2_in, p2_out):
        row = p2_row(p2, R, s_chunk, table, idx, out)
        log(f"[10] P2 {row}")
        configs.append(row)
    del p2_in, p2_out

    def total(rows_, key):
        return sum(r[key] for r in rows_)

    p2_entry = {
        "name": "micro_gather", "route": "cuda", "source": "open3d_tpu_torch/csrc/micro_gather.cu",
        "replaces": "scripts/micro_onehot_gather.py:49", "launches": launches["micro_gather"],
        "max_abs_err": max(r["max_abs_err"] for r in configs),
        "ms": total(configs, "ms"), "kernel_ms": total(configs, "ms"),
        "spread_ms": total(configs, "spread_ms"),
        "plain_ms": total(configs, "plain_ms"), "bound_ms": total(configs, "bound_ms"),
        "bound_by": "bytes", "library_ms": total(configs, "library_ms"),
        "library": "torch.take on int64 indices", "times": "sums over the three configurations of " + MEDIAN_TIMES,
        "parity": {"bit_equal": True}, "tolerance": {"max_abs_err": 0.0}, "configs": configs,
    }

    # ---- P3 at the script's size
    ref = p3.march_plain(rows, tw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(p3_out).all()) and tuple(p3_out.shape) == (p3.T, 1, p3.NR),
          "P3 depths finite, (T, 1, 256)")
    par = p3.parity(p3_out, ref)
    check(par["hit_agree"] >= P3_TOL["hit_agree"] and par["max_abs_dz"] <= P3_TOL["max_abs_dz"]
          and par["hit_frac"] > 0.5, f"P3 against its plain version {par}")
    per_sm, sms = p3.occupancy()
    n_tiles = rows.shape[0]
    p3_ms, p3_spread = median_of(lambda: device_ms(lambda: p3.march(rows, tw), reps=20))
    b_ms, b_by = bound(p3.bytes_moved(n_tiles), p3.ops(n_tiles))
    p3_entry = {
        "name": "micro_raymarch", "route": "cuda", "source": "open3d_tpu_torch/csrc/micro_raymarch.cu",
        "replaces": "scripts/micro_raymarch_kernel.py:87", "launches": launches["micro_raymarch"],
        "max_abs_err": par["max_abs_dz"],
        "ms": p3_ms, "spread_ms": p3_spread,
        "plain_ms": device_ms(lambda: p3.march_plain(rows, tw), reps=2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "times": MEDIAN_TIMES,
        "library": "none: no PyTorch call marches rays through staged blocks",
        "parity": par, "tolerance": P3_TOL,
        "occupancy": {"ctas_per_sm": per_sm, "sms": sms,
                      "waves": -(-n_tiles // (per_sm * sms))},
    }
    p3_entry["kernel_ms"] = p3_entry["ms"]
    log(f"[10] P3 {p3_entry} ({p3.bytes_moved(n_tiles)} B, {p3.ops(n_tiles)} flop)")
    del tw, rows, p3_out, ref
    torch.cuda.empty_cache()

    # ---- P1: each probe at iters = 1000 against its plain version, then ns
    # an instance (the slope between 1000 and 9000), beside the plain
    # version's and one PyTorch call's time an instance
    probes = []
    for (p, ins), (out, _) in zip(p1_in, p1_out):
        ref = p1.probe_plain(p, ins, p1.ITERS_LO)
        torch.cuda.synchronize()
        rel = p1.rel_err(out, ref)
        check(rel <= p1.tolerance(p), f"P1 {p.name}: {rel} > {p1.tolerance(p)}")
        peak = H100_BF16_PER_S if p.family == "mma_bf16" else H100_F32_PER_S
        ns, spread = p1.slope_ns(p, ins)
        row = {"name": p.name, "family": p.family, "rel_err": rel, "tolerance": p1.tolerance(p),
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "ns": ns, "spread_ns": spread,
               "plain_ns": device_ms(lambda: p1.probe_plain(p, ins, p1.ITERS_LO), reps=1,
                                   warmup=0) / p1.ITERS_LO * 1e6,
               "library_ns": device_ms(probe_library_call(p, ins), reps=100) * 1e6,
               "bound_ns": p1.instance_ops(p) / peak * 1e9, "bound_by": "operations"}
        row["x_bound"] = row["ns"] / row["bound_ns"]
        if p.family in ("mma_bf16", "ffma"):
            row["occupancy"] = p1.occupancy(p)
        log(f"[10] P1 {row}")
        occ = row.get("occupancy", {})
        log(f"[10] P1 row | {p.name} | {ns:.1f} ns | bound {row['bound_ns']:.1f} ns | "
            f"{row['x_bound']:.2f}x | library {row['library_ns']:.1f} ns | spread {spread:.1f} ns"
            + (f" | {occ['registers']} registers, {occ['ctas_per_sm']} CTAs/SM" if occ else ""))
        probes.append(row)
    p1_entry = {
        "name": "micro_primitives", "route": "cuda",
        "source": "open3d_tpu_torch/csrc/micro_primitives.cu", "replaces": "scripts/perf_micro.py:39",
        "launches": launches["micro_primitives"],
        "max_abs_err": max(r["max_abs_err"] for r in probes),
        "ms": total(probes, "ns") / 1e6, "plain_ms": total(probes, "plain_ns") / 1e6,
        "bound_ms": total(probes, "bound_ns") / 1e6, "bound_by": "operations",
        "library_ms": total(probes, "library_ns") / 1e6,
        "spread_ns": total(probes, "spread_ns"),
        "times": f"one instance of each of the 17 probes, summed; each the median of {N_READINGS} slopes",
        "parity": {r["name"]: r["rel_err"] for r in probes},
        "tolerance": {r["name"]: r["tolerance"] for r in probes}, "probes": probes,
    }
    p1_entry["kernel_ms"] = p1_entry["ms"]
    # the bfloat16 product runs on wgmma, the float32 product on fmaf alone
    sass = sass_op_counts(_build.build(), ("wgmma_bf16_kernel", "ffma_kernel"))
    log(f"[10] P1 SASS instruction counts {sass}")
    mma = [v for k, v in sass.items() if k.startswith("wgmma_bf16_kernel")]
    check(len(mma) == 2 and all(v["HGMMA"] > 0 for v in mma), f"P1 bf16 product on HGMMA {sass}")
    f32 = sass.get("ffma_kernel", {})
    check(f32.get("FFMA", 0) > 0 and f32["HMMA"] == 0 and f32["HGMMA"] == 0,
          f"P1 float32 product on FFMA alone {sass}")
    p1_entry["sass"] = sass
    log(f"[10] probes' phase {time.perf_counter() - t_start:.1f} s")
    return [p1_entry, p2_entry, p3_entry]


def camera_facing(normal, hit, intr) -> float:
    """The share of hits whose camera-frame normal faces the camera: its dot
    with the pixel's ray [x, y, 1] is <= 1e-6."""
    import torch

    v, u = torch.nonzero(hit, as_tuple=True)
    rays = torch.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                        torch.ones_like(u, dtype=torch.float32)], -1)
    return float(((normal[hit] * rays).sum(-1) <= 1e-6).float().mean())


def surface_phase(dev, intr, cfg, depths, colors, extr, frag, zero_counts, launch_counts,
                  smi: str) -> dict:
    """Phase 11: the whole raycast surface at full width. SLAM with raycast
    normals over the bench orbit's frames 0-3 (each frame's camera-frame
    normal map feeding the next frame's tracking), then every map at once
    on that grid from frame 3's pose, held against the same function on a
    CPU copy and against the synthetic truth; the sphere trace on the 16^3
    SLAM grid and on phase 8's 8^3 fragment grid; and the times, each on a
    line of its own with the card's name and power limit."""
    import dataclasses

    import torch

    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
    from open3d_tpu_torch.models import dense_slam
    from open3d_tpu_torch.ops.kernels._timing import median_of

    t_start = time.perf_counter()
    n = 4  # the bench orbit's frames both packages track (phase 5)

    # ---- 11a. the SLAM slice with normals on, and with them off for the
    # step time (the same frames, the same call)
    def run(config):
        model = dense_slam.create_model(config, T_init=lie.invert_se3(extr[0]), device=dev)
        md, mn, out = torch.zeros_like(depths[0]), None, []
        for i in range(n):
            res, ms = event_ms(lambda: dense_slam.slam_step(model, depths[i], colors[i], md, intr,
                                                            model_normal=mn))
            model, md, mn = res.model, res.raycast_depth, res.raycast_normal
            r, t = lie.pose_distance(model.T_frame_to_world, lie.invert_se3(extr[i]))
            out.append({"ms": ms, "rot": float(r), "trans": float(t), "depth": md, "normal": mn})
        return model, out

    _, off = run(cfg)
    zero_counts()
    model, on = run(dataclasses.replace(cfg, raycast_normals=True))
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches["march_tiles"] == n and launches["integrate_blocks_v2"] == n,
          f"SLAM with normals raycasts through K2 and integrates through K1 {launches}")
    check(all(c == 0 for k, c in launches.items()
              if k not in ("march_tiles", "integrate_blocks_v2")), f"only K1 and K2 {launches}")
    slam = {"max_rot_err": max(f["rot"] for f in on), "max_trans_err": max(f["trans"] for f in on),
            "launches": launches, "frames": []}
    for f in on:
        hit = f["depth"] > 0
        lens = torch.linalg.norm(f["normal"][hit], dim=-1)
        slam["frames"].append({"hit_frac": float(hit.float().mean()),
                               "max_unit_err": float((lens[lens > 0] - 1).abs().max()),
                               "zero_normals": float((lens == 0).float().mean()),
                               "camera_facing": camera_facing(f["normal"], hit, intr)})
    log(f"[11] SLAM with raycast normals, bench orbit frames 0-{n - 1}: {slam}")
    check(slam["max_trans_err"] < POSE_TOL and slam["max_rot_err"] < POSE_TOL,
          f"pose error vs truth with normals {slam}")
    check(all(f["hit_frac"] > 0.5 and f["max_unit_err"] < 1e-3 and f["camera_facing"] > 0.95
              for f in slam["frames"]), f"unit, camera-facing normals {slam}")

    # ---- 11b. every map at once on the grid after frame 3, from its pose
    grid, E = model.vbg, extr[n - 1]
    res = vbg_mod.raycast(grid, intr, E, cfg.depth_min, cfg.depth_max, with_color=True,
                          with_normals=True, with_index_ratio=True)
    cpu = vbg_mod.VoxelBlockGrid(grid.table.cpu(), grid.tw.cpu(), grid.color.cpu(),
                                 grid.voxel_size, grid.block_resolution, grid.sdf_trunc)
    ref = vbg_mod._maps_on_depth(cpu, intr, E.cpu(), res.depth.cpu(), cfg.depth_max, True, True,
                                 True)
    hit = res.mask
    maps = {"hit_frac": float(hit.float().mean()),
            "index_equal": bool(torch.equal(res.index.cpu(), ref.index)),
            "mask_equal": bool(torch.equal(hit.cpu(), ref.mask))}
    for name in ("vertex", "color", "normal", "interp_ratio"):
        maps[f"{name}_max_abs_err"] = float((getattr(res, name).cpu() - getattr(ref, name)).abs().max())
    vert = res.vertex[hit]
    col_err = (res.color[hit] - synthetic.scene_color(vert)).abs().amax(-1)
    nrm = res.normal[hit]
    valid_n = torch.linalg.norm(nrm, dim=-1) > 0
    cos = (nrm * synthetic.sdf_normal(synthetic.default_scene_sdf, vert)).sum(-1)[valid_n]
    ang = torch.rad2deg(torch.acos(torch.clamp(cos, -1.0, 1.0)))
    idx8, wt8 = res.index[hit], res.interp_ratio[hit]
    ts, _ = vbg_mod.unpack_tw(grid.tw.view(-1)[torch.clamp(idx8, min=0)])
    wsum = wt8.sum(-1)
    good = wsum > 0.5
    full = (idx8 >= 0).all(-1)
    maps.update(
        color_err_median=float(col_err.median()), color_err_q90=float(torch.quantile(col_err, 0.9)),
        normal_deg_median=float(ang.median()), normal_deg_q90=float(torch.quantile(ang, 0.9)),
        tsdf_abs_median=float(((ts * wt8).sum(-1)[good] / wsum[good]).abs().median()),
        full_corner_frac=float(full.float().mean()),
        partition_max_err=float((wt8[full].sum(-1) - 1).abs().max()))
    log(f"[11] all maps from frame {n - 1}'s pose: {maps}")
    check(maps["index_equal"] and maps["mask_equal"], f"maps on the card vs a CPU copy {maps}")
    check(all(maps[f"{k}_max_abs_err"] <= 1e-5 for k in ("vertex", "color", "normal", "interp_ratio")),
          f"maps on the card vs a CPU copy within 1e-5 {maps}")
    check(maps["hit_frac"] > 0.5 and maps["color_err_median"] < COLOR_TOL["median"]
          and maps["color_err_q90"] < COLOR_TOL["q90"], f"colour map vs the scene's texture {maps}")
    check(maps["normal_deg_median"] < NORMAL_TOL_DEG["median"]
          and maps["normal_deg_q90"] < NORMAL_TOL_DEG["q90"], f"normal map vs the scene's SDF {maps}")
    check(maps["tsdf_abs_median"] < 0.1 and maps["partition_max_err"] < 1e-4
          and maps["full_corner_frac"] > 0.9, f"index/ratio maps {maps}")

    # ---- 11c. the sphere trace on the 16^3 SLAM grid against K2's depth
    # and the truth
    trace = vbg_mod.raycast(grid, intr, E, cfg.depth_min, cfg.depth_max, use_pallas=False)
    hk, ht = hit, trace.mask
    both = hk & ht
    dz = (trace.depth - res.depth).abs()[both]
    truth = depths[n - 1]
    valid = ht & (truth > 0)
    err = (trace.depth - truth).abs()[valid]
    tr16 = {"hit_frac": float(ht.float().mean()), "hit_agree": float((hk == ht).float().mean()),
            "median_dz_vs_march_m": float(dz.median()), "valid_frac": float(valid.float().mean()),
            "median_err_m": float(err.median()), "gross_frac": float((err > 0.05).float().mean())}
    log(f"[11] sphere trace, 16^3 SLAM grid: {tr16}")
    check(tr16["hit_agree"] > TRACE_HIT_AGREE and tr16["median_dz_vs_march_m"] < grid.voxel_size,
          f"sphere trace vs K2's depth {tr16}")
    check(tr16["valid_frac"] > 0.5 and tr16["median_err_m"] < 0.01 and tr16["gross_frac"] < 0.15,
          f"sphere trace vs the truth {tr16}")

    # ---- 11d. the sphere trace on phase 8's 8^3 fragment grid, from a
    # fragment pose (frame k -> frame 0), against the scene's SDF
    fgrid, k = frag["grid"], frag["poses"].shape[0] // 2
    Ef = lie.invert_se3(frag["poses"][k])
    ftr = vbg_mod.raycast(fgrid, intr, Ef, cfg.depth_min, frag["depth_max"])
    p_world = lie.transform_points(lie.invert_se3(frag["world_to_frame0"]), ftr.vertex[ftr.mask])
    sdf = synthetic.default_scene_sdf(p_world).abs()
    tr8 = {"frame": k, "hit_frac": float(ftr.mask.float().mean()), "sdf_median_m": float(sdf.median()),
           "sdf_q90_m": float(torch.quantile(sdf, 0.9))}
    log(f"[11] sphere trace, 8^3 fragment grid: {tr8}")
    check(tr8["hit_frac"] > 0.5 and tr8["sdf_median_m"] < frag["voxel"],
          f"fragment trace on the surface {tr8}")

    # ---- 11e. times (printed, not gated)
    def med(fn):
        return median_of(lambda: event_ms(fn)[1])

    depth_img = res.depth
    times = {
        "march_depth_only_ms": med(lambda: vbg_mod.raycast(grid, intr, E, cfg.depth_min,
                                                           cfg.depth_max, with_color=False)),
        "march_all_maps_ms": med(lambda: vbg_mod.raycast(
            grid, intr, E, cfg.depth_min, cfg.depth_max, with_color=True, with_normals=True,
            with_index_ratio=True)),
        "color_map_ms": med(lambda: vbg_mod._maps_on_depth(grid, intr, E, depth_img,
                                                          cfg.depth_max, True, False, False)),
        "normal_map_ms": med(lambda: vbg_mod._maps_on_depth(grid, intr, E, depth_img,
                                                           cfg.depth_max, False, True, False)),
        "index_ratio_maps_ms": med(lambda: vbg_mod._maps_on_depth(grid, intr, E, depth_img,
                                                                 cfg.depth_max, False, False, True)),
        "vertex_only_ms": med(lambda: vbg_mod._maps_on_depth(grid, intr, E, depth_img,
                                                            cfg.depth_max, False, False, False)),
        "trace_16_ms": med(lambda: vbg_mod.raycast(grid, intr, E, cfg.depth_min, cfg.depth_max,
                                                   use_pallas=False, with_color=False)),
        "trace_8_ms": med(lambda: vbg_mod.raycast(fgrid, intr, Ef, cfg.depth_min,
                                                  frag["depth_max"], with_color=False)),
        "slam_step_normals_on_median_ms": statistics.median(f["ms"] for f in on[1:]),
        "slam_step_normals_off_median_ms": statistics.median(f["ms"] for f in off[1:]),
    }
    for name, v in times.items():
        ms, spread = v if isinstance(v, tuple) else (v, None)
        log(f"[11] time {name} {ms:.4f} ms" + ("" if spread is None else f" (spread {spread:.4f})")
            + f" | card {smi}")
    log(f"[11] surface phase {time.perf_counter() - t_start:.1f} s")
    return {"slam_normals": {k_: v for k_, v in slam.items() if k_ != "frames"}, "maps": maps,
            "trace_16": tr16, "trace_8": tr8,
            "times_ms": {k_: (v[0] if isinstance(v, tuple) else v) for k_, v in times.items()}}


def cloud_diff(a, b) -> dict:
    """How two clouds of one capacity differ: masks equal, and the largest
    difference of positions and of each attribute on the valid rows."""
    import torch

    out = {"mask_equal": bool(torch.equal(a.mask.cpu(), b.mask.cpu())), "max_abs_err": 0.0}
    if out["mask_equal"]:
        m = a.mask.cpu()
        for x, y in [(a.positions, b.positions)] + [(a.attrs[k], b.attrs[k]) for k in a.attrs]:
            if m.any():
                out["max_abs_err"] = max(out["max_abs_err"], float((x.cpu()[m] - y.cpu()[m]).abs().max()))
    return out


def clouds_equal(a, b) -> bool:
    import torch

    return (torch.equal(a.mask, b.mask) and torch.equal(a.positions, b.positions)
            and set(a.attrs) == set(b.attrs) and all(torch.equal(a.attrs[k], b.attrs[k]) for k in a.attrs))


def fpfh_weight_err(idx_a, d2_a, idx_b, d2_b):
    """Per row of two FPFH neighbour tables with the same neighbour set:
    (e, the largest |d2_a / d2_b - 1| over the neighbours both weigh, inf
    where one table weighs a neighbour the other does not; the largest
    |d2_a - d2_b|), both float64 on the CPU. FPFH's aggregated part is
    100 N / D, N = sum_k s_k w_k <= D = sum_k S_k w_k with w_k = 1 / d2_k;
    weights off by a factor within 1 +- e move N and D each by at most e D,
    so rows whose SPFHs agree lie within 200 e / (1 - e) of each other."""
    import torch

    idx_a, d2_a, idx_b, d2_b = (x.cpu() for x in (idx_a, d2_a, idx_b, d2_b))
    ia, oa = torch.sort(idx_a, 1)
    _, ob = torch.sort(idx_b, 1)
    da, db = torch.gather(d2_a, 1, oa).double(), torch.gather(d2_b, 1, ob).double()
    nbr = (ia >= 0) & (ia != torch.arange(ia.shape[0])[:, None])
    wa, wb = da > 1e-12, db > 1e-12
    e = torch.where(nbr & wa & wb, (da / torch.where(wb, db, 1.0) - 1.0).abs(), 0.0)
    e = torch.where(nbr & (wa != wb), torch.inf, e).amax(1)
    return e, torch.where(nbr, (da - db).abs(), 0.0).amax(1)


def band_whole_windows(b, query, qmask, dmax: float, tile: int = 512):
    """(N,) bool: the queries whose tile of banded_one_nn's band `b` saw its
    whole candidate run, found from the public sorted keys `kt` and
    banded_query_key as the band places its windows: the run [lo, hi) of
    keys within dmax of the tile's valid keys, a window of b["window"] rows
    centred on it from a multiple of 256."""
    import torch

    from open3d_tpu_torch.core import nns

    kt, W, n = b["kt"], b["window"], query.shape[0]
    Q = min(tile, n)
    T = -(-n // Q)
    pad = T * Q - n
    kq = torch.nn.functional.pad(nns.banded_query_key(b, query), (0, pad)).reshape(T, Q)
    ok = torch.nn.functional.pad(qmask, (0, pad)).reshape(T, Q)
    lo = torch.searchsorted(kt, torch.where(ok, kq, 3e38).amin(1) - dmax, side="left")
    hi = torch.searchsorted(kt, torch.where(ok, kq, -3e38).amax(1) + dmax, side="right")
    start = torch.clamp(((lo + hi - W) // 2) & ~255, 0, kt.shape[0] - W)
    return ((lo >= start) & (hi <= start + W)).repeat_interleave(Q)[:n]


def registration_phase(dev, smi: str, zero_counts, launch_counts, intr) -> dict:
    """Phase 12: the registration path at bench.py's two workloads. ICP:
    two frames of render_sequence(2, span=0.15) unprojected with their
    extrinsics (the truth is the identity), voxel_down_sample(0.02,
    capacity=ICP_CAPACITY), estimate_normals(30); point-to-plane ICP at dmax
    0.05, 10 iterations, then 30 from a perturbed start through the band
    and the exact 1-NN; voxel_down_sample against a CPU copy and against
    itself; the band's shortfall on the card and on a CPU copy; the banded
    1-NN at run 1's pose against the exact one. Global: render_sequence(2,
    span=0.4), voxel_down_sample(0.05, capacity=FPFH_CAPACITY),
    estimate_normals(30, radius=0.1), FPFH(0.25, 64), RANSAC (dmax 0.07,
    4096 hypotheses) and FGR, on the bench's own pair (printed: it does not
    register in the JAX package either) and on frame 0's cloud against a
    rigidly moved copy of it (gated); FPFH on frame 0's cloud against a CPU
    copy (fpfh_weight_err's bar). No kernel of csrc/ is on this path:
    the counts stay 0. Times, a line each, with the card's name and power
    limit."""
    import torch

    from open3d_tpu_torch.core import lie, nns
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.pointcloud import PointCloud
    from open3d_tpu_torch.geometry.rgbd import pointcloud_from_depth
    from open3d_tpu_torch.ops import pointcloud as pc_ops
    from open3d_tpu_torch.ops.kernels._timing import median_of
    from open3d_tpu_torch.pipelines import features
    from open3d_tpu_torch.pipelines import global_registration as gr
    from open3d_tpu_torch.pipelines import registration as reg

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    eye = torch.eye(4, device=dev)

    def to_cpu(p):
        return PointCloud(p.positions.cpu(), p.mask.cpu(), {k: v.cpu() for k, v in p.attrs.items()})

    def pose_err(T, truth=eye):
        rot, trans = lie.pose_distance(T, truth)
        return {"rot_err": float(rot), "trans_err": float(trans)}

    def summary(r, truth=eye):
        return {**pose_err(r.transformation, truth), "fitness": float(r.fitness),
                "inlier_rmse": float(r.inlier_rmse), "iterations": int(r.num_iterations)}

    # ---- 12a. the ICP workload (bench.py:186-258)
    depths, _, extr, _ = synthetic.render_sequence(2, intrinsic=intr, span=0.15, device=dev)
    raw = [pointcloud_from_depth(depths[i], intr, extr[i]) for i in range(2)]
    down = [pc_ops.voxel_down_sample(p, 0.02, capacity=ICP_CAPACITY) for p in raw]
    vds = {"rows": raw[0].capacity, "points": [int(d.count()) for d in down],
           "repeat_equal": clouds_equal(down[0], pc_ops.voxel_down_sample(raw[0], 0.02, capacity=ICP_CAPACITY)),
           "cpu_copy": cloud_diff(down[0], pc_ops.voxel_down_sample(to_cpu(raw[0]), 0.02, capacity=ICP_CAPACITY))}
    log(f"[12] voxel_down_sample(0.02, capacity {ICP_CAPACITY}): {vds}")
    check(vds["repeat_equal"], f"voxel_down_sample twice on the card gives one result {vds}")
    check(vds["cpu_copy"]["mask_equal"] and vds["cpu_copy"]["max_abs_err"] <= VDS_TOL,
          f"voxel_down_sample on the card vs a CPU copy: equal rows, within {VDS_TOL} {vds}")
    src, tgt = [pc_ops.estimate_normals(d, max_nn=30) for d in down]
    est = reg.TransformationEstimationPointToPlane()
    crit10 = reg.ICPConvergenceCriteria(max_iteration=10, relative_fitness=0.0, relative_rmse=0.0)
    r1 = reg.icp(src, tgt, 0.05, estimation=est, criteria=crit10)
    init = lie.se3_exp(torch.tensor([0.02, -0.015, 0.01, 0.03, -0.02, 0.01], device=dev))
    crit30 = reg.ICPConvergenceCriteria(max_iteration=30)
    r2 = {b: reg.icp(src, tgt, 0.05, init, est, crit30, nns_backend=b) for b in ("auto", "exact")}
    icp = {"run1": summary(r1), "run2_start": pose_err(init), "run2_banded": summary(r2["auto"]),
           "run2_exact": summary(r2["exact"]),
           "banded_vs_exact_max_abs": float((r2["auto"].transformation
                                             - r2["exact"].transformation).abs().max())}
    log(f"[12] ICP (point-to-plane, dmax 0.05): {icp}")
    for k in ("run1", "run2_banded", "run2_exact"):
        check(icp[k]["trans_err"] < ICP_POSE_TOL and icp[k]["rot_err"] < ICP_POSE_TOL,
              f"ICP {k} within {ICP_POSE_TOL} m / rad of the truth {icp}")
    check(icp["banded_vs_exact_max_abs"] <= BAND_EXACT_TOL, f"banded vs exact ICP {icp}")

    # the band at the identity, as bench.py:254 reads its shortfall, on the
    # card and on a CPU copy
    def band(s, t):
        b = nns.banded_build(t.positions, t.mask, est.corr_extras(t), window=2048)
        perm = torch.argsort(torch.where(s.mask, nns.banded_query_key(b, s.positions), 3e38), stable=True)
        return b, s.positions[perm], s.mask[perm]

    b, qs, qm = band(src, tgt)
    b_cpu, qs_cpu, qm_cpu = band(to_cpu(src), to_cpu(tgt))
    shortfall = {"card": int(nns.banded_one_nn(b, qs, 0.05, qmask=qm)[3]),
                 "cpu_copy": int(nns.banded_one_nn(b_cpu, qs_cpu, 0.05, qmask=qm_cpu)[3])}
    # the banded 1-NN at run 1's final pose against the exact 1-NN on the
    # card (tests/test_nns.py:97-103), on the tiles whose window was whole;
    # a query whose distance lies within the expanded form's float32 error
    # of dmax may fall on either side of the gate
    pos = lie.transform_points(r1.transformation, qs)
    idx_b, d2_b, _, short_r1 = nns.banded_one_nn(b, pos, 0.05, qmask=qm)
    whole = band_whole_windows(b, pos, qm, 0.05) & qm
    idx_e, d2_e = nns.one_nn_search(pos, tgt.positions, tgt.mask)
    valid_e = qm & (idx_e >= 0) & (d2_e <= 0.05**2)
    valid_b = idx_b >= 0
    edge = (d2_b - 0.05**2).abs() <= 4 * 2.0**-23 * (1.0 + 2.0 * (pos * pos).sum(1))
    # the band's winner is at least as close as the exact sweep's, both
    # measured in the difference form (the sweep's own d2 carries the
    # expanded form's rounding)
    d2_e_diff = ((pos - tgt.positions[idx_e.clamp(min=0).long()]) ** 2).sum(1)
    agree = (torch.where(valid_e, idx_e, -1) == idx_b) | (
        valid_e & valid_b & (d2_b <= d2_e_diff * (1 + 1e-5) + 1e-12))
    nn1 = {"queries": int(qm.sum()), "whole_window_queries": int(whole.sum()),
           "shortfall_at_run1_pose": int(short_r1), "gate_edge_queries": int((whole & edge).sum()),
           "valid_mismatch": int((whole & ~edge & (valid_e != valid_b)).sum()),
           "winner_mismatch": int((whole & ~edge & ~agree).sum()),
           "expanded_vs_difference_max_abs_d2": float((d2_e - d2_b)[valid_e & valid_b & (idx_e == idx_b)]
                                                      .abs().max())}
    log(f"[12] band shortfall at the identity {shortfall}; banded vs exact 1-NN at run 1's pose {nn1}")
    check(shortfall["card"] == shortfall["cpu_copy"], f"band shortfall on the card = CPU copy's {shortfall}")
    check(nn1["valid_mismatch"] == 0 and nn1["winner_mismatch"] == 0 and nn1["whole_window_queries"] > 0,
          f"banded 1-NN = exact 1-NN on whole windows {nn1}")

    def med(fn):
        return median_of(lambda: event_ms(fn)[1])

    crit_conv = reg.ICPConvergenceCriteria(max_iteration=icp["run2_banded"]["iterations"])

    def nn_est():
        idx, _, sel, _ = nns.banded_one_nn(b, qs, 0.05, qmask=qm)
        return est.compute(qs, {}, tgt, idx, qm & (idx >= 0), None, corr_rows=sel)

    times = {
        "voxel_down_sample_ms": med(lambda: pc_ops.voxel_down_sample(raw[0], 0.02, capacity=ICP_CAPACITY)),
        "estimate_normals_ms": med(lambda: pc_ops.estimate_normals(down[0], max_nn=30)),
        "icp_10_iterations_ms": med(lambda: reg.icp(src, tgt, 0.05, estimation=est, criteria=crit10)),
        # run 2: 30 iterations, frozen once converged, against the
        # iterations an early-exit loop would have run
        "icp_run2_30_iterations_ms": med(lambda: reg.icp(src, tgt, 0.05, init, est, crit30)),
        "icp_run2_until_converged_ms": med(lambda: reg.icp(src, tgt, 0.05, init, est, crit_conv)),
        "icp_nn_ms": med(lambda: nns.banded_one_nn(b, qs, 0.05, qmask=qm)),
        "icp_nn_estimation_ms": med(nn_est),
    }

    # ---- 12b. FPFH, RANSAC and FGR (bench.py:280-321)
    depths, _, extr, _ = synthetic.render_sequence(2, intrinsic=intr, span=0.4, device=dev)

    def prep(i):
        d = pc_ops.voxel_down_sample(pointcloud_from_depth(depths[i], intr, extr[i]), 0.05,
                                     capacity=FPFH_CAPACITY)
        return pc_ops.estimate_normals(d, max_nn=30, radius=0.1)

    def fpfh(c):
        return features.compute_fpfh_feature(c, radius=0.25, max_nn=64)

    def ransac(s, t, fs, ft):
        return gr.registration_ransac_based_on_feature_matching(
            s, t, fs, ft, 0.07, criteria=gr.RANSACConvergenceCriteria(max_iteration=4096),
            key=torch.Generator(device=dev).manual_seed(3))

    def fgr(s, t, fs, ft):
        return gr.registration_fgr_based_on_feature_matching(
            s, t, fs, ft, gr.FGROption(maximum_correspondence_distance=0.07))

    def pair(s, t, truth):
        fs, ft = fpfh(s), fpfh(t)
        _, mutual = features.correspondences_from_features(fs, ft, True, s.mask, t.mask)
        return {"points": [int(s.count()), int(t.count())], "mutual_correspondences": int(mutual.sum()),
                "ransac": summary(ransac(s, t, fs, ft), truth),
                "fgr": summary(fgr(s, t, fs, ft), truth)}, fs, ft

    c0, c1 = prep(0), prep(1)
    bench_pair, f0, f1 = pair(c0, c1, eye)
    log(f"[12] bench.py's FPFH pair (truth: the identity; printed, not gated): {bench_pair}")
    T_rigid = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.1, 0.4, 0.2], device=dev))
    T_rigid[:3, 3] = torch.tensor([0.3, -0.2, 0.5], device=dev)
    moved = c0.transform(T_rigid)
    rigid, _, fm = pair(c0, moved, T_rigid)
    rigid["fpfh_repeat_equal"] = bool(torch.equal(fpfh(c0), f0))
    log(f"[12] frame 0's cloud against a rigidly moved copy: {rigid}")
    for k in ("ransac", "fgr"):
        check(rigid[k]["trans_err"] < GLOBAL_POSE_TOL and rigid[k]["rot_err"] < GLOBAL_POSE_TOL,
              f"{k} within {GLOBAL_POSE_TOL} m / rad of the truth {rigid}")
    check(rigid["ransac"]["fitness"] > RANSAC_MIN_FITNESS, f"RANSAC fitness {rigid}")
    check(rigid["fpfh_repeat_equal"], "FPFH twice on the card gives one result")

    # FPFH through the brute force (the path of these clouds) on the card
    # against a CPU copy. Each device rounds the expanded d2 its own way, and
    # FPFH weighs by 1/d2: rows that no bin flip or neighbour-set change
    # touches must lie within 1e-3 + 200 e / (1 - e) of each other
    # (fpfh_weight_err)
    h0 = to_cpu(c0)
    (i_c, d2_c, _), (i_h, d2_h, _) = (
        nns.hybrid_search(c.positions, c.positions, 0.25, 64, target_mask=c.mask, grid_threshold=65536)
        for c in (c0, h0))
    rows = torch.arange(i_h.shape[0], dtype=torch.int32)
    # SPFHs over the CPU copy's table: a bin flip moves a row by
    # 100 / (its neighbours - 1) >= 1.5, rounding by about 1e-5
    s_c = features._spfh(c0.positions, c0.attrs["normals"], i_h.to(dev), rows.to(dev))[0].cpu()
    s_h = features._spfh(h0.positions, h0.attrs["normals"], i_h, rows)[0]
    flip = ((s_c - s_h).abs() > 1e-3).any(1) | ~(i_c.cpu().sort(1).values == i_h.sort(1).values).all(1)
    kept = h0.mask & ~flip & ~(flip[i_h.clamp(min=0).long()] & (i_h >= 0)).any(1)
    e, d2_err = fpfh_weight_err(i_c, d2_c, i_h, d2_h)
    bar = torch.where(e < 1.0, 1e-3 + 200.0 * e / (1.0 - e), torch.inf)
    err = (f0.cpu() - fpfh(h0)).abs().amax(1).double()
    fp = {"rows": int(h0.mask.sum()), "flip_or_set_rows": int((flip & h0.mask).sum()),
          "untouched_rows": int(kept.sum()), "max_abs_d2_err": float(d2_err[kept].max()),
          "max_weight_err": float(e[kept].max()), "median_bar": float(bar[kept].median()),
          "max_bar": float(bar[kept].max()), "max_row_err": float(err[kept].max()),
          "max_row_err_over_bar": float((err / bar)[kept].max()),
          "weight_gate_differs_rows": int((e.isinf() & kept).sum()),
          "max_row_err_finite_bar": float(err[kept & bar.isfinite()].max()),
          "max_row_err_all_rows": float(err[h0.mask].max())}
    log(f"[12] FPFH (brute force) on the card vs a CPU copy, frame 0's cloud: {fp}")
    check(fp["untouched_rows"] >= 0.9 * fp["rows"] and fp["max_row_err_over_bar"] <= 1.0,
          f"FPFH on the card vs a CPU copy within the bar of the tables' d2 {fp}")
    times.update({
        "fpfh_ms": med(lambda: fpfh(c0)),
        "ransac_ms": med(lambda: ransac(c0, moved, f0, fm)),
        "fgr_ms": med(lambda: fgr(c0, moved, f0, fm)),
    })
    torch.cuda.synchronize()
    launches = launch_counts()
    check(all(c == 0 for c in launches.values()), f"no kernel of csrc/ on the registration path {launches}")
    times["icp_estimation_ms"] = (times["icp_nn_estimation_ms"][0] - times["icp_nn_ms"][0], None)
    times["icp_other_ms"] = (times["icp_10_iterations_ms"][0] / 10 - times["icp_nn_estimation_ms"][0], None)
    for name, (ms, spread) in times.items():
        log(f"[12] time {name} {ms:.4f} ms" + ("" if spread is None else f" (spread {spread:.4f})")
            + f" | card {smi}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[12] peak device memory of the phase {peak} B | card {smi}")
    log(f"[12] registration phase {time.perf_counter() - t_start:.1f} s")
    return {"voxel_down_sample": vds, "icp": icp, "shortfall": shortfall, "banded_1nn": nn1,
            "bench_fpfh_pair": bench_pair, "rigid_pair": rigid, "fpfh_cpu_copy": fp, "peak_bytes": peak,
            "times_ms": {k: v[0] for k, v in times.items()}}


def profile_steps(step, n: int, out_dir: str, step_ms: float, label: str = "slam_step") -> dict:
    """torch.profiler over `n` calls of step(i): the device's busy share, the
    kernels by device time and the host ops by their own time. Writes the
    Chrome trace and the summary into `out_dir`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, n + 1):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(out_dir, f"{label}_trace.json")
    prof.export_chrome_trace(trace)  # ~10k device ops a step: tens of MB, so gzip it
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    dev_us, dev_n, host_us = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:100]
            dev_us[name] = dev_us.get(name, 0.0) + e.time_range.elapsed_us()
            dev_n[name] = dev_n.get(name, 0) + 1
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host_us[e.key] = e.self_cpu_time_total
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us, key=dev_us.get, reverse=True)[:15]
    summary = {
        "steps": n,
        "wall_ms_per_step_profiled": wall_ms / n,
        "step_ms_unprofiled": step_ms,
        "device_ms_per_step": busy_ms / n,
        "device_busy_share": busy_ms / (n * step_ms),
        "device_ops_per_step": sum(dev_n.values()) / n,
        "top_device": [[k, dev_us[k] / 1e3 / n, dev_n[k] / n] for k in top],
        "top_host_self": [[k, host_us[k] / 1e3 / n]
                          for k in sorted(host_us, key=host_us.get, reverse=True)[:15]],
    }
    with open(os.path.join(out_dir, f"{label}_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the steady frame step, writing a trace into DIR")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 4 (build, K1, K4 and K2 against their plain "
                         "versions, timed), then K3 on a synthetic fragment work list and "
                         "P2 at the script's three sizes, printing no result line")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import open3d_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the open3d_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    from open3d_tpu_torch.core import hashmap as hm
    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.models import dense_slam
    from open3d_tpu_torch.ops.kernels import _build
    from open3d_tpu_torch.ops.kernels import integrate as k4
    from open3d_tpu_torch.ops.kernels import integrate2 as k1
    from open3d_tpu_torch.ops.kernels import micro_gather as p2
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1
    from open3d_tpu_torch.ops.kernels import micro_raymarch as p3
    from open3d_tpu_torch.ops.kernels import raycast as k2
    from open3d_tpu_torch.ops.kernels import tsdf as k3
    from open3d_tpu_torch.ops.kernels._timing import cold_ms, device_ms, median_of

    wrappers = {"integrate_blocks_v2": k1.integrate_blocks_v2, "march_tiles": k2.march_tiles,
                "fuse_blocks": k3.fuse_blocks, "integrate_blocks_v1": k4.integrate_blocks,
                "micro_primitives": p1.run_probe, "micro_gather": p2.gather,
                "micro_raymarch": p3.march}

    def launch_counts() -> dict:
        return {n: f.launches for n, f in wrappers.items()}

    def zero_counts() -> None:
        for f in wrappers.values():
            f.launches = 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.time()
    lib_path = _build.build(verbose=True)
    _build.load()
    build_s = time.time() - t0
    log(f"[2] built {lib_path.name} in {build_s:.1f} s")

    # ---- frames: the bench.py sequence (PrimeSense 640x480, 8 frames, span 0.8)
    intr = PinholeCameraIntrinsic.prime_sense_default()
    cfg = dense_slam.SLAMConfig(block_count=40960, frame_block_capacity=2048)
    t0 = time.time()
    depths, colors, extr, _ = synthetic.render_sequence(8, intrinsic=intr, span=0.8, device=dev)
    torch.cuda.synchronize()
    check(depths.device.type == "cuda", "frames are on the card")
    log(f"[frames] {tuple(depths.shape)} rendered in {time.time() - t0:.1f} s, "
        f"valid {float((depths > 0).float().mean()):.3f}")

    # ---- 3. K1 against its plain version, two frames on the same grid state
    grid = vbg_mod.create(cfg.voxel_size, 16, cfg.block_count,
                          sdf_trunc=cfg.trunc_voxel_multiplier * cfg.voxel_size, device=dev)
    C = grid.capacity
    ref = vbg_mod.VoxelBlockGrid(grid.table, grid.tw.clone(), grid.color.clone(),
                                 grid.voxel_size, 16, grid.sdf_trunc)
    k1_par = dict.fromkeys(("weight_mismatch", "max_abs_dtsdf", "max_abs_dcolor", "max_abs_err"),
                           0.0)
    k1_args = None
    for i in range(2):
        E = extr[i]
        keys, touched = vbg_mod.compute_unique_block_coordinates(
            grid, depths[i], intr, E, depth_max=cfg.depth_max,
            frame_block_capacity=cfg.frame_block_capacity)
        table, slot, ok = hm.activate(grid.table, keys)
        rows = torch.where(ok, slot, C).to(torch.int32).contiguous()
        coords = hm.unpack_coords(keys).contiguous()
        d21, rgb24 = k1.prepare_frame(depths[i], colors[i], cfg.depth_max)
        args = (rows, coords, d21, rgb24, intr, E, grid.voxel_size, grid.sdf_trunc, cfg.depth_max)
        k1.integrate_blocks_v2(grid.tw, grid.color, *args)
        k1.integrate_blocks_plain(ref.tw, ref.color, *args)
        torch.cuda.synchronize()
        grid.table = ref.table = table
        live = rows[rows < C].long()
        par = row_parity(vbg_mod, live, grid.tw, grid.color, ref.tw, ref.color)
        log(f"[3] K1 frame {i}: touched {int(touched)} live {live.numel()} {par}")
        check_bit_parity("K1", par)
        check(int(grid.tw[C].abs().sum()) == 0 and int(grid.color[C].abs().sum()) == 0,
              "K1 dump row stays zero")
        for k in par:
            k1_par[k] = max(k1_par[k], par[k])
        k1_args = args
        n_live = live.numel()
    rows, coords, d21, rgb24 = k1_args[:4]
    # each kernel time is the median of N_READINGS readings, printed with
    # their spread (the largest less the smallest)
    k1_ms, k1_spread = median_of(lambda: device_ms(
        lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20))
    # the first cold_ms call of a process read high once: logged, not counted
    k1_cold_first = cold_ms(lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20)
    k1_cold_ms, k1_cold_spread = median_of(lambda: cold_ms(
        lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20))
    k1_plain_ms = device_ms(lambda: k1.integrate_blocks_plain(ref.tw, ref.color, *k1_args), reps=3)
    k1_bytes = n_live * 4 * 4096 * 4 + rows.numel() * 16 + d21.numel() * 4 + rgb24.numel() * 4
    k1_ops = n_live * 4096 * K1_OPS_VOXEL
    k1_bound_ms, k1_bound_by = bound(k1_bytes, k1_ops)
    log(f"[3] K1 {k1_ms:.4f} ms warm (spread {k1_spread:.4f}), {k1_cold_ms:.4f} ms cold (spread "
        f"{k1_cold_spread:.4f}; the process's first cold "
        f"reading {k1_cold_first:.4f} ms), plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound_ms:.4f} ms by {k1_bound_by} ({k1_bytes} B, {k1_ops} flop)")

    # ---- 3b. K4 against its plain version: frame 1's work list again, on
    # identical copies of the grid that K1 built
    planes = k4.prepare_planes(depths[1], colors[1], True)
    k4_args = (rows, coords, planes, intr, extr[1], grid.voxel_size, grid.sdf_trunc,
               cfg.depth_max)
    tw_a, col_a = grid.tw.clone(), grid.color.clone()
    tw_b, col_b = grid.tw.clone(), grid.color.clone()
    k4.integrate_blocks(tw_a, col_a, *k4_args)
    k4.integrate_blocks_plain_v1(tw_b, col_b, *k4_args)
    torch.cuda.synchronize()
    live = rows[rows < C].long()
    k4_par = row_parity(vbg_mod, live, tw_a, col_a, tw_b, col_b)
    k4_par["rows_changed"] = int((tw_a.reshape(C + 1, -1)[live]
                                  != grid.tw.reshape(C + 1, -1)[live]).any(-1).sum())
    log(f"[3] K4 frame 1: live {live.numel()} {k4_par}")
    check_bit_parity("K4", k4_par)
    check(k4_par["rows_changed"] > live.numel() // 2, f"K4 updated the live rows {k4_par}")
    check(int(tw_a[C].abs().sum()) == 0 and int(col_a[C].abs().sum()) == 0,
          "K4 dump row stays zero")
    k4_ms, k4_spread = median_of(lambda: device_ms(
        lambda: k4.integrate_blocks(tw_a, col_a, *k4_args), reps=20))
    k4_cold_ms, k4_cold_spread = median_of(lambda: cold_ms(
        lambda: k4.integrate_blocks(tw_a, col_a, *k4_args), reps=20))
    k4_plain_ms = device_ms(lambda: k4.integrate_blocks_plain_v1(tw_b, col_b, *k4_args), reps=3)
    k4_bytes = n_live * 4 * 4096 * 4 + rows.numel() * 16 + planes.numel() * 2
    k4_ops = n_live * 4096 * K4_OPS_VOXEL
    k4_bound_ms, k4_bound_by = bound(k4_bytes, k4_ops)
    log(f"[3] K4 {k4_ms:.4f} ms warm (spread {k4_spread:.4f}), {k4_cold_ms:.4f} ms cold (spread "
        f"{k4_cold_spread:.4f}), plain {k4_plain_ms:.3f} ms, "
        f"bound {k4_bound_ms:.4f} ms by {k4_bound_by} ({k4_bytes} B, {k4_ops} flop)")
    del tw_a, col_a, tw_b, col_b

    # ---- 4. K2 against its plain version on that grid, from frame 1's pose
    E = extr[1]
    lists = k2.build_tile_lists(grid, intr, E, cfg.depth_min, cfg.depth_max)
    rows_k2 = torch.where(lists.rows >= 0, lists.rows, C).to(torch.int32).contiguous()
    dk = k2.march_tiles(grid, lists, intr, E, cfg.depth_min, cfg.depth_max)
    stats = {}
    dp = k2.march_tiles_plain(grid.tw, rows_k2, lists.coords, lists.nk, lists.n_extra, intr, E,
                              grid.voxel_size, cfg.depth_min, cfg.depth_max, stats=stats)
    torch.cuda.synchronize()
    hk, hp = dk > 0, dp > 0
    both = hk & hp
    dd = (dk - dp).abs()[both]
    k2_par = {
        "hit_agree": float((hk == hp).float().mean()),
        "max_abs_dz": float(dd.max()) if dd.numel() else 0.0,
        "hit_frac": float(hk.float().mean()),
        "overflow": int(lists.overflow),
    }
    log(f"[4] K2 {k2_par}")
    check(torch.isfinite(dk).all().item() and tuple(dk.shape) == (intr.height, intr.width),
          "K2 depth finite, (H, W)")
    check(k2_par["hit_agree"] >= K2_TOL["hit_agree"], f"K2 hit agreement {k2_par}")
    check(k2_par["max_abs_dz"] <= K2_TOL["max_abs_dz"], f"K2 max depth error {k2_par}")
    check(k2_par["hit_frac"] > 0.5, f"K2 hits most of the frame {k2_par}")
    # the work this frame asks for: candidates walked a tile before its break
    steps = stats.pop("tile_steps")
    nk_tot = lists.nk.long() + int(lists.n_extra[0])
    q = torch.quantile(steps.double(), torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                                    device=dev)).tolist()
    walk = {"tiles": steps.numel(), "mean": float(steps.double().mean()), "q50": q[0],
            "q90": q[1], "q99": q[2], "max": int(steps.max()),
            "tiles_walking_all": int((steps == nk_tot).sum()),
            "candidates_mean": float(nk_tot.double().mean()),
            "histogram": torch.bincount(steps).tolist()}
    per_sm, sms = k2.occupancy(6)
    occ = {"ctas_per_sm": per_sm, "sms": sms, "waves": -(-steps.numel() // (per_sm * sms))}
    log(f"[4] K2 work {stats}; candidates walked a tile {walk}; occupancy {occ}")
    k2_ms, k2_spread = median_of(lambda: device_ms(
        lambda: k2.march_tiles(grid, lists, intr, E, cfg.depth_min, cfg.depth_max), reps=20))
    k2_cold_ms, k2_cold_spread = median_of(lambda: cold_ms(
        lambda: k2.march_tiles(grid, lists, intr, E, cfg.depth_min, cfg.depth_max), reps=20))
    # the tile that walks longest, marched alone (every other tile's list
    # emptied): the part of the march that no other tile's work can hide
    slow = int(torch.argmax(steps))
    alone = lists._replace(nk=torch.where(torch.arange(steps.numel(), device=dev) == slow,
                                          lists.nk, 0).to(torch.int32).contiguous())
    alone_ms, _ = median_of(lambda: device_ms(
        lambda: k2.march_tiles(grid, alone, intr, E, cfg.depth_min, cfg.depth_max), reps=20))
    walk.update(slowest_tile=slow, slowest_tile_steps=int(steps[slow]),
                slowest_tile_alone_ms=alone_ms)
    log(f"[4] K2 slowest tile {slow} ({int(steps[slow])} candidates) alone: {alone_ms:.4f} ms")
    k2_plain_ms = device_ms(
        lambda: k2.march_tiles_plain(grid.tw, rows_k2, lists.coords, lists.nk, lists.n_extra,
                                     intr, E, grid.voxel_size, cfg.depth_min, cfg.depth_max),
        reps=3)
    # bytes the function moves: the 32-byte sectors its samples read before
    # the break, the candidate entries walked (row and coordinates, 16 B),
    # nk, n_extra and the depth written; printed beside the count by whole
    # 16 KiB rows and every list entry, so the change of yardstick shows
    out_bytes = intr.height * intr.width * 4
    k2_bytes_rows = (stats["rows_marched"] * 4096 * 4 + lists.rows.numel() * 16
                     + lists.nk.numel() * 4 + out_bytes)
    k2_bytes = (stats["sectors_sampled"] * 32 + stats["pairs_visited"] * 16
                + lists.nk.numel() * 4 + 4 + out_bytes)
    log(f"[4] K2 bytes: {k2_bytes} B by sampled sectors, {k2_bytes_rows} B by whole rows "
        f"(the earlier count)")
    k2_ops = (intr.height * intr.width * K2_OPS_RAY
              + stats["pairs_visited"] * 256 * K2_OPS_CHORD
              + stats["ray_blocks"] * (1 + 6 * K2_OPS_SAMPLE)  # contiguity test, M = 6 samples
              + stats["crossings"] * K2_OPS_CROSS)
    k2_bound_ms, k2_bound_by = bound(k2_bytes, k2_ops)
    log(f"[4] K2 {k2_ms:.4f} ms warm (spread {k2_spread:.4f}), {k2_cold_ms:.4f} ms cold (spread "
        f"{k2_cold_spread:.4f}), plain {k2_plain_ms:.3f} ms, "
        f"bound {k2_bound_ms:.4f} ms by {k2_bound_by} ({k2_bytes} B, {k2_ops} flop, {stats})")
    del grid, ref, lists
    torch.cuda.empty_cache()
    if opts.kernels_only:
        kernels_only_k3_p2(dev)
        return 0

    # ---- 5. the slice: slam_step over 8 frames. bench.py's orbit (span 0.8)
    # moves 6.5 deg and 16 cm a frame and turns towards walls beyond
    # depth_max; the JAX package's own slam_step loses track there from
    # frame 4, and so does the port (tests/test_torch_orbit.py, at 160x120).
    # So the bench orbit is gated on frames 0-3, and the run whose launches
    # are counted takes the first half of that orbit (span 0.4), gated on
    # every frame.
    def run_slice(depths, colors, extr):
        model = dense_slam.create_model(cfg, T_init=lie.invert_se3(extr[0]), device=dev)
        md = torch.zeros_like(depths[0])
        per_frame, rot, trans, res = [], [], [], None
        for i in range(depths.shape[0]):
            before = launch_counts()
            res = dense_slam.slam_step(model, depths[i], colors[i], md, intr)
            model, md = res.model, res.raycast_depth
            per_frame.append({n: c - before[n] for n, c in launch_counts().items()})
            r, t = lie.pose_distance(model.T_frame_to_world, lie.invert_se3(extr[i]))
            rot.append(float(r))
            trans.append(float(t))
        return model, md, res, per_frame, rot, trans

    _, _, _, _, rot08, trans08 = run_slice(depths, colors, extr)
    log(f"[5] bench orbit (span 0.8), gated on frames 0-3: trans errs {trans08}, "
        f"rot errs {rot08}")
    check(max(trans08[:4]) < 0.05 and max(rot08[:4]) < 0.05,
          f"bench orbit pose error vs truth, frames 0-3: {trans08[:4]} {rot08[:4]}")
    depths, colors, extr, _ = synthetic.render_sequence(8, intrinsic=intr, span=0.4, device=dev)
    zero_counts()
    model, md, res, per_frame, rot, trans = run_slice(depths, colors, extr)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[5] launches {launches}, per frame {per_frame}")
    check(all(f["integrate_blocks_v2"] >= 1 and f["march_tiles"] >= 1 for f in per_frame),
          "K1 and K2 ran on every frame")
    check(launches["fuse_blocks"] == 0 and launches["integrate_blocks_v1"] == 0,
          f"the 16^3 default path takes K1 only {launches}")
    check(all(launches[n] == 0 for n in PROBE_KERNELS), f"the SLAM slice runs no probe {launches}")
    truth = depths[-1]
    check(bool(torch.isfinite(md).all()) and tuple(md.shape) == tuple(truth.shape),
          "raycast depth finite, (H, W)")
    valid = (md > 0) & (truth > 0)
    err = (md - truth).abs()[valid]
    slice_res = {
        "max_rot_err": max(rot), "max_trans_err": max(trans),
        "raycast_valid_frac": float(valid.float().mean()),
        "raycast_median_err_m": float(err.median()),
        "raycast_gross_frac": float((err > 0.05).float().mean()),
        "touched_blocks_last": int(res.touched_blocks),
        "active_blocks": int(model.vbg.num_active_blocks()),
        "fitness_last": float(res.fitness),
    }
    log(f"[5] slice {slice_res}; trans errs {[round(t, 5) for t in trans]}")
    check(max(trans) < 0.05 and max(rot) < 0.05, f"pose error vs truth {slice_res}")
    check(slice_res["raycast_valid_frac"] > 0.5, f"raycast covers the frame {slice_res}")
    check(slice_res["raycast_median_err_m"] < 0.01, f"raycast median error {slice_res}")
    check(slice_res["raycast_gross_frac"] < 0.15, f"raycast gross outliers {slice_res}")

    # ---- 5b. the same half-orbit's first 4 frames under O3DTPU_INTEGRATE_V1:
    # the 16^3 integrate takes K4 in place of K1
    prev_v1 = os.environ.get("O3DTPU_INTEGRATE_V1")
    os.environ["O3DTPU_INTEGRATE_V1"] = "1"
    try:
        zero_counts()
        _, _, _, per_frame_v1, rot_v1, trans_v1 = run_slice(depths[:4], colors[:4], extr[:4])
        torch.cuda.synchronize()
        launches_v1 = launch_counts()
    finally:
        if prev_v1 is None:
            os.environ.pop("O3DTPU_INTEGRATE_V1")
        else:
            os.environ["O3DTPU_INTEGRATE_V1"] = prev_v1
    v1_res = {"max_rot_err": max(rot_v1), "max_trans_err": max(trans_v1),
              "launches": launches_v1}
    log(f"[5] O3DTPU_INTEGRATE_V1 slice {v1_res}; per frame {per_frame_v1}")
    check(max(trans_v1) < POSE_TOL and max(rot_v1) < POSE_TOL, f"V1 pose error vs truth {v1_res}")
    check(all(f["integrate_blocks_v1"] >= 1 and f["integrate_blocks_v2"] == 0
              for f in per_frame_v1), f"K4 in place of K1 on every frame {per_frame_v1}")
    check(all(launches_v1[n] == 0 for n in PROBE_KERNELS), f"the V1 run takes no probe {launches_v1}")

    # ---- 6. per-stage times (after the warm-up above), peak memory
    torch.cuda.reset_peak_memory_stats()
    stage = {"track": [], "integrate": [], "raycast": [], "step": []}
    for i in range(1, depths.shape[0]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        dense_slam.track_frame_to_model(model, depths[i], md, intr)
        ev[1].record()
        model, _ = dense_slam.integrate_frame(model, depths[i], colors[i], intr)
        ev[2].record()
        dense_slam.synthesize_model_frame(model, intr)
        ev[3].record()
        ev[3].synchronize()
        stage["track"].append(ev[0].elapsed_time(ev[1]))
        stage["integrate"].append(ev[1].elapsed_time(ev[2]))
        stage["raycast"].append(ev[2].elapsed_time(ev[3]))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        res = dense_slam.slam_step(model, depths[i], colors[i], md, intr)
        e.record()
        e.synchronize()
        model, md = res.model, res.raycast_depth
        stage["step"].append(s.elapsed_time(e))
    medians = {k: statistics.median(v) for k, v in stage.items()}
    log("[6] stage medians ms " + json.dumps({k: round(v, 3) for k, v in medians.items()})
        + f" | max_memory_allocated {torch.cuda.max_memory_allocated()} B | card {smi}")

    if opts.profile:
        def step(i):
            dense_slam.slam_step(model, depths[i], colors[i], md, intr)

        prof = profile_steps(step, 3, opts.profile, medians["step"])
        log("[7] profile " + json.dumps(prof))
    del model, md, res
    torch.cuda.empty_cache()

    # ---- 8-9. the fragment slice: one 40-frame fragment of the synthetic
    # room, about 1.8 deg and 4 cm a frame, at ReconstructionConfig's defaults
    with tempfile.TemporaryDirectory() as out_dir:
        fr = fragment_phases(dev, intr, 40, 1.2, out_dir, zero_counts, launch_counts,
                             profile_dir=opts.profile)
    k3_out = fr["k3"]
    torch.cuda.empty_cache()

    # ---- 10. the probes' path: P1-P3 at the scripts' own sizes
    probe_kernels = micro_phase(dev, zero_counts, launch_counts)
    torch.cuda.empty_cache()

    # ---- 11. the raycast surface: maps, normals in tracking, the trace
    depths, colors, extr, _ = synthetic.render_sequence(8, intrinsic=intr, span=0.8, device=dev)
    surface = surface_phase(dev, intr, cfg, depths, colors, extr, fr, zero_counts, launch_counts,
                            smi)
    del depths, colors, extr
    torch.cuda.empty_cache()

    # ---- 12. the registration path: ICP, FPFH, RANSAC and FGR
    registration = registration_phase(dev, smi, zero_counts, launch_counts, intr)

    kernels = [
        {
            "name": "integrate_blocks_v2", "route": "cuda",
            "source": "open3d_tpu_torch/csrc/integrate2.cu",
            "replaces": "open3d_tpu/ops/pallas/integrate2.py:128",
            "launches": launches["integrate_blocks_v2"],
            "max_abs_err": k1_par["max_abs_err"],
            "ms": k1_ms, "kernel_ms": k1_ms, "cold_ms": k1_cold_ms, "plain_ms": k1_plain_ms,
            "spread_ms": k1_spread, "cold_spread_ms": k1_cold_spread, "times": MEDIAN_TIMES,
            "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
            "parity": k1_par, "tolerance": BIT_TOL,
        },
        {
            "name": "march_tiles", "route": "cuda",
            "source": "open3d_tpu_torch/csrc/raycast.cu",
            "replaces": "open3d_tpu/ops/pallas/raycast.py:195",
            "launches": launches["march_tiles"],
            "max_abs_err": k2_par["max_abs_dz"],
            "ms": k2_ms, "kernel_ms": k2_ms, "cold_ms": k2_cold_ms, "plain_ms": k2_plain_ms,
            "spread_ms": k2_spread, "cold_spread_ms": k2_cold_spread, "times": MEDIAN_TIMES,
            "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
            "parity": k2_par, "tolerance": K2_TOL, "work": stats, "walk": walk,
            "occupancy": occ,
        },
        {
            "name": "fuse_blocks", "route": "cuda",
            "source": "open3d_tpu_torch/csrc/tsdf.cu",
            "replaces": "open3d_tpu/ops/pallas/tsdf.py:56",
            "launches": fr["launches"]["fuse_blocks"],
            "max_abs_err": k3_out["max_abs_err"],
            "ms": k3_out["ms"], "kernel_ms": k3_out["ms"], "cold_ms": k3_out["cold_ms"],
            "spread_ms": k3_out["spread_ms"], "cold_spread_ms": k3_out["cold_spread_ms"],
            "times": MEDIAN_TIMES,
            "floor_ms": k3_out["floor_ms"], "plain_ms": k3_out["plain_ms"],
            "bound_ms": k3_out["bound_ms"], "bound_by": k3_out["bound_by"], "library_ms": None,
            "parity": {k: k3_out[k] for k in ("colour", "no_colour")}, "tolerance": BIT_TOL,
            "occupancy": k3_out["occupancy"],
        },
        {
            "name": "integrate_blocks_v1", "route": "cuda",
            "source": "open3d_tpu_torch/csrc/integrate2.cu",
            "replaces": "open3d_tpu/ops/pallas/integrate.py:61",
            "launches": launches_v1["integrate_blocks_v1"],
            "max_abs_err": k4_par["max_abs_err"],
            "ms": k4_ms, "kernel_ms": k4_ms, "cold_ms": k4_cold_ms, "plain_ms": k4_plain_ms,
            "spread_ms": k4_spread, "cold_spread_ms": k4_cold_spread, "times": MEDIAN_TIMES,
            "bound_ms": k4_bound_ms, "bound_by": k4_bound_by, "library_ms": None,
            "parity": k4_par, "tolerance": BIT_TOL,
        },
        *probe_kernels,
    ]
    log("[summary] " + json.dumps({"build_s": build_s, "stage_median_ms": medians,
                                   "slice": slice_res, "v1_slice": v1_res,
                                   "fragment": fr["fragment"],
                                   "fragment_stage_median_ms": fr["times"],
                                   "make_fragments_inside_ms": fr["inside_ms"],
                                   "fragment_peak_bytes": fr["peak_bytes"], "surface": surface,
                                   "registration": registration, "card": smi}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
