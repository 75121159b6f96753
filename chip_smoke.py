#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card: the dense-SLAM
frame step, stage 1 of the offline reconstruction system (make_fragments),
and the primitive, gather and march probes that scripts/ ran on the TPU.

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
     its occupancy at each size).
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
PROBE_KERNELS = ("micro_gather", "micro_raymarch", "micro_primitives")


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
            "inside_ms": inside_ms, "k3": k3_out, "profile": prof}


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
    log(f"[9] K3 {out['ms']:.4f} ms warm, {out['cold_ms']:.4f} ms cold, launch floor "
        f"{out['floor_ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"by {out['bound_by']} ({out['bytes']} B, {out['ops']} flop); {out['occupancy']}")
    return out


def k3_times(k3, tw, col, rows, tsdf_new, wn, cnew, C: int) -> dict:
    """K3 warm and cold on this work list, and its launch floor: the same
    list with every entry the dump row C, warm (what this design takes for
    a list with nothing to fuse)."""
    import torch

    from open3d_tpu_torch.ops.kernels._timing import cold_ms, device_ms

    dump = torch.full_like(rows, C)
    return {"ms": device_ms(lambda: k3.fuse_blocks(tw, col, rows, tsdf_new, wn, cnew), reps=20),
            "cold_ms": cold_ms(lambda: k3.fuse_blocks(tw, col, rows, tsdf_new, wn, cnew), reps=20),
            "floor_ms": device_ms(lambda: k3.fuse_blocks(tw, col, dump, tsdf_new, wn, cnew),
                                  reps=20)}


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

    from open3d_tpu_torch.ops.kernels._timing import device_ms

    if out is None:
        out = p2.gather(table, idx)
    ref = p2.gather_plain(table, idx)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"P2 R={R} chunk={s_chunk} bit parity (max |d| {err})")
    n = idx.numel()
    b_ms, b_by = bound(p2.bytes_moved(R, n), 0)
    idx64 = idx.long()  # torch.take takes int64 indices only
    return {"R": R, "s_chunk": s_chunk, "indices": n, "max_abs_err": err,
            "ms": device_ms(lambda: p2.gather(table, idx), reps=20),
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
    from open3d_tpu_torch.ops.kernels._timing import device_ms

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
        "plain_ms": total(configs, "plain_ms"), "bound_ms": total(configs, "bound_ms"),
        "bound_by": "bytes", "library_ms": total(configs, "library_ms"),
        "library": "torch.take on int64 indices", "times": "sums over the three configurations",
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
    b_ms, b_by = bound(p3.bytes_moved(n_tiles), p3.ops(n_tiles))
    p3_entry = {
        "name": "micro_raymarch", "route": "cuda", "source": "open3d_tpu_torch/csrc/micro_raymarch.cu",
        "replaces": "scripts/micro_raymarch_kernel.py:87", "launches": launches["micro_raymarch"],
        "max_abs_err": par["max_abs_dz"],
        "ms": device_ms(lambda: p3.march(rows, tw), reps=20),
        "plain_ms": device_ms(lambda: p3.march_plain(rows, tw), reps=2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
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
        "times": f"one instance of each of the 17 probes, summed; each the median of {p1.N_SLOPES} slopes",
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
    from open3d_tpu_torch.ops.kernels._timing import cold_ms, device_ms

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
    k1_ms = device_ms(lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20)
    # the first cold_ms call of a process reads high: logged, not counted
    k1_cold_first = cold_ms(lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20)
    k1_cold_ms = cold_ms(lambda: k1.integrate_blocks_v2(grid.tw, grid.color, *k1_args), reps=20)
    k1_plain_ms = device_ms(lambda: k1.integrate_blocks_plain(ref.tw, ref.color, *k1_args), reps=3)
    k1_bytes = n_live * 4 * 4096 * 4 + rows.numel() * 16 + d21.numel() * 4 + rgb24.numel() * 4
    k1_ops = n_live * 4096 * K1_OPS_VOXEL
    k1_bound_ms, k1_bound_by = bound(k1_bytes, k1_ops)
    log(f"[3] K1 {k1_ms:.4f} ms warm, {k1_cold_ms:.4f} ms cold (the process's first cold "
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
    k4_ms = device_ms(lambda: k4.integrate_blocks(tw_a, col_a, *k4_args), reps=20)
    k4_cold_ms = cold_ms(lambda: k4.integrate_blocks(tw_a, col_a, *k4_args), reps=20)
    k4_plain_ms = device_ms(lambda: k4.integrate_blocks_plain_v1(tw_b, col_b, *k4_args), reps=3)
    k4_bytes = n_live * 4 * 4096 * 4 + rows.numel() * 16 + planes.numel() * 2
    k4_ops = n_live * 4096 * K4_OPS_VOXEL
    k4_bound_ms, k4_bound_by = bound(k4_bytes, k4_ops)
    log(f"[3] K4 {k4_ms:.4f} ms warm, {k4_cold_ms:.4f} ms cold, plain {k4_plain_ms:.3f} ms, "
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
    k2_ms = device_ms(lambda: k2.march_tiles(grid, lists, intr, E, cfg.depth_min, cfg.depth_max),
                    reps=20)
    k2_cold_ms = cold_ms(
        lambda: k2.march_tiles(grid, lists, intr, E, cfg.depth_min, cfg.depth_max), reps=20)
    # the tile that walks longest, marched alone (every other tile's list
    # emptied): the part of the march that no other tile's work can hide
    slow = int(torch.argmax(steps))
    alone = lists._replace(nk=torch.where(torch.arange(steps.numel(), device=dev) == slow,
                                          lists.nk, 0).to(torch.int32).contiguous())
    alone_ms = device_ms(
        lambda: k2.march_tiles(grid, alone, intr, E, cfg.depth_min, cfg.depth_max), reps=20)
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
    log(f"[4] K2 {k2_ms:.4f} ms warm, {k2_cold_ms:.4f} ms cold, plain {k2_plain_ms:.3f} ms, "
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

    kernels = [
        {
            "name": "integrate_blocks_v2", "route": "cuda",
            "source": "open3d_tpu_torch/csrc/integrate2.cu",
            "replaces": "open3d_tpu/ops/pallas/integrate2.py:128",
            "launches": launches["integrate_blocks_v2"],
            "max_abs_err": k1_par["max_abs_err"],
            "ms": k1_ms, "kernel_ms": k1_ms, "cold_ms": k1_cold_ms, "plain_ms": k1_plain_ms,
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
                                   "fragment_peak_bytes": fr["peak_bytes"], "card": smi}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
