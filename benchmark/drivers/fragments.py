"""Stage 1 of the offline reconstruction system: fragments back to back
through `pipelines/reconstruction.py:make_fragments`.

Traffic files with `"driver": "fragments"`: the arc of the room's orbit
(as the SLAM mixes, `drivers/slam.py:make_frames`) in segments of the
configuration's `fragment_size` frames, held on the host as numpy arrays
that a sequence object of the harness serves (`read_frame`, `__len__`,
`intrinsic`), so each fragment pays its copies to the card as a run from
disk would after decoding. The seed sets which segment comes first; the
segments then follow in turn. Each fragment writes into a fresh directory
under TMPDIR (`make_fragments` skips a fragment whose PLY exists), removed
once the run has compared it.

The window: fragments run back to back from its start. The first always
starts; after it, no fragment starts that the mean of those completed
says would end after the window. `fragment_s` is the completed fragments'
total wall time over their count. A traced run builds two fragments: the
first under the profiler's device trace and the layers' event pairs, the
second under a trace of the host's operators as well.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import trace as tr
from benchmark.drivers import slam as slam_driver
from benchmark.reference import fragment as ref_frag
from benchmark.reference import check as ref_check


class Sequence:
    """The frames `ids` of the host arrays, as `make_fragments` reads a
    sequence."""

    def __init__(self, depth: np.ndarray, color: np.ndarray, ids, intrinsic):
        self.depth, self.color, self.ids, self.intrinsic = depth, color, list(ids), intrinsic

    def __len__(self) -> int:
        return len(self.ids)

    def read_frame(self, i: int):
        j = self.ids[i]
        return self.depth[j], self.color[j]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_up(rc, cfg, seq, dev, scratch: str) -> None:
    """One HYBRID pair with its information matrix, one small pose-graph
    solve, one frame into a fragment grid and its cloud written: every
    shape a fragment uses, none of a whole fragment's work."""
    from open3d_tpu_torch import io as pcio
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod
    from open3d_tpu_torch.geometry.rgbd import RGBDImage
    from open3d_tpu_torch.pipelines import odometry as odo
    from open3d_tpu_torch.pipelines import pose_graph as pg

    def rgbd(i):
        d, c = (torch.from_numpy(np.array(x, dtype=np.float32)).to(dev) for x in seq.read_frame(i))
        return RGBDImage(color=c, depth=torch.where((d > 0) & (d < cfg.depth_max), d, 0.0))

    a, b = rgbd(0), rgbd(1)
    res = odo.rgbd_odometry_multi_scale(a, b, seq.intrinsic, method=cfg.odometry_method)
    odo.compute_odometry_information_matrix(a.depth, b.depth, seq.intrinsic, res.transformation)
    T = res.transformation.cpu().numpy()
    graph = pg.PoseGraph.create(np.stack([np.eye(4), np.linalg.inv(T), np.eye(4)]),
                                np.asarray([(0, 1), (1, 2), (0, 2)], np.int32),
                                np.stack([np.linalg.inv(T), T, np.eye(4)]),
                                uncertain=np.asarray([False, False, True]), device=dev)
    pg.global_optimization(graph, pg.GlobalOptimizationOption(
        max_correspondence_distance=cfg.voxel_size * 1.4,
        preference_loop_closure=cfg.preference_loop_closure_odometry))
    grid = rc.create_fragment_grid(cfg, dev)
    grid = rc.integrate_fragment_frame(grid, a, np.eye(4, dtype=np.float32), seq.intrinsic, cfg)
    pcd = vbg_mod.extract_point_cloud(grid, point_capacity=cfg.fragment_point_capacity,
                                      weight_threshold=2.0)
    pcio.write_point_cloud(os.path.join(scratch, "warm.ply"), pcd)
    _sync(dev)


def compare(run: dict, ref: dict) -> dict:
    """The numbers compared between a fragment's outputs and the
    reference's (see `limits/fragment40.hybrid.json`)."""
    kept_ref = {e: (ref["X"][k], ref["info"][k]) for k, e in enumerate(ref["edges"])
                if ref["kept"][k]}
    common = set(kept_ref) & set(run["edges"])
    gap_m = gap_rad = info_off = 0.0
    for e in common:
        m, r = ref_check.pose_gap(run["edges"][e][0], kept_ref[e][0])
        gap_m, gap_rad = max(gap_m, m), max(gap_rad, r)
        ri = kept_ref[e][1]
        info_off = max(info_off, float(np.linalg.norm(run["edges"][e][1] - ri)
                                       / max(np.linalg.norm(ri), 1e-12)))
    pm = pr = 0.0
    for a, b in zip(run["poses"], ref["poses"]):
        m, r = ref_check.pose_gap(a, b)
        pm, pr = max(pm, m), max(pr, r)
    p, q = run["positions"], ref["positions"]
    n = min(len(p), len(q))
    off = ((np.abs(p[:n] - q[:n]).max(-1, initial=0) > 1e-6)
           | (np.abs(run["normals"][:n] - ref["normals"][:n]).max(-1, initial=0) > 1e-5)
           | (run["colors"][:n] != ref["colors"][:n]).any(-1))
    return {"edges_off": len(set(kept_ref) ^ set(run["edges"])),
            "edge_gap_m": gap_m, "edge_gap_rad": gap_rad, "info_off": info_off,
            "pose_gap_m": pm, "pose_gap_rad": pr,
            "cloud_off": (abs(len(p) - len(q)) + int(off.sum())) / max(len(q), 1)}


def read_run(frag_dir: str) -> dict:
    """A fragment's outputs as `make_fragments` wrote them."""
    with open(os.path.join(frag_dir, "fragment_000.json")) as f:
        poses, edges = ref_frag.read_graph(json.load(f))
    ply = ref_frag.read_ply(os.path.join(frag_dir, "fragment_000.ply"))
    pos = np.stack([ply["x"], ply["y"], ply["z"]], -1)
    nrm = np.stack([ply["nx"], ply["ny"], ply["nz"]], -1)
    rgb = np.stack([ply["red"], ply["green"], ply["blue"]], -1)
    return {"poses": poses, "edges": edges, "positions": pos, "normals": nrm, "colors": rgb}


def reference_frames(depth, color, ids, depth_max: float, dev):
    """The segment's frames on the card, depth clipped as the program reads
    it."""
    out = []
    for j in ids:
        d = torch.from_numpy(depth[j]).to(dev)
        out.append((torch.where((d > 0) & (d < depth_max), d, 0.0),
                    torch.from_numpy(color[j]).to(dev)))
    return out


def run(cfg, traffic, limits, seed, seconds, trace, dev, t0):
    from torch.profiler import ProfilerActivity, profile

    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.pipelines import odometry as odo
    from open3d_tpu_torch.pipelines import pose_graph as pg
    from open3d_tpu_torch.pipelines import reconstruction as rc

    phases = {"import_s": time.perf_counter() - t0}
    t = time.perf_counter()
    depth_t, color_t, _ = slam_driver.make_frames(cfg, traffic, dev)
    depth, color = depth_t.numpy(), color_t.numpy()
    phases["render_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    c = cfg["camera"]
    intr = PinholeCameraIntrinsic(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])
    rcfg = rc.ReconstructionConfig(**cfg["reconstruction"])
    size = rcfg.fragment_size
    n_seg = depth.shape[0] // size
    first = int(np.random.default_rng([seed, 5]).integers(n_seg))
    segment = [list(range(s * size, (s + 1) * size)) for s in range(n_seg)]
    root = tempfile.mkdtemp(prefix="benchmark-fragments-", dir=os.environ.get("TMPDIR"))
    try:
        t = time.perf_counter()
        warm_up(rc, rcfg, Sequence(depth, color, segment[first], intr), dev, root)
        phases["warmup_s"] = time.perf_counter() - t

        timer = tr.LayerTimer(dev)
        targets = [(odo, "rgbd_odometry_multi_scale", "odometry"),
                   (odo, "compute_odometry_information_matrix", "information"),
                   (pg, "global_optimization", "pose_graph")]
        cuda = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
        acts = [cuda or [ProfilerActivity.CPU], [ProfilerActivity.CPU] + cuda]
        durations, dirs, segs, traced = [], [], [], []
        t_start = time.perf_counter()
        setup_s = t_start - t0
        k = 0
        while True:
            if trace and k == 2:
                break
            if not trace and k and (time.perf_counter() - t_start
                                    + sum(durations) / len(durations) > seconds):
                break
            s = (first + k) % n_seg
            out_dir = os.path.join(root, str(k))
            rcfg.path_output = out_dir
            seq = Sequence(depth, color, segment[s], intr)
            if trace:
                prof = profile(activities=acts[k])
                prof.__enter__()
                patch = timer.patched(targets) if k == 0 else None
                if patch:
                    patch.__enter__()
                lo = time.time_ns()
            t = time.perf_counter()
            rc.make_fragments(seq, rcfg, device=dev)
            _sync(dev)
            durations.append(time.perf_counter() - t)
            if trace:
                hi = time.time_ns()
                if patch:
                    patch.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                traced.append((prof, lo, hi, durations[-1]))
            dirs.append(os.path.join(out_dir, "fragments"))
            segs.append(s)
            k += 1
        out = {"setup_s": setup_s, "fragment_s": sum(durations) / len(durations),
               "attempted": len(durations), "failed": 0,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else 0}

        ctx = {}
        if trace:
            times = timer.times()
            n_pairs = len(times.get("odometry", []))
            ctx["layers"] = times
            ctx["pairs"] = n_pairs
            if dev.type == "cuda":
                prof, lo, hi, window_s = traced[0]
                dev_ev = tr.device_events(prof)
                ctx["busy_s"] = tr.busy_ns(dev_ev, 0, tr.END) / 1e9
                ctx["window_s"] = window_s
                ctx["kernels"] = {"fuse_kernel": tr.kernel_ms(dev_ev, 0, tr.END, "fuse_kernel")}
                device_ops = tr.top_device_ops(dev_ev, 0, tr.END)
                prof, lo, hi, _ = traced[1]
                ctx["breakdown"] = {"device_ops": device_ops, "idle_gaps": tr.idle_gaps(
                    tr.device_events(prof), lo, hi, tr.host_events(prof))}
            del traced

        # the sampled fragment: drawn from the seed, the device-traced one
        # in a traced run (its fuse work feeds the K3 count)
        pick = 0 if trace else int(np.random.default_rng([seed, 9]).integers(len(dirs)))
        t = time.perf_counter()
        got = read_run(dirs[pick])
        frames = reference_frames(depth, color, segment[segs[pick]], rcfg.depth_max, dev)
        ref_intr = slam_driver.intrinsic_of(cfg)
        work = []
        ref = ref_frag.fragment(frames, ref_intr, cfg["reconstruction"], poses=got["poses"],
                                work=work)
        numbers = compare(got, ref)
        phases["check_s"] = time.perf_counter() - t
        ctx["k3_live"] = work
        ctx["k3_entries"] = 4096
        info = dict(phases, fragments=len(durations), compared=pick,
                    points=int(len(got["positions"])), edges=len(got["edges"]))
        return out, ctx, numbers, info
    finally:
        shutil.rmtree(root, ignore_errors=True)
