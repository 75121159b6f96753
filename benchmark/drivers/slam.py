"""Live dense SLAM on a 640 x 480 RGB-D stream, one client in a closed loop:
the step of frame k + 1 is handed in when frame k's outputs are on the host.

Traffic files with `"driver": "slam"` choose the mix by `mode`:
- `track`: each frame goes to `models/dense_slam.py:slam_step` (track,
  integrate, raycast);
- `known_pose`: each frame comes with its pose, as from a given trajectory
  or a VIO tracker, and goes to `dense_slam.integrate_frame`, then
  `dense_slam.synthesize_model_frame` (the raycast a viewer shows).

The frames are an arc of the room's orbit (`frames.py`), rendered in set-up
and held on the host in pinned memory, as a sensor hands them over; each
step copies its frame to the card. The stream plays the arc forward, then
back, and the seed sets where in that cycle the session starts: every
seed hands in the same frames in another order, so that the seed changes
the inputs and not the amount of work. A frame is complete when its pose and
raycast depth are on the host after one synchronisation. The session
starts in set-up: its first `warmup_steps` steps warm every shape the
window uses, and the window goes on from there with the same model.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import frames as fr
from benchmark import trace as tr
from benchmark.reference import check as ref_check
from benchmark.reference.grid import Intr


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def intrinsic_of(cfg: dict) -> Intr:
    c = cfg["camera"]
    return Intr(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])


def stream_ids(seed: int, n_frames: int):
    """The frame of each step: the arc forward, then back, from a point of
    that cycle drawn from the seed."""
    off = int(np.random.default_rng([seed, 3]).integers(max(2 * n_frames - 2, 1)))
    return lambda k: fr.ping_pong(k + off, n_frames)


def make_frames(cfg: dict, traffic: dict, dev):
    """(depth (F, H, W), colour (F, H, W, 3), poses (F, 4, 4) frame -> world
    float32 numpy) of the traffic's arc, on the host."""
    intr = intrinsic_of(cfg)
    s = cfg["slam"]
    extr = fr.orbit(traffic["frames"], np.deg2rad(traffic["deg_per_frame"]), traffic["start_rad"],
                    traffic["height_phase_rad"], traffic["radius"], traffic["height"], dev)
    depth, color = fr.render(extr, intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy,
                             s["depth_min"], s["depth_max"])
    poses = np.linalg.inv(extr.double().cpu().numpy()).astype(np.float32)
    pin = dev.type == "cuda"
    depth = depth.cpu().pin_memory() if pin else depth.cpu()
    color = color.cpu().pin_memory() if pin else color.cpu()
    return depth, color, poses


def window_numbers(t_start: float, t_end: float, latencies) -> dict:
    """frame_ms: the window's whole wall time (its start to the last frame's
    completion) over the frames completed in it; frame_p95_ms: the 95th
    percentile of every frame's latency, from its hand-over to its outputs
    on the host."""
    return {"frame_ms": (t_end - t_start) / len(latencies) * 1e3,
            "frame_p95_ms": float(np.percentile(np.asarray(latencies), 95)) * 1e3}


class Samples:
    """The window's steps whose answers are compared: every `stride`-th
    step from the window's first, offset by a draw from the seed."""

    def __init__(self, seed: int, first: int, stride: int):
        self.first, self.stride = first, stride
        self.off = int(np.random.default_rng([seed, 7]).integers(stride))

    def __contains__(self, k: int) -> bool:
        return k >= self.first and (k - self.first - self.off) % self.stride == 0


class Session:
    """One client's stream into the program, step by step."""

    def __init__(self, cfg, traffic, depth, color, poses, frame_of, dev):
        from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
        from open3d_tpu_torch.models import dense_slam

        self.ds = dense_slam
        self.dev = dev
        self.tracked = traffic["mode"] == "track"
        self.depth, self.color, self.poses = depth, color, poses
        self.frame_of = frame_of
        c = cfg["camera"]
        self.intr = PinholeCameraIntrinsic(c["width"], c["height"], c["fx"], c["fy"], c["cx"],
                                           c["cy"])
        self.fitness_threshold = cfg["fitness_threshold"]
        slam_cfg = dense_slam.SLAMConfig(**cfg["slam"])
        self.model = dense_slam.create_model(slam_cfg, T_init=torch.from_numpy(poses[frame_of(0)]),
                                             device=dev)
        self.model_depth = torch.zeros((c["height"], c["width"]), dtype=torch.float32, device=dev)
        pin = dev.type == "cuda"
        self.view = torch.empty((c["height"], c["width"]), dtype=torch.float32, pin_memory=pin)
        self.pose_h = torch.empty((4, 4), dtype=torch.float32, pin_memory=pin)
        self.ok_h = torch.empty((), dtype=torch.bool, pin_memory=pin)
        self.poses_h = torch.from_numpy(poses).pin_memory() if pin else torch.from_numpy(poses)
        self.ids, self.out_poses, self.ok, self.raycasts = [], [], [], {}

    def step(self, k: int, keep: bool) -> None:
        j = self.frame_of(k)
        dev = self.dev
        d = self.depth[j].to(dev, non_blocking=True)
        c = self.color[j].to(dev, non_blocking=True)
        ds = self.ds
        if self.tracked:
            res = ds.slam_step(self.model, d, c, self.model_depth, self.intr,
                               fitness_threshold=self.fitness_threshold)
            self.model, self.model_depth = res.model, res.raycast_depth
            self.ok_h.copy_(res.tracking_ok, non_blocking=True)
        else:
            T = self.poses_h[j].to(dev, non_blocking=True)
            model = dataclasses.replace(self.model, T_frame_to_world=T)
            model, _ = ds.integrate_frame(model, d, c, self.intr)
            ray = ds.synthesize_model_frame(model, self.intr)
            self.model = dataclasses.replace(model, frame_id=model.frame_id + 1)
            self.model_depth = ray.depth
        self.pose_h.copy_(self.model.T_frame_to_world, non_blocking=True)
        self.view.copy_(self.model_depth, non_blocking=True)
        _sync(dev)
        self.ids.append(j)
        self.out_poses.append(self.pose_h.numpy().copy())
        self.ok.append(bool(self.ok_h) if self.tracked else True)
        if keep:
            self.raycasts[k] = self.view.numpy().copy()

    def layer_targets(self):
        ds = self.ds
        return [(ds, "track_frame_to_model", "track"), (ds, "integrate_frame", "integrate"),
                (ds, "synthesize_model_frame", "raycast")]


def run(cfg, traffic, limits, seed, seconds, trace, dev, t0):
    """Set up, run the window, compare. Returns (end-to-end numbers, the
    traced run's context for the per-layer readers, the numbers compared,
    information). With `trace`, the window's first `trace_steps` steps run
    under the profiler's device trace and the layers' event pairs, and the
    `host_trace_steps` after them under a trace of the host's operators as
    well (it slows the host, so the device's idle share is read from the
    first part alone)."""
    from torch.profiler import ProfilerActivity, profile

    phases = {"import_s": time.perf_counter() - t0}
    t = time.perf_counter()
    depth, color, poses = make_frames(cfg, traffic, dev)
    phases["render_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    sess = Session(cfg, traffic, depth, color, poses, stream_ids(seed, depth.shape[0]), dev)
    warm = traffic["warmup_steps"]
    for k in range(warm):
        sess.step(k, keep=True)
    _sync(dev)
    phases["model_and_warmup_s"] = time.perf_counter() - t

    samples = Samples(seed, warm, traffic["sample_stride"])
    n_dev = traffic["trace_steps"] if trace else 0
    n_host = traffic["host_trace_steps"] if trace else 0
    cuda = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    # (first step, last step + 1, profiler activities) of each traced part
    parts = [(warm, warm + n_dev, cuda or [ProfilerActivity.CPU]),
             (warm + n_dev, warm + n_dev + n_host, [ProfilerActivity.CPU] + cuda)] if trace else []
    timer = tr.LayerTimer(dev)
    traced = {}
    lat = []
    t_start = time.perf_counter()
    setup_s = t_start - t0
    k = warm
    while True:
        for a, b, acts in parts:
            if k == a:
                prof = profile(activities=acts)
                prof.__enter__()
                patch = timer.patched(sess.layer_targets()) if a == warm else None
                if patch:
                    patch.__enter__()
                lo, t_part = time.time_ns(), time.perf_counter()
        t = time.perf_counter()
        sess.step(k, keep=k in samples or k + 1 in samples)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        k += 1
        for a, b, acts in parts:
            if k == b:
                hi, window_s = time.time_ns(), time.perf_counter() - t_part
                if patch:
                    patch.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                traced[a] = (prof, lo, hi, window_s)
        if t_end - t_start >= seconds and k >= warm + n_dev + n_host:
            break
    n = k - warm
    out = {
        "setup_s": setup_s,
        **window_numbers(t_start, t_end, lat),
        "attempted": n,
        "failed": sum(1 for ok in sess.ok[warm:] if not ok),
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
    }
    dev_steps = list(range(warm, warm + n_dev))
    k2_steps = dev_steps[::traffic["k2_count_every"]]
    run_out = {"ids": sess.ids, "poses": sess.out_poses, "raycasts": sess.raycasts,
               "grid": (sess.model.vbg.table, sess.model.vbg.tw_flat, sess.model.vbg.color_flat)}
    del sess.model_depth
    ctx = {}
    if trace:
        ctx["layers"] = timer.times()
        ctx["steps_traced"] = n_dev
        prof, lo, hi, window_s = traced[warm]
        if dev.type == "cuda":
            dev_ev = tr.device_events(prof)
            ctx["busy_s"] = tr.busy_ns(dev_ev, 0, tr.END) / 1e9
            ctx["window_s"] = window_s
            ctx["kernels"] = {name: tr.kernel_ms(dev_ev, 0, tr.END, name)
                              for name in ("integrate_kernel", "march_kernel")}
            device_ops = tr.top_device_ops(dev_ev, 0, tr.END)
        prof, lo, hi, _ = traced[warm + n_dev]
        host_ev = tr.host_events(prof)
        ctx["host_reads"] = tr.count_host(host_ev, 0, tr.END, tr.HOST_READ_OP)
        ctx["host_steps"] = n_host
        if dev.type == "cuda":
            ctx["breakdown"] = {"device_ops": device_ops,
                                "idle_gaps": tr.idle_gaps(tr.device_events(prof), lo, hi, host_ev)}
        del prof, traced
    ctx["camera"] = cfg["camera"]

    def frame_on_device(j):
        return depth[j].to(dev), color[j].to(dev)

    t = time.perf_counter()
    numbers, work, info = ref_check.replay(
        frame_on_device, intrinsic_of(cfg), cfg, run_out, samples, sess.tracked, dev,
        limits["raycast_tol_m"], trace_steps=dev_steps, k2_steps=k2_steps)
    phases["check_s"] = time.perf_counter() - t
    ctx["k1_live"] = [work["k1_live"][k] for k in dev_steps]
    ctx["k1_entries"] = work["k1_entries"]
    ctx["k2_stats"] = {k - warm: work["k2"][k] for k in k2_steps}
    truth = [ref_check.pose_gap(p, poses[j]) for p, j in zip(sess.out_poses, sess.ids)]
    if "kernels" in ctx:
        info["launches"] = {k: len(v) for k, v in ctx["kernels"].items()}
    info.update(phases, steps=len(sess.ids), drift_m=max(m for m, _ in truth),
                drift_rad=max(r for _, r in truth))
    return out, ctx, numbers, info
