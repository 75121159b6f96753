"""The comparison that decides a SLAM cell's `correct`.

A run hands in what its timed path produced: the pose each step integrated
at (the program's tracked pose, or the pose the stream gave), the raycast
depth of the sampled steps, and the grid after its last step. The
reference follows the run step by step: it integrates every step's frame
at the run's pose into a grid of its own, from the first step of set-up on;
at each sampled step it raycasts its grid from the run's pose; and in the
tracked mix it tracks each sampled step's input frame against the run's
raycast of the step before, from the run's pose before it. So the
reference takes the run's poses and raycasts as the state it starts each
step from, and nothing the run made for its own use (no table, slot, work
list or packed frame).

The numbers compared (each with its limit in `limits/<cell>.json`):

- `pose_gap_m`, `pose_gap_rad`: over the sampled steps, the largest
  distance between the run's pose and the reference's tracked pose;
- `raycast_off`: the share of the sampled raycasts' pixels where the run's
  depth and the reference's differ by more than `raycast_tol_m`, or one
  hits and the other misses;
- `grid_off`: the share of the words of the grid's live blocks (key,
  tsdf-weight and colour words) that differ from the reference's grid;
- `blocks_dropped`: touched blocks that the grid could not take (over the
  frame's block capacity, or no free slot). The configuration guarantees
  that every frame handed in is integrated whole, so its limit is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import grid as rg
from benchmark.reference import track as rt


def pose_gap(Ta: np.ndarray, Tb: np.ndarray):
    """(metres, radians) between two rigid transforms, in float64."""
    Ta = Ta.astype(np.float64)
    Tb = Tb.astype(np.float64)
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which keeps its digits at small
    # angles where the trace's arccos loses them
    s = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * math.sqrt(2.0))
    ang = 2.0 * math.asin(min(1.0, s))
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])), ang


def replay(frames, intr: rg.Intr, cfg: dict, run: dict, samples, tracked: bool, device,
           raycast_tol_m: float, trace_steps=(), k2_steps=(), low: bool = False):
    """Follow the run and compare. `frames(j)` gives frame j's (depth,
    colour) on `device`; `run` holds "ids" (the frame of each step), "poses"
    ((4, 4) frame -> world, each step), "raycasts" ({step: (H, W) depth})
    and "grid" ((table, tw, colour) after the last step). Returns (numbers,
    work): work["k1_live"][step] is the live blocks of each step in
    `trace_steps`, work["k2"][step] the march's walk at each step in
    `k2_steps`."""
    s = cfg["slam"]
    vs = s["voxel_size"]
    dmin, dmax = s["depth_min"], s["depth_max"]
    g = rg.create(s["block_count"], vs, s["trunc_voxel_multiplier"] * vs, device)
    poses = [torch.as_tensor(p, dtype=torch.float32, device=device) for p in run["poses"]]
    dropped = 0
    gap_m = gap_rad = 0.0
    px_off = px_all = 0
    work = {"k1_live": {}, "k2": {}, "k1_entries": s["frame_block_capacity"]}
    trace_steps, k2_steps = set(trace_steps), set(k2_steps)
    for k, j in enumerate(run["ids"]):
        depth, color = frames(j)
        E = rg.invert_se3(poses[k])
        keys, count = rg.touch(g, depth, intr, E, dmax, s["frame_block_capacity"], low=low)
        dropped += max(count - s["frame_block_capacity"], 0)
        g, rows, drop = rg.integrate(g, keys, depth, color, intr, E, dmax,
                                     cfg["weight_max"], low=low)
        dropped += drop
        if k in trace_steps:
            work["k1_live"][k] = int(rows.numel())
        if k in samples or k in k2_steps:
            stats = {} if k in k2_steps else None
            ref = rg.raycast(g, intr, E, dmin, dmax, low=low, stats=stats)
            if stats is not None:
                work["k2"][k] = stats
            if k in samples:
                got = torch.as_tensor(run["raycasts"][k], device=device)
                off = ((got > 0) != (ref > 0)) | (torch.abs(got - ref) > raycast_tol_m)
                px_off += int(off.sum())
                px_all += off.numel()
        if tracked and k in samples and k >= 1:
            model_depth = torch.as_tensor(run["raycasts"][k - 1], device=device)
            delta, fitness = rt.track(depth, model_depth, intr, low=low)
            if fitness <= cfg["fitness_threshold"] or k == 0:
                delta = torch.eye(4, device=device)
            expect = (poses[k - 1] @ delta).cpu().numpy()
            m, r = pose_gap(expect, run["poses"][k])
            gap_m, gap_rad = max(gap_m, m), max(gap_rad, r)

    table, tw, color = run["grid"]
    occ = rg.occupied(g.table) | rg.occupied(table)
    n_live = int(occ.sum())
    key_off = int((table != g.table).any(-1).sum())
    rows = torch.nonzero(occ).reshape(-1)
    tw_off = color_off = 0
    for blk in torch.split(rows, 4096):
        tw_off += int((tw[blk] != g.tw[blk]).sum())
        color_off += int((color[blk] != g.color[blk]).sum())
    words = max(n_live * (1 + 2 * rg.B3), 1)
    numbers = {
        "pose_gap_m": gap_m if tracked else None,
        "pose_gap_rad": gap_rad if tracked else None,
        "raycast_off": px_off / max(px_all, 1),
        "grid_off": (key_off + tw_off + color_off) / words,
        "blocks_dropped": dropped,
    }
    info = {"live_blocks": n_live,
            "raycasts_compared": sum(1 for k in range(len(run["ids"])) if k in samples)}
    return {k: v for k, v in numbers.items() if v is not None}, work, info
