"""The reference as a live SLAM session, put in the program's place: the
control of the comparison (`low=True`: the same steps computed through
bfloat16), and the plain session the tests hold the comparison to.

Each step does what the program's `slam_step` does (`models/dense_slam.py`
:162-204 as of commit c976156): track the frame against the last raycast
(the first step keeps the start pose; a fitness at or under the threshold
keeps the previous pose), integrate it at the new pose, raycast from that
pose. In the known-pose mix the step takes the stream's pose instead of
tracking. It returns what a run hands to `check.replay`.
"""

from __future__ import annotations

import torch

from benchmark.reference import grid as rg
from benchmark.reference import track as rt


def session(frames, ids, known_poses, intr: rg.Intr, cfg: dict, tracked: bool, keep, device,
            low: bool = False) -> dict:
    """`frames(j)` gives frame j's (depth, colour) on `device`, `ids` the
    frame of each step, `known_poses[j]` frame j's (4, 4) frame -> world
    pose (the start pose in the tracked mix), `keep` the steps whose
    raycast is handed in."""
    s = cfg["slam"]
    vs = s["voxel_size"]
    g = rg.create(s["block_count"], vs, s["trunc_voxel_multiplier"] * vs, device)
    T = torch.as_tensor(known_poses[ids[0]], dtype=torch.float32, device=device)
    model_depth = None
    poses, raycasts = [], {}
    for k, j in enumerate(ids):
        depth, color = frames(j)
        if not tracked:
            T = torch.as_tensor(known_poses[j], dtype=torch.float32, device=device)
        elif k > 0:
            delta, fitness = rt.track(depth, model_depth, intr, low=low)
            if fitness > cfg["fitness_threshold"]:
                T = T @ delta
        E = rg.invert_se3(T)
        keys, _ = rg.touch(g, depth, intr, E, s["depth_max"], s["frame_block_capacity"], low=low)
        g, _, _ = rg.integrate(g, keys, depth, color, intr, E, s["depth_max"], cfg["weight_max"],
                               low=low)
        if tracked or k in keep:
            model_depth = rg.raycast(g, intr, E, s["depth_min"], s["depth_max"], low=low)
        if k in keep:
            raycasts[k] = model_depth.cpu().numpy()
        poses.append(T.cpu().numpy())
    return {"ids": list(ids), "poses": poses, "raycasts": raycasts,
            "grid": (g.table, g.tw, g.color)}
