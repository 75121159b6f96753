"""A witness of the program's pose-graph fault (PERF.md, Open questions):
`core/lie.py:se3_log` in float32 at small rotations, and the
Levenberg-Marquardt of `pose_graph.global_optimization` that rests on it.

    python3 -m benchmark.pose_graph_witness [cuda|cpu]

prints, a JSON line each, the program's `se3_log` in float32 and float64
at four small angles; then, for each segment of the fragment mix, the
graph the reference builds (its HYBRID edges, information matrices and
keyframe decisions), the program's `global_optimization` on that graph and
its loop replayed step by step (steps whose solve came back NaN, steps
rejected, the iteration it stopped at), the reference's float64 optimum,
and the robust objective (the line-process cost) at both. On the CPU it
runs the test size (160 x 120, 6-frame fragments). The benchmark's runs
do not run this.
"""

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from benchmark import run
from benchmark.drivers import fragments as fd
from benchmark.drivers import slam as sd
from benchmark.reference import check as rc
from benchmark.reference import fragment as rf


def objective(g, P, mu) -> float:
    """The line-process cost of graph `g` at poses `P`, each loop closure's
    weight at its closed-form optimum, in float64."""
    P = torch.as_tensor(P, device=g.poses.device).double()
    s, t = g.edges[:, 0].long(), g.edges[:, 1].long()
    r = rf._residual(P[s], P[t], g.transformations.double())
    q = torch.einsum("ei,eij,ej->e", r, g.informations.double(), r)
    m = float(mu)
    lp = torch.where(g.uncertain, (m / (m + q)) ** 2, torch.ones_like(q))
    pen = torch.where(g.uncertain, m * (torch.sqrt(lp) - 1) ** 2, torch.zeros_like(q))
    return float(torch.sum(lp * q + pen))


def replay(pg, lie, g, opt):
    """The program's LM loop (`global_optimization`), step by step:
    (solves that came back NaN, steps rejected, the iteration it stopped at
    or None, mu)."""
    valid = g.edge_valid
    n = torch.clamp(valid.sum(), min=1)
    mu = (opt.preference_loop_closure * opt.max_correspondence_distance ** 2
          * torch.sum(torch.where(valid, g.informations[:, 5, 5], 0.0)) / n)
    poses, conf, lam = g.poses, g.confidence, torch.tensor(1e-4, device=g.poses.device)
    nan = rejected = 0
    for it in range(100):
        w = torch.where(valid, torch.where(g.uncertain, conf, 1.0), 0.0)
        H, b, cost = pg._build_system(dataclasses.replace(g, poses=poses), w)
        dx = pg._solve(H, b, lam, 0)
        nan += int(torch.isnan(dx).any())
        new = lie.se3_exp(dx) @ poses
        new_cost = pg._cost(pg._residuals(dataclasses.replace(g, poses=new)),
                            g.informations * w[:, None, None])
        ok = new_cost < cost
        rejected += int(~ok)
        poses = torch.where(ok, new, poses)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-7), torch.clamp(lam * 3.0, max=1e4))
        r = pg._residuals(dataclasses.replace(g, poses=poses))
        conf = torch.where(ok, pg._line_process_weights(r, g.informations, g.uncertain, valid,
                                                        mu), conf)
        if bool(ok & (torch.abs(cost - new_cost) / torch.clamp(cost, min=1e-12) < 1e-6)):
            return nan, rejected, it, mu
    return nan, rejected, None, mu


def main(device: str) -> None:
    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.pipelines import pose_graph as pg

    dev = torch.device(device)
    cfg = run.load_json(run.HERE / "configs/fragment40.json")
    tr = run.load_json(run.HERE / "traffic/hybrid.json")
    R = cfg["reconstruction"]
    if dev.type == "cpu":
        cfg["camera"] = {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25, "cx": 79.5,
                         "cy": 59.5}
        R.update(voxel_size=0.02, fragment_size=6, n_keyframes_per_n_frame=3,
                 fragment_point_capacity=8192)
        tr["frames"] = 12
    for th in (1e-4, 3e-4, 1e-3, 3e-3):
        T = lie.se3_exp(torch.tensor([th, 0.0, 0.0, 0.01, 0.02, 0.03], device=dev))
        print(json.dumps({"se3_log_theta": th, "float32": lie.se3_log(T).cpu().tolist(),
                          "float64": lie.se3_log(T.double()).cpu().tolist()}), flush=True)
    d, c, _ = sd.make_frames(cfg, tr, dev)
    intr = sd.intrinsic_of(cfg)
    size = R["fragment_size"]
    for seg in range(d.shape[0] // size):
        frames = fd.reference_frames(d.numpy(), c.numpy(), range(seg * size, (seg + 1) * size),
                                     R["depth_max"], dev)
        t = time.time()
        ref = rf.fragment(frames, intr, R)
        t_ref = time.time() - t
        odom = [np.eye(4, dtype=np.float32)]
        for k, (i, j) in enumerate(ref["edges"]):
            if j == i + 1:
                odom.append(odom[-1] @ ref["X"][k])
        g = pg.PoseGraph.create(np.stack(odom), np.asarray(ref["edges"], np.int32), ref["X"],
                                informations=ref["info"], uncertain=ref["uncertain"], device=dev)
        opt = pg.GlobalOptimizationOption(
            max_correspondence_distance=R["voxel_size"] * 1.4,
            preference_loop_closure=R["preference_loop_closure_odometry"])
        out = pg.global_optimization(g, opt)
        nan, rejected, stop, mu = replay(pg, lie, g, opt)
        gaps = [rc.pose_gap(a, b) for a, b in zip(out.poses.cpu().numpy(), ref["poses"])]
        print(json.dumps({
            "segment": seg, "device": str(dev), "edges": len(ref["edges"]),
            "program_nan_steps": nan, "program_rejected_steps": rejected,
            "program_stop_iteration": stop, "objective_program": objective(g, out.poses, mu),
            "objective_reference": objective(g, ref["poses"], mu),
            "pose_gap_m": max(m for m, _ in gaps), "pose_gap_rad": max(r for _, r in gaps),
            "reference_s": t_ref}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
