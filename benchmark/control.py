"""The control of a cell's comparison: the reference put in the program's
place, computed through bfloat16 (the precision below the configuration's
float32), then judged by the same comparison as a run. Its readings are
the upper ends from which the limits in `limits/<cell>.json` were set; it
has to come out not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --steps 200

prints one JSON line a seed: the numbers compared, their limits and
whether the control came out correct. `--low 0` runs the reference at
float32 in the program's place instead (every number 0 or at rounding).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as bench_run
from benchmark.drivers import slam as slam_driver
from benchmark.reference import check as ref_check
from benchmark.reference import slam as ref_slam


def control_fragment(cfg, traffic, limits, seed: int, dev, low: bool = True) -> dict:
    """A fragment of the seed's first segment, built by the reference put in
    the program's place, judged as a run's sampled fragment is."""
    from benchmark.drivers import fragments as frag_driver
    from benchmark.reference import fragment as ref_frag

    depth, color, _ = slam_driver.make_frames(cfg, traffic, dev)
    depth, color = depth.numpy(), color.numpy()
    rc = cfg["reconstruction"]
    size = rc["fragment_size"]
    first = int(np.random.default_rng([seed, 5]).integers(depth.shape[0] // size))
    frames = frag_driver.reference_frames(depth, color, range(first * size, (first + 1) * size),
                                          rc["depth_max"], dev)
    intr = slam_driver.intrinsic_of(cfg)
    t = time.perf_counter()
    run = ref_frag.as_run(ref_frag.fragment(frames, intr, rc, low=low))
    t_session = time.perf_counter() - t
    ref = ref_frag.fragment(frames, intr, rc, poses=run["poses"])
    numbers = frag_driver.compare(run, ref)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return {"seed": seed, "low": low, "correct": all(c["value"] <= c["limit"]
                                                     for c in checks.values()),
            "session_s": t_session, "check_s": time.perf_counter() - t - t_session,
            "checks": checks}


def control(cfg, traffic, limits, seed: int, steps: int, dev, low: bool = True) -> dict:
    if traffic["driver"] == "fragments":
        return control_fragment(cfg, traffic, limits, seed, dev, low)
    depth, color, poses = slam_driver.make_frames(cfg, traffic, dev)
    intr = slam_driver.intrinsic_of(cfg)
    warm = traffic["warmup_steps"]
    samples = slam_driver.Samples(seed, warm, traffic["sample_stride"])
    frame_of = slam_driver.stream_ids(seed, depth.shape[0])
    ids = [frame_of(k) for k in range(steps)]
    keep = {k for k in range(steps) if k in samples or k + 1 in samples}
    tracked = traffic["mode"] == "track"

    def frames(j):
        return depth[j].to(dev), color[j].to(dev)

    t = time.perf_counter()
    out = ref_slam.session(frames, ids, poses, intr, cfg, tracked, keep, dev, low=low)
    t_session = time.perf_counter() - t
    numbers, _, info = ref_check.replay(frames, intr, cfg, out, samples, tracked, dev,
                                        limits["raycast_tol_m"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return {"seed": seed, "low": low, "steps": steps,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "session_s": t_session, "check_s": time.perf_counter() - t - t_session,
            "info": info, "checks": checks}


def main(argv=None, device=None, overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=0, help="steps of a SLAM session")
    p.add_argument("--low", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    overrides = overrides or {}
    here = bench_run.HERE
    cfg = {**bench_run.load_json(here / "configs" / f"{cell['config']}.json"),
           **overrides.get("config", {})}
    traffic = {**bench_run.load_json(here / "traffic" / f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    limits = {**bench_run.load_json(here / "limits" / f"{cell['name']}.json"),
              **overrides.get("limits", {})}
    if device is None and not torch.cuda.is_available():
        print("the control runs at the cell's size on the card", file=sys.stderr)
        return 2
    dev = torch.device(device or "cuda")
    for seed in args.seeds:
        print(json.dumps(control(cfg, traffic, limits, seed, args.steps, dev, bool(args.low))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
