"""The fragment mix (`drivers/fragments.py`, not yet a cell: PERF.md's Open
questions say why) at a tiny size on the CPU: the reference rebuilds the
sampled fragment's odometry edges, information matrices and cloud exactly
as the program wrote them."""

import json
import time

import torch

from benchmark.drivers import fragments
from benchmark.tests.conftest import ROOT

CFG = json.loads((ROOT / "benchmark/configs/fragment40.json").read_text())
CFG["camera"] = {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25, "cx": 79.5, "cy": 59.5}
CFG["reconstruction"].update(voxel_size=0.02, fragment_size=6, n_keyframes_per_n_frame=3,
                             fragment_point_capacity=8192)
TRAFFIC = {**json.loads((ROOT / "benchmark/traffic/hybrid.json").read_text()), "frames": 12}


def test_tiny_fragment_agrees_with_the_reference():
    out, ctx, numbers, info = fragments.run(CFG, TRAFFIC, {}, 2147483961, 0.5, True,
                                            torch.device("cpu"), time.perf_counter())
    assert out["attempted"] == 2 and out["fragment_s"] > 0
    assert info["edges"] >= 5 and info["points"] > 1000
    assert numbers["edges_off"] == 0
    assert numbers["edge_gap_m"] < 1e-5 and numbers["edge_gap_rad"] < 1e-5
    assert numbers["info_off"] < 1e-5
    assert numbers["cloud_off"] == 0
    assert len(ctx["k3_live"]) == 6 and len(ctx["layers"]["odometry"]) == ctx["pairs"] > 5
