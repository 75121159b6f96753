"""Each fault a SLAM cell can have, planted under the timed path of a tiny
CPU run, makes `correct` come out false: a step that leaves its state
unchanged, half of the touched blocks left out, an answer altered where it
is produced. (The cells run on one card: there is no exchange between
chips to leave out.)"""

import pytest
import torch

from benchmark.tests.conftest import CELLS, run_cell


def _run_with(capsys, monkeypatch, cell, mod, attr, make):
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    rc, line = run_cell(capsys, cell)
    assert rc == 0
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_integrate_that_leaves_the_grid_unchanged(capsys, monkeypatch, cell):
    from open3d_tpu_torch.models import dense_slam

    line = _run_with(capsys, monkeypatch, cell, dense_slam, "integrate_frame",
                     lambda f: lambda model, *a, **k: (model, torch.zeros((), dtype=torch.int32)))
    assert line["correct"] is False
    assert line["checks"]["grid_off"]["value"] > line["checks"]["grid_off"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_touched_blocks_left_out(capsys, monkeypatch, cell):
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod

    def make(f):
        def integrate(vbg, keys, *a, **k):
            n = int(((keys[..., 1] & 1) == 1).sum())
            keys = keys.clone()
            keys[n // 2:] = 0
            return f(vbg, keys, *a, **k)
        return integrate

    line = _run_with(capsys, monkeypatch, cell, vbg_mod, "integrate", make)
    assert line["correct"] is False
    assert line["checks"]["grid_off"]["value"] > line["checks"]["grid_off"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_raycast_altered_where_it_is_produced(capsys, monkeypatch, cell):
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg_mod

    def make(f):
        def raycast(*a, **k):
            ray = f(*a, **k)
            return ray._replace(depth=torch.where(ray.depth > 0, ray.depth + 1e-3, 0.0))
        return raycast

    line = _run_with(capsys, monkeypatch, cell, vbg_mod, "raycast", make)
    assert line["correct"] is False
    assert line["checks"]["raycast_off"]["value"] > line["checks"]["raycast_off"]["limit"]


def test_tracked_pose_altered_where_it_is_produced(capsys, monkeypatch):
    from open3d_tpu_torch.pipelines import odometry

    def make(f):
        def odo(*a, **k):
            res = f(*a, **k)
            T = res.transformation.clone()
            T[0, 3] += 1e-3
            return type(res)(transformation=T, fitness=res.fitness, inlier_rmse=res.inlier_rmse)
        return odo

    line = _run_with(capsys, monkeypatch, "slam640.track", odometry, "rgbd_odometry_multi_scale",
                     make)
    assert line["correct"] is False
    assert line["checks"]["pose_gap_m"]["value"] > line["checks"]["pose_gap_m"]["limit"]
