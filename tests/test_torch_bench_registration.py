"""Port parity for the benchmark suite's registration sections and its
command, open3d_tpu_torch/bench.py against the JAX package's bench.py at
its small configuration (BENCH_SMALL: 160x120 pairs, capacities 2048 and
1024).

The port's bench_icp and bench_fpfh_ransac run on the CPU and are watched
through the names they call; the JAX package's functions run on the same
clouds or the same numpy frames. Its bench_icp is never called whole: its
`_drain` fails on the breakdown's 0-d result (ROADMAP.md §3 fault 7).

Bars:
- ICP: the port's 10-iteration point-to-plane pose within 5e-4 of the JAX
  package's reg.icp on the same clouds (tests/test_nns.py:148's bar), and
  icp_band_shortfall equal to a direct banded_one_nn call of the port;
- FPFH: the down-sampled counts of both frames equal to the JAX package's
  prep on the same frames (the rows themselves are not compared: the
  room's walls lie on multiples of the 0.05 m voxel, so which voxel a wall
  point falls in hangs on the unprojection's last ulp, ROADMAP.md §3
  fault 7); the FPFH of frame 0's
  cloud within tests/test_torch_global_registration.py's bar of the JAX
  package's on that cloud (rows no bin flip or neighbour-set change
  touches: 1e-3 plus what the neighbour tables' d2 can move them);
  every timed RANSAC call draws the same hypotheses;
- the command: `python -m open3d_tpu_torch.tools.cli bench --device cpu`
  under BENCH_SMALL exits 0 and prints one JSON line with the reference's
  keys.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from open3d_tpu.core import nns as jnns
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.pipelines import features as jfeat
from open3d_tpu.pipelines import registration as jreg
from open3d_tpu_torch import bench as tbench
from open3d_tpu_torch.core import nns as tnns
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.pipelines import features as tfeat
from open3d_tpu_torch.pipelines import global_registration as tgr
from open3d_tpu_torch.pipelines import registration as treg
from test_torch_global_registration import _fpfh_bar

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)  # bench.py's small registration camera


def _to_jax(p):
    return JPointCloud(positions=jnp.asarray(p.positions.numpy()), mask=jnp.asarray(p.mask.numpy()),
                       attrs={k: jnp.asarray(v.numpy()) for k, v in p.attrs.items()})


def _watch(mp, module, name, calls):
    fn = getattr(module, name)

    def run(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, kw, out))
        return out

    mp.setattr(module, name, run)


@pytest.fixture(scope="module")
def icp_run():
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _watch(mp, treg, "icp", calls)
        ips, breakdown = tbench.bench_icp(torch.Generator().manual_seed(0), small=True, device="cpu")
    return ips, breakdown, calls


@pytest.fixture(scope="module")
def fpfh_run():
    fpfh, ransac = [], []
    with pytest.MonkeyPatch.context() as mp:
        _watch(mp, tfeat, "compute_fpfh_feature", fpfh)
        _watch(mp, tgr, "registration_ransac_based_on_feature_matching", ransac)
        s = tbench.bench_fpfh_ransac(torch.Generator().manual_seed(0), small=True, device="cpu")
    return s, fpfh, ransac


def test_icp_pose_matches_the_reference(icp_run):
    ips, breakdown, calls = icp_run
    assert len(calls) == 4  # one warm call and three timed
    (src, tgt, dmax), kw, res = calls[0]
    assert dmax == 0.05 and kw["criteria"].max_iteration == 10
    assert kw["criteria"].relative_fitness == 0.0 and kw["criteria"].relative_rmse == 0.0
    assert isinstance(kw["estimation"], treg.TransformationEstimationPointToPlane)
    assert all(torch.equal(c[2].transformation, res.transformation) for c in calls)
    assert 500 < int(src.count()) <= 2048 and 500 < int(tgt.count()) <= 2048
    f = jax.jit(lambda s, t: jreg.icp(
        s, t, 0.05, estimation=jreg.TransformationEstimationPointToPlane(),
        criteria=jreg.ICPConvergenceCriteria(max_iteration=10, relative_fitness=0.0,
                                             relative_rmse=0.0)).transformation)
    Tj = np.asarray(f(_to_jax(src), _to_jax(tgt)))
    np.testing.assert_allclose(res.transformation.numpy(), Tj, atol=5e-4, rtol=0)
    assert math.isfinite(ips) and ips > 0


def test_icp_shortfall_is_the_band_reading(icp_run):
    _, breakdown, calls = icp_run
    (src, tgt, _), kw, _ = calls[0]
    est = kw["estimation"]
    b = tnns.banded_build(tgt.positions, tgt.mask, est.corr_extras(tgt), window=2048)
    order = torch.argsort(torch.where(src.mask, tnns.banded_query_key(b, src.positions), 3e38),
                          stable=True)
    short = tnns.banded_one_nn(b, src.positions[order], 0.05, qmask=src.mask[order])[3]
    assert breakdown["icp_band_shortfall"] == int(short)
    assert isinstance(breakdown["icp_band_shortfall"], int)
    assert set(breakdown) == {"icp_nn_ms", "icp_estimation_ms", "icp_other_ms", "icp_band_shortfall"}
    assert breakdown["icp_nn_ms"] > 0
    assert breakdown["icp_estimation_ms"] >= 0 and breakdown["icp_other_ms"] >= 0


def test_fpfh_counts_and_features_match_the_reference(fpfh_run):
    secs, fpfh, ransac = fpfh_run
    assert math.isfinite(secs) and secs > 0
    # the prep of frames 0 and 1, the warm prep and three timed preps of frame 0
    assert len(fpfh) == 6
    kw = fpfh[0][1]
    assert kw == {"radius": 0.25, "max_nn": 64}
    d, _, e, _ = tsyn.render_sequence(2, intrinsic=TIntr(*INTR), span=0.4, device="cpu")

    def prep(depth, E):  # bench.py:297-301
        from open3d_tpu.geometry.rgbd import pointcloud_from_depth
        from open3d_tpu.ops import pointcloud as pc_ops

        pcd = pointcloud_from_depth(depth, JIntr(*INTR), E)
        down = pc_ops.voxel_down_sample(pcd, 0.05, capacity=1024)
        down = pc_ops.estimate_normals(down, max_nn=30, radius=0.1)
        return down, jfeat.compute_fpfh_feature(down, radius=0.25, max_nn=64)

    pj = jax.jit(prep)
    for i in range(2):
        down_j, _ = pj(d[i].numpy(), e[i].numpy())
        down_t = fpfh[i][0][0]
        assert int(down_t.count()) == int(np.asarray(down_j.mask).sum()) > 100

    # FPFH of frame 0's cloud in both packages, on the port's cloud
    cloud, ft = fpfh[0][0][0], fpfh[0][2]
    jc = _to_jax(cloud)
    fj = np.asarray(jfeat.compute_fpfh_feature(jc, radius=0.25, max_nn=64))
    n = cloud.capacity
    ja, jd2, _ = jnns.hybrid_search(jc.positions, jc.positions, 0.25, 64, target_mask=jc.mask)
    ta, td2, _ = tnns.hybrid_search(cloud.positions, cloud.positions, 0.25, 64,
                                    target_mask=cloud.mask)
    idx = np.asarray(ja)
    safe = np.maximum(idx, 0)
    rows = np.arange(n, dtype=np.int32)
    sj, _ = jfeat._spfh(jc.positions, jc.attrs["normals"], ja, jnp.asarray(rows))
    st, _ = tfeat._spfh(cloud.positions, cloud.attrs["normals"], torch.from_numpy(idx.copy()),
                        torch.from_numpy(rows))
    flip = (np.abs(st.numpy() - np.asarray(sj)) > 1e-3).any(1)
    flip |= ~np.all(np.sort(idx, 1) == np.sort(ta.numpy(), 1), axis=1)
    touched = flip | np.any(flip[safe] & (idx >= 0), axis=1)
    valid = cloud.mask.numpy()
    kept = valid & ~touched
    assert kept.sum() >= 0.9 * valid.sum()
    bar = _fpfh_bar(torch.from_numpy(idx), torch.from_numpy(np.asarray(jd2)), ta, td2).numpy()
    err = np.abs(ft.numpy() - fj).max(1)
    assert np.all(err[kept] <= bar[kept]), (err[kept].max(), bar[kept].min())

    # one warm RANSAC call and three timed, every one from the same draws
    assert len(ransac) == 4
    assert all(torch.equal(r[2].transformation, ransac[0][2].transformation) for r in ransac)
    assert ransac[0][1]["criteria"].max_iteration == 4096
    assert ransac[0][1]["max_correspondence_distance"] == 0.07


def test_bench_command_prints_the_reference_line(tmp_path):
    env = dict(os.environ, BENCH_SMALL="1", OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "open3d_tpu_torch.tools.cli", "bench",
                          "--device", "cpu"], cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    top, extra = chip_smoke.reference_bench_keys()
    assert set(line) == top and set(line["extra"]) == extra
    assert line["value"] > 0 and line["extra"]["sync"].startswith("none")
    assert jbench.BASELINE_FPS == tbench.BASELINE_FPS
