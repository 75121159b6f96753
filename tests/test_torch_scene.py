"""Port parity for stage 4 of the offline system, integrate_scene, and the
scene mesh, extract_scene_mesh, against open3d_tpu.

integrate_scene runs on the synthetic room's first 3 frames (160x120) in
fragments of 2 (so the last fragment is short), from the same fragment and
scene pose-graph JSONs (the true poses), into a 16^3 grid: the port's K1
path, the JAX package's XLA integrate on the CPU. Each frame touches up to
8192 blocks, which the JAX package's XLA path sweeps whole (~8 s a frame
here), so the run stays at 3 frames.

Bars: the trajectory within 1e-6 (the same float32 products) and
trajectory.log byte for byte; the grid within tests/test_torch_integrate.py's
bars, a frame at a time (weights equal but for < 1e-6 of voxels a frame,
where a sample at the truncation edge flips between the XLA path's float32
depth and K1's d21, each off by one; tsdf and colour, like that file's
colour, within 1e-3 and 2/255 at the 99.9 % quantile); trajectory.log read
back within 1e-6. extract_scene_mesh on the JAX grid carried across, at a
capacity the surface overflows: topology exact (the small-component mask
included), vertices and colours within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu.pipelines import reconstruction as jrc
from open3d_tpu_torch import convert
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.pipelines import pose_graph as tpg
from open3d_tpu_torch.pipelines import reconstruction as trc
from test_torch_reconstruction import INTR, Sequence, config

torch.set_num_threads(2)
N_FRAMES, FRAGMENT = 3, 2


@pytest.fixture(scope="module")
def integrated(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    d, c, e, _ = tsyn.render_sequence(N_FRAMES, intrinsic=TIntr(*INTR), span=0.1, device="cpu")
    d, c, e = d.numpy(), c.numpy(), e.numpy()
    kw = {**config(""), "fragment_size": FRAGMENT, "block_resolution": 16, "block_count": 1024}
    cj = jrc.ReconstructionConfig(**{**kw, "path_output": str(root / "jax")})
    ct = trc.ReconstructionConfig(**{**kw, "path_output": str(root / "port")})
    starts = list(range(0, N_FRAMES, FRAGMENT))
    for out in (cj.path_output, ct.path_output):
        os.makedirs(os.path.join(out, "fragments"))
        for f, s in enumerate(starts):
            n = min(FRAGMENT, N_FRAMES - s)
            poses = np.stack([e[s] @ np.linalg.inv(e[s + k]) for k in range(n)]).astype(np.float32)
            chain = np.array([[k, k + 1] for k in range(n - 1)], np.int32).reshape(-1, 2)
            X = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(n - 1)]
            graph = tpg.PoseGraph.create(poses, chain, np.stack(X) if X else np.eye(4)[None],
                                         device="cpu")
            tpg.write_pose_graph(os.path.join(out, "fragments", f"fragment_{f:03d}.json"), graph)
    scene = np.stack([e[0] @ np.linalg.inv(e[s]) for s in starts]).astype(np.float32)
    graph_path = str(root / "scene.json")
    tpg.write_pose_graph(graph_path, tpg.PoseGraph.create(
        scene, np.array([[0, 1]], np.int32), (np.linalg.inv(scene[0]) @ scene[1])[None],
        device="cpu"))
    vj, tj = jrc.integrate_scene(Sequence(JIntr(*INTR), d, c), jpg.read_pose_graph(graph_path), cj)
    vt, tt = trc.integrate_scene(Sequence(TIntr(*INTR), d, c),
                                 tpg.read_pose_graph(graph_path, device="cpu"), ct, device="cpu")
    return e, vj, tj, vt, tt, cj, ct


def _weights_tsdf(tw):
    a = np.asarray(tw).reshape(-1)
    return a & 0xFFFF, (a >> 16).astype(np.float32) / 16383.0


def test_integrate_scene_matches_reference(integrated):
    e, vj, tj, vt, tt, cj, ct = integrated
    assert tt.shape == tj.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(tt, tj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt, e[0] @ np.linalg.inv(e), atol=1e-5, rtol=0)
    with open(os.path.join(cj.path_output, "trajectory.log"), "rb") as a, \
            open(os.path.join(ct.path_output, "trajectory.log"), "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_allclose(tio.read_trajectory_log(os.path.join(ct.path_output,
                                                                    "trajectory.log")),
                               tt, atol=1e-6, rtol=0)
    assert vt.block_resolution == 16 and vt.capacity == 1024
    np.testing.assert_array_equal(np.asarray(vj.table), vt.table.numpy())
    assert int(vt.num_active_blocks()) > 50
    wa, ta = _weights_tsdf(vj.tw)
    wb, tb = _weights_tsdf(vt.tw)
    diff = wa != wb
    assert diff.mean() < 1e-6 * N_FRAMES, diff.sum()
    assert np.abs(wa.astype(np.int64) - wb)[diff].max(initial=0) <= 1
    # tsdf within 1e-3 at the 99.9 % quantile of the observed voxels: a
    # voxel that projects onto a half pixel reads the neighbouring pixel in
    # one package, which at a depth edge moves its tsdf by up to the
    # truncation (tests/test_torch_integrate.py's 2 frames meet none)
    dt = np.abs(ta - tb)[~diff & (wa > 0)]
    assert np.quantile(dt, 0.999) <= 1e-3, np.quantile(dt, 0.999)
    assert (dt > 1e-3).mean() < 1e-3, (dt > 1e-3).sum()
    ca = np.asarray(vj.color_f32())
    cb = vt.color_f32().numpy()
    err = np.abs(ca - cb).max(axis=-1).reshape(-1)[~diff]
    assert np.quantile(err, 0.999) <= 2.0 / 255.0, np.quantile(err, 0.999)
    assert (err > 2.0 / 255.0).mean() < 1e-3


def test_extract_scene_mesh_matches_reference(integrated):
    vj = integrated[1]
    vt = convert.vbg_from_numpy(np.asarray(vj.table), np.asarray(vj.tw), np.asarray(vj.color),
                                vj.voxel_size, vj.block_resolution, vj.sdf_trunc, device="cpu")
    # the surface needs more triangles than this capacity: as at the
    # scene's defaults, the mesh keeps the scan's first ones
    mj = jrc.extract_scene_mesh(vj, triangle_capacity=30_000)
    mt = trc.extract_scene_mesh(vt, triangle_capacity=30_000)
    n = int(mt.num_triangles())
    raw = int(trc.extract_scene_mesh(vt, triangle_capacity=30_000,
                                     min_component_triangles=0).num_triangles())
    assert 1000 < n < raw == 30_000, (n, raw)  # small components went
    for f in ("triangles", "vertex_mask", "triangle_mask"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)))
    np.testing.assert_allclose(mt.vertices.numpy(), np.asarray(mj.vertices), atol=1e-6, rtol=0)
    np.testing.assert_allclose(mt.vertex_attrs["colors"].numpy(),
                               np.asarray(mj.vertex_attrs["colors"]), atol=1e-6, rtol=0)
