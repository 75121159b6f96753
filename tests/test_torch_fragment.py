"""Port parity for reconstruction stage 1: the fragment point cloud
(`extract_point_cloud`), its PLY file, the point-cloud state carry, and
`make_fragments` itself, through both packages from the same in-memory
frames.

Bars: extraction on one grid carried across by `convert` gives the same
count, positions within 1e-5 and normals within 1e-4 (the same float32
formulas, in the same order). PLY bytes are identical. `make_fragments` at
160x120 (tests/test_reconstruction.py's configuration, one fragment of the
first 4 of the 6 rendered frames: three odometry pairs and two keyframe
loop-closure candidates; the JAX package's run takes most of this file's
time, as it compiles its odometry loops anew for every pair): fragment
poses within 0.02 m / 0.02 rad of each other and 0.05 of the truth, point
counts within 2 % (the odometry sums and the fuse's colour rounding differ
in the last bits, and the fuse's samples differ where a voxel sits on a
half-pixel).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.io import write_point_cloud as jwrite_point_cloud
from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu.pipelines import reconstruction as jrc
from open3d_tpu_torch import convert
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.geometry.pointcloud import PointCloud as TPointCloud
from open3d_tpu_torch.pipelines import pose_graph as tpg
from open3d_tpu_torch.pipelines import reconstruction as trc

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
N_FRAMES = 6
N_FRAG = 4  # frames of the make_fragments test


class _Sequence:
    """The in-memory sequence make_fragments reads: intrinsic, len and
    read_frame(i) -> (depth, color) numpy arrays."""

    def __init__(self, intrinsic, depths, colors):
        self.intrinsic = intrinsic
        self._d, self._c = depths, colors

    def __len__(self):
        return len(self._d)

    def read_frame(self, i):
        return self._d[i], self._c[i]


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = jsyn.render_sequence(N_FRAMES, intrinsic=JIntr(*INTR), span=0.4)
    return np.asarray(d), np.asarray(c), np.asarray(e)


@pytest.fixture(scope="module")
def grid_jax(frames):
    d, c, e = frames
    ji = JIntr(*INTR)
    vj = jvbg.create(voxel_size=0.02, block_resolution=8, block_count=2048)
    for i in range(3):
        keys, _ = jvbg.compute_unique_block_coordinates(vj, d[i], ji, e[i], 3.0,
                                                        frame_block_capacity=1024)
        vj = jvbg.integrate(vj, keys, d[i], c[i], ji, e[i], depth_max=3.0)
    return vj


def test_extract_point_cloud_matches_jax(grid_jax):
    vj = grid_jax
    vt = convert.vbg_from_numpy(np.asarray(vj.table), np.asarray(vj.tw), np.asarray(vj.color),
                                vj.voxel_size, vj.block_resolution, vj.sdf_trunc, device="cpu")
    pj = jvbg.extract_point_cloud(vj, point_capacity=65536, weight_threshold=2.0)
    pt = tvbg.extract_point_cloud(vt, point_capacity=65536, weight_threshold=2.0)
    n = int(pj.count())
    assert n == int(pt.count()) and 5000 < n < 65536
    np.testing.assert_array_equal(np.asarray(pj.mask), pt.mask.numpy())
    dj, dt = pj.to_numpy(), pt.to_numpy()
    assert dj.keys() == dt.keys() == {"positions", "normals", "colors"}
    oj = np.lexsort(dj["positions"].T)
    ot = np.lexsort(dt["positions"].T)
    np.testing.assert_allclose(dj["positions"][oj], dt["positions"][ot], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dj["normals"][oj], dt["normals"][ot], atol=1e-4, rtol=0)
    np.testing.assert_allclose(dj["colors"][oj], dt["colors"][ot], atol=1e-6, rtol=0)


def test_point_cloud_ply_and_carry(grid_jax, tmp_path):
    """PLY and PCD bytes equal JAX's for the same cloud; the cloud carries
    JAX -> numpy -> port -> numpy bit-identically; the port reads its PLY
    back."""
    pj = jvbg.extract_point_cloud(grid_jax, point_capacity=32768, weight_threshold=2.0)
    arrays = {"positions": np.asarray(pj.positions), "mask": np.asarray(pj.mask)}
    arrays.update({k: np.asarray(v) for k, v in pj.attrs.items()})
    pt = convert.point_cloud_from_numpy(arrays, device="cpu")
    back = convert.point_cloud_to_numpy(pt)
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype and np.array_equal(back[k], arrays[k]), k

    a, b = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jwrite_point_cloud(a, pj)
    tio.write_point_cloud(b, pt)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    rd = tio.read_point_cloud(b, capacity=40000, device="cpu")
    assert rd.capacity == 40000 and int(rd.count()) == int(pj.count())
    np.testing.assert_array_equal(rd.to_numpy()["positions"], pt.to_numpy()["positions"])
    a, b = str(tmp_path / "jax.pcd"), str(tmp_path / "port.pcd")
    jwrite_point_cloud(a, pj)
    tio.write_point_cloud(b, pt)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_point_cloud_container():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(10, 3)).astype(np.float32)
    mask = np.arange(10) % 3 != 0
    pt = TPointCloud.create(pos, capacity=16, mask=mask, device="cpu",
                            normals=np.ones((10, 3), np.float32))
    pj = JPointCloud.create(pos, capacity=16, mask=mask, normals=np.ones((10, 3), np.float32))
    assert pt.capacity == 16 and int(pt.count()) == int(pj.count()) == 6
    np.testing.assert_array_equal(pt.positions.numpy(), np.asarray(pj.positions))
    assert pt.has("normals") and not pt.has("colors") and pt.colors is None
    assert pt.with_attrs(colors=torch.zeros(16, 3)).has("colors")
    assert not pt.with_attrs(normals=None).has("normals")
    np.testing.assert_array_equal(pt.valid_positions(0.0).numpy(),
                                  np.asarray(pj.valid_positions(0.0)))


def _cfg(out):
    return dict(fragment_size=N_FRAG, n_keyframes_per_n_frame=3, depth_max=4.0,
                voxel_size=0.02, block_count=8192, block_resolution=8,
                trunc_voxel_multiplier=4.0, downsample_voxel_size=0.05,
                registration_point_capacity=8192, fragment_point_capacity=65536,
                path_output=out)


def test_make_fragments_matches_jax(frames, tmp_path):
    d, c, e = (a[:N_FRAG] for a in frames)
    cj = jrc.ReconstructionConfig(**_cfg(str(tmp_path / "jax")))
    ct = trc.ReconstructionConfig(**_cfg(str(tmp_path / "port")))
    pj = jrc.make_fragments(_Sequence(JIntr(*INTR), d, c), cj)
    pt = trc.make_fragments(_Sequence(TIntr(*INTR), d, c), ct, device="cpu")
    assert [os.path.basename(p) for p in pj] == [os.path.basename(p) for p in pt] == \
        ["fragment_000.ply"]
    gj = jpg.read_pose_graph(os.path.join(cj.path_output, "fragments", "fragment_000.json"))
    gt = tpg.read_pose_graph(os.path.join(ct.path_output, "fragments", "fragment_000.json"),
                             device="cpu")
    assert gt.poses.shape[0] == N_FRAG
    # both keep the odometry chain; a loop closure whose confidence ends
    # near the prune threshold may survive in one package only
    chain = [[i, i + 1] for i in range(N_FRAG - 1)]
    for g in (np.asarray(gj.edges), gt.edges.numpy()):
        assert [list(x) for x in g if x[1] == x[0] + 1] == chain
    truth = torch.from_numpy(e[0] @ np.linalg.inv(e)).float()  # frame i -> frame 0
    for i in range(N_FRAG):
        rot, trans = tlie.pose_distance(gt.poses[i], torch.from_numpy(np.asarray(gj.poses[i])))
        assert float(rot) < 0.02 and float(trans) < 0.02, (i, float(rot), float(trans))
        rot, trans = tlie.pose_distance(gt.poses[i], truth[i])
        assert float(rot) < 0.05 and float(trans) < 0.05, (i, float(rot), float(trans))
    nj = int(tio.read_point_cloud(pj[0], device="cpu").count())
    nt = int(tio.read_point_cloud(pt[0], device="cpu").count())
    assert nj > 5000 and abs(nj - nt) <= 0.02 * nj, (nj, nt)
    # a rerun finds the artifacts and skips the fragment
    mtime = os.path.getmtime(pt[0])
    assert trc.make_fragments(_Sequence(TIntr(*INTR), d, c), ct, device="cpu") == pt
    assert os.path.getmtime(pt[0]) == mtime
    # the mesh path (tests/test_torch_parallel_pipeline.py) refuses what is
    # not a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        trc.make_fragments(_Sequence(TIntr(*INTR), d, c), ct, mesh=object(), device="cpu")


def test_config_yaml_and_ate(tmp_path):
    cfg = trc.ReconstructionConfig(voxel_size=0.01, fragment_size=7)
    p = str(tmp_path / "c.yml")
    cfg.to_yaml(p)
    assert trc.ReconstructionConfig.from_yaml(p) == cfg
    assert jrc.ReconstructionConfig.from_yaml(p).fragment_size == 7
    assert trc._fragment_ranges(10, 4) == jrc._fragment_ranges(10, 4) == [(0, 4), (4, 8), (8, 10)]
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, :3, 3] = rng.uniform(-1, 1, (12, 3))
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (12, 3))
    assert trc.absolute_trajectory_error(est, gt) == pytest.approx(
        jrc.absolute_trajectory_error(est, gt), rel=1e-12)
    a_t, R_t, t_t = trc.align_trajectories_horn(est, gt)
    a_j, R_j, t_j = jrc.align_trajectories_horn(est, gt)
    np.testing.assert_allclose(a_t, a_j, atol=1e-12)
