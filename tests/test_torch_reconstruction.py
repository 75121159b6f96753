"""Port parity for stage 2 of the offline system, register_fragments, on
the same three fragment clouds: 12 frames of the synthetic room at
160x120 (span 0.4), fragments of 4 frames fused by the port at their true
poses and written once with the port's PLY writer, so pair (0, 2) is
non-adjacent and registers through RANSAC. tests/test_torch_scene.py reads
the same fragments (`write_fragments`).

Bars:
- both packages keep the same three edges, the loop edge uncertain;
- adjacent edges within 1e-3 and information matrices within 1e-3 of
  their largest entry. A handful of the down-sampled points have a
  near-degenerate neighbourhood, whose smallest-eigenvalue direction the
  two eigensolvers pick differently; those few normals move ICP's pose
  by up to ~7e-4. Given the JAX package's own clouds and normals
  (`_pair_registration` on carried clouds), the port's ICP pose is within
  1e-4 of the JAX package's;
- the RANSAC edge within 0.05 of the truth in each package: the random
  draws differ (a torch generator, not JAX's stream), so the two are not
  compared with each other.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from open3d_tpu.io import read_point_cloud as jread_point_cloud
from open3d_tpu.pipelines import reconstruction as jrc
from open3d_tpu_torch import convert
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.pipelines import pose_graph as tpg
from open3d_tpu_torch.pipelines import reconstruction as trc

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
N_FRAMES, FRAGMENT = 12, 4
N_FRAG = N_FRAMES // FRAGMENT


def config(out: str) -> dict:
    """tests/test_reconstruction.py's configuration, at 2048 registration
    points a fragment."""
    return dict(fragment_size=FRAGMENT, n_keyframes_per_n_frame=3, depth_max=4.0,
                voxel_size=0.02, block_count=8192, block_resolution=8,
                trunc_voxel_multiplier=4.0, downsample_voxel_size=0.05,
                registration_point_capacity=2048, fragment_point_capacity=65536,
                path_output=out)


class Sequence:
    """What the stages read: intrinsic, len and read_frame(i)."""

    def __init__(self, intrinsic, depths, colors):
        self.intrinsic, self.depths, self.colors = intrinsic, depths, colors

    def __len__(self):
        return len(self.depths)

    def read_frame(self, i):
        return self.depths[i], self.colors[i]


def write_fragments(out: str, span: float = 0.4):
    """The room's 12 frames over `span` rad of the orbit, and 3 fragments
    fused by the port at their true poses: fragments/fragment_NNN.{ply,json}
    under `out`. Returns (depths, colors, extrinsics (numpy), fragment PLY
    paths, each fragment's true pose in fragment 0's frame)."""
    intr = TIntr(*INTR)
    d, c, e, _ = tsyn.render_sequence(N_FRAMES, intrinsic=intr, span=span, device="cpu")
    d, c, e = d.numpy(), c.numpy(), e.numpy()
    cfg = trc.ReconstructionConfig(**config(out))
    seq = Sequence(intr, d, c)
    frag_dir = os.path.join(out, "fragments")
    os.makedirs(frag_dir, exist_ok=True)
    paths = []
    for f in range(N_FRAG):
        s = f * FRAGMENT
        poses = np.stack([e[s] @ np.linalg.inv(e[i]) for i in range(s, s + FRAGMENT)])
        poses = poses.astype(np.float32)
        grid = trc.create_fragment_grid(cfg, "cpu")
        for k in range(FRAGMENT):
            rgbd = trc._read_rgbd(seq, s + k, cfg, torch.device("cpu"))
            grid = trc.integrate_fragment_frame(grid, rgbd, poses[k], intr, cfg)
        pcd = tvbg.extract_point_cloud(grid, point_capacity=cfg.fragment_point_capacity,
                                       weight_threshold=2.0)
        chain = np.array([[k, k + 1] for k in range(FRAGMENT - 1)], np.int32)
        X = np.stack([np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(FRAGMENT - 1)])
        graph = tpg.PoseGraph.create(poses, chain, X, device="cpu")
        paths.append(os.path.join(frag_dir, f"fragment_{f:03d}.ply"))
        tio.write_point_cloud(paths[-1], pcd)
        tpg.write_pose_graph(os.path.join(frag_dir, f"fragment_{f:03d}.json"), graph)
    truth = np.stack([e[0] @ np.linalg.inv(e[f * FRAGMENT]) for f in range(N_FRAG)])
    return d, c, e, paths, truth


@pytest.fixture(scope="module")
def fragments(tmp_path_factory):
    return write_fragments(str(tmp_path_factory.mktemp("fragments")))


@pytest.fixture(scope="module")
def registered(fragments, tmp_path_factory):
    paths = fragments[3]
    out = tmp_path_factory.mktemp("registered")
    cj = jrc.ReconstructionConfig(**config(str(out / "jax")))
    ct = trc.ReconstructionConfig(**config(str(out / "port")))
    return jrc.register_fragments(paths, cj), trc.register_fragments(paths, ct, device="cpu"), ct


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_register_fragments_matches_reference(fragments, registered):
    truth = fragments[4]
    gj, gt, ct = registered
    assert gt.edges.tolist() == np.asarray(gj.edges).tolist() == [[0, 1], [0, 2], [1, 2]]
    assert gt.uncertain.tolist() == np.asarray(gj.uncertain).tolist() == [False, True, False]
    assert bool(gt.edge_valid.all()) and bool(np.asarray(gj.edge_valid).all())
    for k, (s, t) in enumerate(gt.edges.tolist()):
        Xt, Xj = gt.transformations[k].numpy(), np.asarray(gj.transformations[k])
        X_true = np.linalg.inv(truth[s]) @ truth[t]
        if t == s + 1:
            np.testing.assert_allclose(Xt, Xj, atol=1e-3, rtol=0)
            assert _rel(gt.informations[k], gj.informations[k]) < 1e-3
        else:
            for X in (Xt, Xj):
                np.testing.assert_allclose(X, X_true, atol=0.05, rtol=0)
    np.testing.assert_allclose(gt.poses.numpy(), truth, atol=0.05, rtol=0)
    path = os.path.join(ct.path_output, "scene", "global_registration.json")
    back = tpg.read_pose_graph(path, device="cpu")
    assert torch.equal(back.poses, gt.poses) and torch.equal(back.edge_valid, gt.edge_valid)


def test_pair_registration_on_carried_clouds_matches_reference(fragments, tmp_path):
    """ICP from the identity and the information matrix on the JAX
    package's own down-sampled clouds and normals, carried across."""
    paths = fragments[3]
    cj = jrc.ReconstructionConfig(**config(str(tmp_path)))
    ct = trc.ReconstructionConfig(**config(str(tmp_path)))
    clouds = [jrc._preprocess_fragment(jread_point_cloud(p, capacity=2048), cj)[0]
              for p in paths[:2]]
    carried = [convert.point_cloud_from_numpy(
        {"positions": np.asarray(c.positions), "mask": np.asarray(c.mask),
         "normals": np.asarray(c.attrs["normals"])}, device="cpu") for c in clouds]
    rj, ij = jrc._pair_registration(*clouds, None, None, cj, True, jax.random.PRNGKey(0))
    rt, it = trc._pair_registration(*carried, None, None, ct, True, None)
    np.testing.assert_allclose(rt.transformation.numpy(), np.asarray(rj.transformation),
                               atol=1e-4, rtol=0)
    assert _rel(it, ij) < 1e-3
    assert abs(float(rt.fitness) - float(rj.fitness)) < 1e-3


def test_register_fragments_fgr_keeps_the_chain(fragments, tmp_path):
    """global_registration="fgr": the non-adjacent pair starts from FGR;
    the odometry chain holds either way."""
    paths, truth = fragments[3], fragments[4]
    out = str(tmp_path / "fgr")
    ct = trc.ReconstructionConfig(**{**config(out), "global_registration": "fgr"})
    g = trc.register_fragments(paths, ct, device="cpu")
    assert g.edges.tolist()[0] == [0, 1] and g.edges.tolist()[-1] == [1, 2]
    np.testing.assert_allclose(g.poses.numpy(), truth, atol=0.05, rtol=0)
    shutil.rmtree(out)
