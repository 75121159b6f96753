"""Port parity for geometry/voxelgrid.py (VoxelGrid, carving, the linear
Octree): the same seeded numpy inputs through open3d_tpu and
open3d_tpu_torch, and each assertion of tests/test_voxelgrid.py on the port.

Bars: every integer output (voxel coordinates, counts, membership, the
carved set, Morton codes, the octree's levels, order and leaves) exact;
colours within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.geometry import voxelgrid as jvg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch.geometry import voxelgrid as tvg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr

torch.set_num_threads(2)


def _cloud(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    pts[::7] = pts[1::7][: len(pts[::7])]  # repeated points share a voxel
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32), rng.uniform(size=n) > 0.1


@pytest.mark.parametrize("max_voxels", [None, 300])
@pytest.mark.parametrize("origin", [None, (-1.3, -1.1, -1.05)])
def test_create_from_point_cloud_matches_reference(max_voxels, origin):
    pts, cols, mask = _cloud()
    a = jvg.create_from_point_cloud(jnp.asarray(pts), 0.37, colors=jnp.asarray(cols),
                                    mask=jnp.asarray(mask), max_voxels=max_voxels, origin=origin)
    b = tvg.create_from_point_cloud(torch.from_numpy(pts), 0.37, colors=torch.from_numpy(cols),
                                    mask=torch.from_numpy(mask), max_voxels=max_voxels,
                                    origin=origin)
    np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords))
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    assert int(b.num_voxels) == int(a.num_voxels)
    np.testing.assert_allclose(b.colors.numpy(), np.asarray(a.colors), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(b.origin.numpy(), np.asarray(a.origin))
    np.testing.assert_allclose(b.get_voxel_centers().numpy(), np.asarray(a.get_voxel_centers()),
                               rtol=0, atol=1e-6)
    q = np.concatenate([pts, np.random.default_rng(1).uniform(-1.5, 2.5, (500, 3))]).astype(
        np.float32)
    inc = b.check_if_included(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(inc, np.asarray(a.check_if_included(jnp.asarray(q))))
    if max_voxels is None:
        assert inc[:len(pts)][mask].all()


def _dense(pkg):
    args = ([0.1, 0.0, -0.3], [0.5, 0.5, 0.5], 0.13, 2.0, 1.7, 2.2)
    return jvg.create_dense(*args) if pkg == "jax" else tvg.create_dense(*args, device="cpu")


def test_create_dense_matches_reference():
    a, b = _dense("jax"), _dense("port")
    np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords))
    np.testing.assert_array_equal(b.colors.numpy(), np.asarray(a.colors))
    assert int(b.num_voxels) == int(a.num_voxels) == 15 * 13 * 17


@pytest.mark.parametrize("keep_outside", [True, False])
def test_carve_depth_map_matches_reference(keep_outside):
    E = np.array([[0.96, -0.28, 0.0, 0.1], [0.28, 0.96, 0.0, -0.2], [0, 0, 1, 2.0], [0, 0, 0, 1]],
                 np.float32)
    depth = np.random.default_rng(2).uniform(0, 4, (48, 64)).astype(np.float32)
    depth[::5, ::3] = 0.0  # holes never carve
    a = jvg.carve_depth_map(_dense("jax"), jnp.asarray(depth),
                            JIntr(64, 48, 40.0, 40.0, 31.5, 23.5), jnp.asarray(E), keep_outside)
    b = tvg.carve_depth_map(_dense("port"), torch.from_numpy(depth),
                            TIntr(64, 48, 40.0, 40.0, 31.5, 23.5), torch.from_numpy(E),
                            keep_outside)
    np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords))
    assert int(b.num_voxels) == int(a.num_voxels)
    assert 0 < int(b.num_voxels) < 15 * 13 * 17


def test_morton_encode_matches_reference():
    c = np.random.default_rng(3).integers(-5, 1100, (4000, 3)).astype(np.int32)
    for bits in (4, 10):
        np.testing.assert_array_equal(tvg.morton_encode(torch.from_numpy(c), bits).numpy(),
                                      np.asarray(jvg.morton_encode(jnp.asarray(c), bits)))


@pytest.mark.parametrize("max_depth", [4, 10])
def test_octree_matches_reference(max_depth):
    pts, _, mask = _cloud(4)
    a = jvg.octree_from_point_cloud(jnp.asarray(pts), max_depth=max_depth, mask=jnp.asarray(mask))
    b = tvg.octree_from_point_cloud(torch.from_numpy(pts), max_depth=max_depth,
                                    mask=torch.from_numpy(mask))
    assert b.size == a.size and b.max_depth == a.max_depth
    np.testing.assert_array_equal(b.origin.numpy(), np.asarray(a.origin))
    np.testing.assert_array_equal(b.point_codes.numpy(), np.asarray(a.point_codes))
    np.testing.assert_array_equal(b.point_order.numpy(), np.asarray(a.point_order))
    assert [int(c) for c in b.level_counts] == [int(c) for c in a.level_counts]
    for x, y in zip(b.level_codes, a.level_codes):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    q = np.concatenate([pts, np.random.default_rng(5).uniform(-3, 3, (300, 3))]).astype(
        np.float32)
    leaf = b.locate_leaf(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(leaf, np.asarray(a.locate_leaf(jnp.asarray(q))))
    assert (leaf[:len(pts)][mask] >= 0).all()


def test_entry_points_default_to_the_card(monkeypatch):
    """Built from host arrays with no device named, grids and octrees go to
    the card, which is missing here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    for make in (lambda: tvg.create_from_point_cloud(pts, 1.0),
                 lambda: tvg.create_dense([0, 0, 0], [1, 1, 1], 1.0, 2.0, 2.0, 2.0),
                 lambda: tvg.octree_from_point_cloud(pts, max_depth=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tvg.create_from_point_cloud(torch.from_numpy(pts), 1.0).coords.device.type == "cpu"


# ---- tests/test_voxelgrid.py on the port ------------------------------------


def test_ref_create_from_point_cloud_dedup_and_color():
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [1.1, 0.1, 0.1]])
    cols = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    grid = tvg.create_from_point_cloud(pts, 1.0, colors=cols, origin=[0, 0, 0])
    assert int(grid.num_voxels) == 2
    valid = grid.valid.numpy()
    coords = grid.coords.numpy()[valid]
    assert {tuple(r) for r in coords.tolist()} == {(0, 0, 0), (1, 0, 0)}
    row0 = int(np.nonzero((coords == [0, 0, 0]).all(1))[0][0])
    np.testing.assert_allclose(grid.colors.numpy()[valid][row0], [0.5, 0.5, 0.0], atol=1e-6)


def test_ref_check_if_included():
    grid = tvg.create_from_point_cloud(torch.tensor([[0.5, 0.5, 0.5], [3.5, 0.5, 0.5]]), 1.0,
                                       origin=[0, 0, 0])
    inc = grid.check_if_included(torch.tensor([[0.7, 0.7, 0.7], [3.2, 0.2, 0.2],
                                               [2.5, 0.5, 0.5]])).numpy()
    np.testing.assert_array_equal(inc, [True, True, False])


def test_ref_create_dense_and_carve():
    grid = tvg.create_dense([0, 0, 0], [0.5, 0.5, 0.5], 0.5, 2.0, 2.0, 2.0, device="cpu")
    assert int(grid.num_voxels) == 4 * 4 * 4
    E = torch.tensor([[1, 0, 0, -1.0], [0, 1, 0, -1.0], [0, 0, 1, 2.0], [0, 0, 0, 1]])
    carved = tvg.carve_depth_map(grid, torch.full((48, 64), 2.75),
                                 TIntr(64, 48, 40.0, 40.0, 31.5, 23.5), E)
    assert int(carved.num_voxels) < 64
    centers = carved.get_voxel_centers().numpy()[carved.valid.numpy()]
    assert (centers[:, 2] > 0.5).all()


def test_ref_octree_build_and_locate():
    pts = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (256, 3)).astype(np.float32))
    tree = tvg.octree_from_point_cloud(pts, max_depth=4)
    counts = [int(c) for c in tree.level_counts]
    assert counts[0] <= 8 and all(a <= b for a, b in zip(counts, counts[1:]))
    assert (tree.locate_leaf(pts).numpy() >= 0).all()
    assert int(tree.locate_leaf(torch.tensor([[10.0, 10.0, 10.0]]))[0]) == -1


def test_ref_octree_respects_mask():
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9], [0.5, 0.5, 0.5]])
    tree = tvg.octree_from_point_cloud(pts, max_depth=2, mask=torch.tensor([True, True, False]))
    assert int(tree.locate_leaf(pts[2:3])[0]) == -1
