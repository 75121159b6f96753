"""Port parity: ops/segmentation.py of open3d_tpu_torch against open3d_tpu,
on tests/test_segmentation.py's seeded scenes.

Bars: segment_plane with the JAX package's draws put in through the port's
`_plane_draws` seam: the plane within 1e-5 and the inliers equal; with the
port's own draws, the JAX test's outcome bars. cluster_dbscan's labels,
the ISS keypoint masks, compute_convex_hull's arrays, hidden_point_removal's
indices and detect_planar_patches' labels and patch count equal; its boxes'
centres and extents within 1e-5, their rotations within 1e-4 (a square
patch's two in-plane axes are ill-conditioned). Both packages get the same
normals (the JAX package's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.ops import pointcloud as jops
from open3d_tpu.ops import segmentation as jseg
from open3d_tpu_torch.geometry.pointcloud import PointCloud as TPointCloud
from open3d_tpu_torch.ops import segmentation as tseg

torch.set_num_threads(2)


def _plane_plus_noise(seed=0, n_plane=600, n_noise=120):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n_plane, 2))
    plane = np.column_stack([xy, 0.02 * np.ones(n_plane)])  # z = 0.02
    noise = rng.uniform(-1, 1, (n_noise, 3)) + np.array([0, 0, 1.5])
    return np.vstack([plane, noise]).astype(np.float32), n_plane


def _jax_draws(num_iterations, seed, device):
    d = jax.random.randint(jax.random.PRNGKey(seed), (num_iterations, 3), 0, 2**31 - 1)
    return torch.from_numpy(np.asarray(d).astype(np.int64)).to(device)


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "masked"])
def test_segment_plane_with_jax_draws(monkeypatch, masked):
    pts, n_plane = _plane_plus_noise()
    mask = np.ones(len(pts), bool)
    if masked:  # the plane masked out: the winner comes from the noise block
        mask[:n_plane] = False
    kw = dict(distance_threshold=0.05 if masked else 0.01, num_iterations=64, seed=3)
    a_plane, a_in = jseg.segment_plane(jnp.asarray(pts), jnp.asarray(mask), **kw)
    monkeypatch.setattr(tseg, "_plane_draws", _jax_draws)
    b_plane, b_in = tseg.segment_plane(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(b_plane.numpy(), np.asarray(a_plane), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b_in.numpy(), np.asarray(a_in))


def test_segment_plane_own_draws():
    """tests/test_segmentation.py's bars with the port's generator."""
    pts, n_plane = _plane_plus_noise()
    plane, inliers = tseg.segment_plane(torch.from_numpy(pts), distance_threshold=0.01,
                                        num_iterations=64)
    plane, inliers = plane.numpy(), inliers.numpy()
    assert abs(abs(plane[2]) - 1.0) < 1e-3
    assert abs(plane[3] + np.sign(plane[2]) * 0.02) < 5e-3
    assert inliers[:n_plane].mean() > 0.99 and inliers[n_plane:].mean() < 0.05


def _blobs():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 0.05, (120, 3))
    b = rng.normal(0, 0.05, (150, 3)) + np.array([5.0, 0, 0])
    return np.vstack([a, b, [[50.0, 50.0, 50.0]]]).astype(np.float32)


def _chain():
    return np.column_stack([np.linspace(0, 9.9, 100), np.zeros(100), np.zeros(100)]).astype(
        np.float32)


@pytest.mark.parametrize("scene", [
    (_blobs, 0.5, 5, None), (_chain, 0.15, 2, None), (_blobs, 0.08, 6, 200),
], ids=["blobs", "chain", "blobs_tight_masked"])
def test_cluster_dbscan(scene):
    make, eps, min_points, n_keep = scene
    pts = make()
    mask = None if n_keep is None else np.arange(len(pts)) < n_keep
    a = jseg.cluster_dbscan(jnp.asarray(pts), eps=eps, min_points=min_points,
                            mask=None if mask is None else jnp.asarray(mask))
    b = tseg.cluster_dbscan(torch.from_numpy(pts), eps=eps, min_points=min_points,
                            mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert b.dtype == torch.int32


def _corner_cloud():
    """Three faces of a cube meeting at a corner, and a flat plane's worth
    of interior points: salient at the corner and edges only."""
    rng = np.random.default_rng(2)
    g = np.linspace(0, 1, 12)
    xx, yy = np.meshgrid(g, g)
    faces = [np.column_stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)]),
             np.column_stack([xx.ravel(), np.zeros(xx.size), yy.ravel()]),
             np.column_stack([np.zeros(xx.size), xx.ravel(), yy.ravel()])]
    pts = np.concatenate(faces) + rng.normal(0, 0.003, (3 * xx.size, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("radii", [(0.3, 0.2), (0.0, 0.0)], ids=["given", "from_resolution"])
def test_iss_keypoints(radii):
    pts = _corner_cloud()
    mask = np.random.default_rng(5).uniform(size=len(pts)) > 0.05
    kw = dict(salient_radius=radii[0], non_max_radius=radii[1], min_neighbors=4)
    a = jseg.compute_iss_keypoints(jnp.asarray(pts), jnp.asarray(mask), **kw)
    b = tseg.compute_iss_keypoints(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_convex_hull_and_hidden_point_removal():
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    interior = np.random.default_rng(3).uniform(0.2, 0.8, (50, 3)).astype(np.float32)
    pts = np.vstack([corners, interior])
    mask = np.arange(len(pts)) != 20
    for m in (None, mask):
        for x, y in zip(tseg.compute_convex_hull(torch.from_numpy(pts), m),
                        jseg.compute_convex_hull(pts, m)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(4)
    v = rng.normal(size=(500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    vm = rng.uniform(size=500) > 0.1
    for m in (None, vm):
        b = tseg.hidden_point_removal(torch.from_numpy(v.astype(np.float32)), [0, 0, 4.0], 100.0,
                                      m)
        a = jseg.hidden_point_removal(v.astype(np.float32), [0, 0, 4.0], 100.0, m)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


def test_detect_planar_patches():
    rng = np.random.default_rng(1)
    g = np.linspace(0, 1, 24, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    floor = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size, np.float32)], -1)
    wall = np.stack([xx.ravel(), np.zeros(xx.size, np.float32) - 0.2, yy.ravel() + 0.2], -1)
    pts = np.concatenate([floor, wall]) + rng.normal(0, 0.002, (2 * xx.size, 3)).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.03
    jp = jops.estimate_normals(JPointCloud.create(jnp.asarray(pts), mask=jnp.asarray(mask)),
                               max_nn=12)
    tp = TPointCloud(positions=torch.from_numpy(np.asarray(jp.positions)),
                     mask=torch.from_numpy(np.asarray(jp.mask)),
                     attrs={"normals": torch.from_numpy(np.asarray(jp.attrs["normals"]))})
    kw = dict(distance_threshold=0.02, min_num_points=100, max_patches=8)
    la, oa, na = jseg.detect_planar_patches(jp, **kw)
    lb, ob, nb = tseg.detect_planar_patches(tp, **kw)
    assert int(nb) == int(na) == 2
    np.testing.assert_array_equal(lb.numpy(), np.asarray(la))
    # a square patch's in-plane covariance has two near-equal eigenvalues,
    # so its in-plane axes turn with the rounding (1.1e-5 measured): the
    # rotation within 1e-4, the centre and extent within 1e-5
    for f, tol in (("center", 1e-5), ("rotation", 1e-4), ("extent", 1e-5)):
        np.testing.assert_allclose(getattr(ob, f).numpy()[:2], np.asarray(getattr(oa, f))[:2],
                                   rtol=0, atol=tol, err_msg=f)
    with pytest.raises(ValueError, match="normals"):
        tseg.detect_planar_patches(TPointCloud(tp.positions, tp.mask, {}))
