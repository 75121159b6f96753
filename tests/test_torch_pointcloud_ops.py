"""Port parity: ops/pointcloud.py of open3d_tpu_torch against open3d_tpu,
one case a ported name, on the same seeded numpy clouds built for both
packages from one numpy dict (convert.point_cloud_from_numpy on the port's
side).

Bars: masks, counts, row order and index results equal; voxel means
within 1e-6, covariances within 1e-5, colour gradients (a 3x3 solve)
within 1e-4, and cloud distances squared at the search's own bars (rtol
1e-5, atol 1e-6), as the two libraries order their additions apart;
normals up to sign, |n . n'| > 1 - 1e-5 on valid rows. The random
down-sample draws from a torch generator, not JAX's stream: its kept share
is held to the JAX package's within 0.03.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.ops import pointcloud as jops
from open3d_tpu_torch import convert
from open3d_tpu_torch.ops import pointcloud as tops

torch.set_num_threads(2)


def _surface(n=3000, seed=0, drop=0.1):
    """A bumpy height field with analytic unit normals (30 % of them
    flipped), colours and a few masked rows."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(2.0 * xy[:, 1])
    pos = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([-0.625 * np.cos(2.5 * xy[:, 0]) * np.cos(2.0 * xy[:, 1]),
                           0.5 * np.sin(2.5 * xy[:, 0]) * np.sin(2.0 * xy[:, 1]), np.ones(n)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nrm[rng.uniform(size=n) < 0.3] *= -1.0  # mixed orientation
    mask = rng.uniform(size=n) > drop
    pos[~mask] = 3e8
    return {"positions": pos, "mask": mask, "normals": nrm,
            "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)}


def _pair(arrays):
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jp = JPointCloud(positions=j.pop("positions"), mask=j.pop("mask"), attrs=j)
    return jp, convert.point_cloud_from_numpy(arrays, device="cpu")


def _close(port, ref, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=atol)


def _same_cloud(tp, jp, atol=1e-6):
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    _close(tp.positions.numpy(), np.asarray(jp.positions), atol)
    assert set(tp.attrs) == set(jp.attrs)


def _unsigned_normals_agree(port, ref, mask):
    dots = np.abs(np.sum(np.asarray(port) * np.asarray(ref), axis=-1))[mask]
    assert dots.min() > 1 - 1e-5, dots.min()


CASES = {}


def case(name):
    def register(fn):
        CASES[name] = fn
        return fn
    return register


@case("voxel_down_sample")
def _voxel_down_sample():
    arrays = _surface(4000)
    jp, tp = _pair(arrays)
    for voxel, cap in ((0.08, None), (0.05, 1000)):
        a, b = jops.voxel_down_sample(jp, voxel, cap), tops.voxel_down_sample(tp, voxel, cap)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))  # count and layout
        assert b.capacity == (cap or 4000) and 0 < int(b.count()) <= b.capacity
        _same_cloud(b, a)  # equal row order: positions agree row for row
        for k in ("normals", "colors"):
            _close(b.attrs[k].numpy(), np.asarray(a.attrs[k]))


@case("random_down_sample")
def _random_down_sample():
    jp, tp = _pair(_surface())
    gen = torch.Generator().manual_seed(5)
    b = tops.random_down_sample(tp, 0.3, gen)
    a = jops.random_down_sample(jp, 0.3, jax.random.PRNGKey(5))
    draw = torch.rand((tp.capacity,), generator=torch.Generator().manual_seed(5)) < 0.3
    assert torch.equal(b.mask, tp.mask & draw)
    share = float(b.count()) / float(tp.count())
    assert abs(share - 0.3) < 0.03 and abs(share - float(a.count()) / float(jp.count())) < 0.03


@case("uniform_down_sample")
def _uniform_down_sample():
    jp, tp = _pair(_surface())
    _same_cloud(tops.uniform_down_sample(tp, 7), jops.uniform_down_sample(jp, 7), 0.0)


@case("farthest_point_down_sample")
def _farthest_point_down_sample():
    jp, tp = _pair(_surface(1200))
    b, a = tops.farthest_point_down_sample(tp, 60), jops.farthest_point_down_sample(jp, 60)
    assert int(b.count()) == 60
    _same_cloud(b, a, 0.0)


@case("gather_neighbors")
def _gather_neighbors():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(50, 3)).astype(np.float32)
    idx = rng.integers(-3, 50, (20, 6)).astype(np.int32)
    _close(tops.gather_neighbors(torch.from_numpy(vals), torch.from_numpy(idx), fill=-2.0).numpy(),
           jops.gather_neighbors(jnp.asarray(vals), jnp.asarray(idx), fill=-2.0), 0.0)
    _close(tops.gather_neighbors(torch.from_numpy(vals[:, 0]), torch.from_numpy(idx)).numpy(),
           jops.gather_neighbors(jnp.asarray(vals[:, 0]), jnp.asarray(idx)), 0.0)


@pytest.mark.parametrize("kw", [dict(max_nn=20), dict(max_nn=16, radius=0.15),
                                dict(max_nn=16, radius=0.15, nns_grid_threshold=1000)],
                         ids=["knn", "hybrid", "grid"])
def test_estimate_normals(kw):
    arrays = _surface(2500, seed=2)
    jp, tp = _pair(arrays)
    b, a = tops.estimate_normals(tp, **kw), jops.estimate_normals(jp, **kw)
    m = arrays["mask"]
    _unsigned_normals_agree(b.attrs["normals"].numpy(), a.attrs["normals"], m)
    assert float(b.attrs["normals"][~torch.from_numpy(m)].abs().max()) == 0.0
    # and the surface's own normals, up to sign (a smooth, densely sampled patch)
    dots = np.abs(np.sum(b.attrs["normals"].numpy() * arrays["normals"], -1))[m]
    assert np.median(dots) > 0.99


@case("estimate_covariances")
def _estimate_covariances():
    jp, tp = _pair(_surface(2000, seed=3))
    for kw in (dict(max_nn=12), dict(max_nn=12, radius=0.2)):
        b, a = tops.estimate_covariances(tp, **kw), jops.estimate_covariances(jp, **kw)
        _close(b.attrs["covariances"].numpy(), a.attrs["covariances"], 1e-5)


@case("orient_normals_to_align_with_direction")
def _orient_direction():
    jp, tp = _pair(_surface())
    for d in ((0.0, 0.0, 1.0), (0.3, -1.0, 0.2)):
        b = tops.orient_normals_to_align_with_direction(tp, d)
        a = jops.orient_normals_to_align_with_direction(jp, d)
        _close(b.attrs["normals"].numpy(), a.attrs["normals"], 0.0)


@case("orient_normals_towards_camera_location")
def _orient_camera():
    jp, tp = _pair(_surface())
    for c in ((0.0, 0.0, 0.0), (0.5, 2.0, -3.0)):
        b = tops.orient_normals_towards_camera_location(tp, c)
        a = jops.orient_normals_towards_camera_location(jp, c)
        _close(b.attrs["normals"].numpy(), a.attrs["normals"], 0.0)


@case("estimate_color_gradients")
def _estimate_color_gradients():
    jp, tp = _pair(_surface(2000, seed=4))
    for kw in (dict(max_nn=16), dict(max_nn=16, radius=0.15)):
        b, a = tops.estimate_color_gradients(tp, **kw), jops.estimate_color_gradients(jp, **kw)
        g_t, g_j = b.attrs["color_gradients"].numpy(), np.asarray(a.attrs["color_gradients"])
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="normals"):
        tops.estimate_color_gradients(tp.with_attrs(normals=None))


@case("remove_statistical_outliers")
def _remove_statistical_outliers():
    arrays = _surface(2000, seed=5)
    arrays["positions"][:40] += np.float32(0.4)  # lifted off the surface
    jp, tp = _pair(arrays)
    b, a = tops.remove_statistical_outliers(tp, 12, 1.5), jops.remove_statistical_outliers(jp, 12, 1.5)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    assert int(b.count()) < int(tp.count())


@case("remove_radius_outliers")
def _remove_radius_outliers():
    jp, tp = _pair(_surface(2000, seed=6))
    b, a = tops.remove_radius_outliers(tp, 6, 0.07), jops.remove_radius_outliers(jp, 6, 0.07)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    assert 0 < int(b.count()) < int(tp.count())


@case("compute_point_cloud_distance")
def _compute_point_cloud_distance():
    js, ts = _pair(_surface(1500, seed=7))
    jt, tt = _pair(_surface(1800, seed=8))
    # squared, to the brute-force search's bars (its d2 carries the float32
    # cancellation of |q|^2 + |t|^2 - 2 q.t, which a square root magnifies)
    b = tops.compute_point_cloud_distance(ts, tt).numpy().astype(np.float64)
    a = np.asarray(jops.compute_point_cloud_distance(js, jt), np.float64)
    np.testing.assert_allclose(b**2, a**2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b == 0, a == 0)


@case("orient_normals_consistent_tangent_plane")
def _orient_consistent():
    jp, tp = _pair(_surface(1500, seed=9))
    b = tops.orient_normals_consistent_tangent_plane(tp, k=10)
    a = jops.orient_normals_consistent_tangent_plane(jp, k=10)
    _close(b.attrs["normals"].numpy(), a.attrs["normals"], 0.0)
    # the height field's normals all end up on one side
    n = b.attrs["normals"].numpy()[tp.mask.numpy()]
    assert min((n[:, 2] > 0).mean(), (n[:, 2] < 0).mean()) < 0.01
    c = tops.orient_normals_consistent_tangent_plane(tp, k=10, max_sweeps=2)
    d = jops.orient_normals_consistent_tangent_plane(jp, k=10, max_sweeps=2)
    _close(c.attrs["normals"].numpy(), d.attrs["normals"], 0.0)


@case("compute_boundary_points")
def _compute_boundary_points():
    arrays = _surface(2000, seed=10)
    jp, tp = _pair(arrays)
    b = tops.compute_boundary_points(tp, 0.12, max_nn=24).numpy()
    a = np.asarray(jops.compute_boundary_points(jp, 0.12, max_nn=24))
    np.testing.assert_array_equal(b, a)
    # the patch's rim is mostly boundary, its inside mostly not
    rim = (np.abs(arrays["positions"][:, :2]).max(1) > 0.97) & arrays["mask"]
    assert b[rim].mean() > 0.9 and b[~rim & arrays["mask"]].mean() < 0.3


@case("pca_partition")
def _pca_partition():
    jp, tp = _pair(_surface(1500, seed=11))
    for max_points in (200, 2000):
        nb, ib = tops.pca_partition(tp, max_points)
        na, ia = jops.pca_partition(jp, max_points)
        assert int(nb) == int(na)
        np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
        counts = np.bincount(ib.numpy()[ib.numpy() >= 0])
        assert counts.max() <= max_points and len(counts) == int(nb)


@case("voxel_boundaries_of_the_synthetic_room")
def _voxel_boundaries():
    """The synthetic room's walls and floor lie on multiples of 0.02 m, so
    voxel_down_sample's count at the ICP cell's voxel hangs on the last ulp
    of the unprojection: moving every coordinate of bench.py's first ICP
    frame (at 160x120) by one ulp changes the voxel of over 1 % of its
    points. Both packages agree on one cloud; their clouds from one depth
    image (two libraries' matmuls) need not give one count."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.rgbd import pointcloud_from_depth

    d, _, e, intr = synthetic.render_sequence(1, span=0.15, device="cpu")
    pcd = pointcloud_from_depth(d[0], intr, e[0])
    pos = pcd.positions.numpy()[pcd.mask.numpy()]
    nudged = np.nextafter(pos, np.float32(np.inf))
    moved = np.any(np.floor(pos / np.float32(0.02)) != np.floor(nudged / np.float32(0.02)), axis=1)
    assert moved.mean() > 0.01
    jp, tp = _pair(convert.point_cloud_to_numpy(pcd))
    _same_cloud(tops.voxel_down_sample(tp, 0.02), jops.voxel_down_sample(jp, 0.02), 0.0)


@case("convert_carries_every_attribute")
def _convert_round_trip():
    arrays = _surface(64)
    rng = np.random.default_rng(12)
    arrays.update(covariances=rng.normal(size=(64, 3, 3)).astype(np.float32),
                  color_gradients=rng.normal(size=(64, 3)).astype(np.float32),
                  dopplers=rng.normal(size=64).astype(np.float32),
                  directions=rng.normal(size=(64, 3)).astype(np.float32))
    back = convert.point_cloud_to_numpy(convert.point_cloud_from_numpy(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op(name):
    CASES[name]()
