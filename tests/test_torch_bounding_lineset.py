"""Port parity: geometry/bounding_volume.py and geometry/lineset.py of
open3d_tpu_torch against open3d_tpu, on tests/test_bounding_lineset.py's
seeded clouds, one case a method.

Bars: every returned array within 1e-6 (boolean masks and line indices
equal); create_minimal's box and volume, and the PCA box's volume (a
product of three extents the two eigensolvers leave ~5e-7 apart), within
1e-5 (the convex hull is the same scipy call on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.geometry import bounding_volume as jbv
from open3d_tpu.geometry import lineset as jls
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch.geometry import bounding_volume as tbv
from open3d_tpu_torch.geometry import lineset as tls
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr

torch.set_num_threads(2)
TOL = 1e-6
CASES = {}


def case(name):
    def add(fn):
        CASES[name] = fn
        return fn
    return add


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == 2:
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _box_cloud(ext=(2.0, 1.0, 0.5), n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, 3)) * np.asarray(ext)).astype(np.float32)


def _same(port, ref, atol=TOL):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
        np.testing.assert_array_equal(p, r)
    else:
        np.testing.assert_allclose(p, r, rtol=0, atol=atol)


def _same_box(b, a, atol=TOL):
    fields = ("min_bound", "max_bound") if isinstance(a, jbv.AxisAlignedBoundingBox) else (
        "center", "rotation", "extent")
    for f in fields:
        _same(getattr(b, f), getattr(a, f), atol)


def _same_lineset(b, a):
    for f in ("points", "point_mask", "lines", "line_mask"):
        _same(getattr(b, f), getattr(a, f))
    for attrs in ("point_attrs", "line_attrs"):
        assert set(getattr(b, attrs)) == set(getattr(a, attrs))
        for k in getattr(a, attrs):
            _same(getattr(b, attrs)[k], getattr(a, attrs)[k])


def _rotated_cloud():
    R = _rot(2, 30)
    return _box_cloud() @ R.T + np.asarray([1.0, 2.0, 3.0], np.float32)


def _aabbs(mask=None):
    pts = np.concatenate([_box_cloud(), np.full((10, 3), 100.0, np.float32)])
    m = None if mask is None else np.arange(len(pts)) < 2000
    return (jbv.AxisAlignedBoundingBox.create_from_points(
                jnp.asarray(pts), None if m is None else jnp.asarray(m)),
            tbv.AxisAlignedBoundingBox.create_from_points(
                torch.from_numpy(pts), None if m is None else torch.from_numpy(m)), pts)


@case("aabb_create_and_queries")
def _aabb_queries():
    for mask in (None, True):
        a, b, pts = _aabbs(mask)
        _same_box(b, a)
        for name in ("get_center", "get_extent", "get_half_extent", "get_max_extent", "volume",
                     "get_box_points"):
            _same(getattr(b, name)(), getattr(a, name)())
        q = np.random.default_rng(3).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
        _same(b.contains(torch.from_numpy(q)), a.contains(jnp.asarray(q)))
        m = np.arange(500) % 3 > 0
        _same(b.get_point_indices_within_bounding_box(torch.from_numpy(q), torch.from_numpy(m)),
              a.get_point_indices_within_bounding_box(jnp.asarray(q), jnp.asarray(m)))


@case("aabb_transforms")
def _aabb_transforms():
    a, b, _ = _aabbs(True)
    _same_box(b.scale(1.5), a.scale(1.5))
    c = np.asarray([0.1, 0.2, -0.3], np.float32)
    _same_box(b.scale(0.5, torch.from_numpy(c)), a.scale(0.5, jnp.asarray(c)))
    for rel in (True, False):
        _same_box(b.translate(torch.from_numpy(c), rel), a.translate(jnp.asarray(c), rel))
    _same_box(b.get_oriented_bounding_box(), a.get_oriented_bounding_box())
    _same_box(tbv.OrientedBoundingBox.create_from_axis_aligned_bounding_box(b),
              jbv.OrientedBoundingBox.create_from_axis_aligned_bounding_box(a))


def _obbs():
    pts = _rotated_cloud()
    m = np.random.default_rng(4).uniform(size=len(pts)) > 0.1
    return (jbv.OrientedBoundingBox.create_from_points(jnp.asarray(pts), jnp.asarray(m)),
            tbv.OrientedBoundingBox.create_from_points(torch.from_numpy(pts), torch.from_numpy(m)),
            pts)


@case("obb_create_from_points_and_queries")
def _obb_queries():
    pts = _rotated_cloud()
    _same_box(tbv.OrientedBoundingBox.create_from_points(torch.from_numpy(pts)),
              jbv.OrientedBoundingBox.create_from_points(jnp.asarray(pts)))
    a, b, pts = _obbs()
    _same_box(b, a)
    # a product of three extents that the two eigensolvers leave ~5e-7
    # apart: 1.07e-6 measured, held at create_minimal's volume bar
    _same(b.volume(), a.volume(), 1e-5)
    _same(b.get_box_points(), a.get_box_points())
    _same(b.contains(torch.from_numpy(pts)), a.contains(jnp.asarray(pts)))
    m = np.arange(len(pts)) % 2 == 0
    _same(b.get_point_indices_within_bounding_box(torch.from_numpy(pts), torch.from_numpy(m)),
          a.get_point_indices_within_bounding_box(jnp.asarray(pts), jnp.asarray(m)))
    _same_box(b.get_axis_aligned_bounding_box(), a.get_axis_aligned_bounding_box())


@case("obb_transforms")
def _obb_transforms():
    a, b, _ = _obbs()
    R = _rot(0, 20) @ _rot(2, -35)
    c = np.asarray([0.5, -1.0, 0.25], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, c
    _same_box(b.rotate(torch.from_numpy(R)), a.rotate(jnp.asarray(R)))
    _same_box(b.rotate(torch.from_numpy(R), torch.from_numpy(c)),
              a.rotate(jnp.asarray(R), jnp.asarray(c)))
    for rel in (True, False):
        _same_box(b.translate(torch.from_numpy(c), rel), a.translate(jnp.asarray(c), rel))
    _same_box(b.transform(torch.from_numpy(T)), a.transform(jnp.asarray(T)))


@case("obb_create_minimal")
def _obb_minimal():
    # tests/test_bounding_lineset.py's L-shaped cloud, whose PCA axes are
    # not the minimal box's
    rng = np.random.default_rng(1)
    a = rng.uniform([0, 0, 0], [4, 1, 1], (1500, 3))
    b = rng.uniform([0, 0, 0], [1, 4, 1], (1500, 3))
    pts = (np.concatenate([a, b]) @ (_rot(2, 25) @ _rot(0, 10)).T).astype(np.float32)
    m = rng.uniform(size=len(pts)) > 0.05
    for mask in (None, m):
        ja = jbv.OrientedBoundingBox.create_minimal(
            jnp.asarray(pts), None if mask is None else jnp.asarray(mask))
        tb = tbv.OrientedBoundingBox.create_minimal(
            torch.from_numpy(pts), None if mask is None else torch.from_numpy(mask))
        _same(tb.volume(), ja.volume(), 1e-5)
        _same_box(tb, ja, 1e-5)
        assert float(tb.volume()) < 17.0  # the true box is 16
        keep = np.ones(len(pts), bool) if mask is None else mask
        assert tb.contains(torch.from_numpy(pts[keep])).float().mean() > 0.999


def _linesets():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    lines = rng.integers(0, 40, (25, 2)).astype(np.int32)
    pm = rng.uniform(size=40) > 0.1
    lm = rng.uniform(size=25) > 0.2
    pa = {"colors": rng.uniform(size=(40, 3)).astype(np.float32)}
    la = {"colors": rng.uniform(size=(25, 3)).astype(np.float32)}
    kw = dict(point_capacity=48, line_capacity=32)
    return (jls.LineSet.create(jnp.asarray(pts), jnp.asarray(lines), jnp.asarray(pm),
                               jnp.asarray(lm), pa, la, **kw),
            tls.LineSet.create(torch.from_numpy(pts), torch.from_numpy(lines),
                               torch.from_numpy(pm), torch.from_numpy(lm), pa, la, **kw))


@case("lineset_create_and_queries")
def _lineset_queries():
    a, b = _linesets()
    _same_lineset(b, a)
    for name in ("num_points", "num_lines", "get_min_bound", "get_max_bound", "line_lengths"):
        _same(getattr(b, name)(), getattr(a, name)())
    for x, y in zip(b.to_numpy(), a.to_numpy()):
        _same(x, y)
    # from host arrays: the port's device is named
    pts = np.zeros((2, 3), np.float32)
    pts[1, 0] = 2.0
    _same_lineset(tls.LineSet.create(pts, [[0, 1]], device="cpu"),
                  jls.LineSet.create(pts, [[0, 1]]))


@case("lineset_transforms")
def _lineset_transforms():
    a, b = _linesets()
    R = _rot(2, 40) @ _rot(0, -15)
    c = np.asarray([0.3, -0.2, 0.1], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, c
    _same_lineset(b.transform(torch.from_numpy(T)), a.transform(jnp.asarray(T)))
    for rel in (True, False):
        _same_lineset(b.translate(c, rel), a.translate(c, rel))
    for center in (None, c):
        _same_lineset(b.scale(1.7, center), a.scale(1.7, center))
        _same_lineset(b.rotate(torch.from_numpy(R), center), a.rotate(jnp.asarray(R), center))


@case("lineset_converters")
def _lineset_converters():
    ja, tb, _ = _aabbs(True)
    _same_lineset(tls.LineSet.from_bounding_box(tb), jls.LineSet.from_bounding_box(ja))
    jo, to, _ = _obbs()
    wire = tls.LineSet.from_bounding_box(to)
    _same_lineset(wire, jls.LineSet.from_bounding_box(jo))
    assert int(wire.num_lines()) == 12
    intr = (160, 120, 131.25, 131.25, 79.5, 59.5)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3], E[:3, 3] = _rot(0, 10), [0.1, 0.2, 1.5]
    for scale in (0.1, 0.4):
        _same_lineset(tls.LineSet.create_camera_visualization(TIntr(*intr), torch.from_numpy(E),
                                                              scale),
                      jls.LineSet.create_camera_visualization(JIntr(*intr), jnp.asarray(E), scale))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bounding_lineset(name):
    CASES[name]()
