"""Port parity: depth image ops, synthetic rendering and point-to-plane
odometry of open3d_tpu_torch against open3d_tpu.

Tolerances: image ops atol 1e-5 (the same float32 formulas; exp and sums
may round differently). Odometry: the port's T within 1e-3 of the JAX T
(the (6, HW) @ (HW, 6) sums run in another order), and both recover the
true pose to the JAX package's own bars (tests/test_odometry.py: rotation
and translation error < 0.01, fitness > 0.5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import image as jim
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.geometry.rgbd import RGBDImage as JRGBD
from open3d_tpu.pipelines import odometry as jodo
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry import image as tim
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.geometry.rgbd import RGBDImage as TRGBD
from open3d_tpu_torch.pipelines import odometry as todo

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """Two frames 3 cm apart (tests/test_odometry.py's render_pair)."""
    e0 = jsyn.look_at((1.2, 0.3, 0.0), (0.0, 0.8, 0.0))
    e1 = jsyn.look_at((1.17, 0.315, 0.03), (0.02, 0.8, 0.0))
    d0, c0 = jsyn.render_depth(jsyn.default_scene_sdf, JIntr(*INTR), e0)
    d1, c1 = jsyn.render_depth(jsyn.default_scene_sdf, JIntr(*INTR), e1)
    T_gt = np.asarray(e1 @ jnp.linalg.inv(e0))
    return [np.asarray(x) for x in (d0, c0, d1, c1, e0)] + [T_gt]


@pytest.fixture(scope="module")
def noisy_depth(pair):
    rng = np.random.default_rng(1)
    d = pair[0].copy()
    d[rng.random(d.shape) < 0.05] = 0.0  # holes
    return d


def test_clip_transform_and_shift(noisy_depth):
    raw = (noisy_depth * 1000.0).astype(np.uint16)
    _close(jim.clip_transform(raw, 1000.0, 0.3, 2.5), tim.clip_transform(_t(raw), 1000.0, 0.3, 2.5))
    for dy, dx in [(1, -2), (-3, 0), (0, 5)]:
        _close(jim._shift2d(noisy_depth, dy, dx), tim._shift2d(_t(noisy_depth), dy, dx))


@pytest.mark.parametrize("fn", ["pyrdown_depth", "filter_bilateral_depth", "erode_mask"])
def test_depth_filters(fn, noisy_depth):
    d = noisy_depth
    if fn == "erode_mask":
        np.testing.assert_array_equal(
            np.asarray(jim.erode_mask(jnp.asarray(d > 0), 1)), tim.erode_mask(_t(d > 0), 1).numpy()
        )
        return
    _close(getattr(jim, fn)(d), getattr(tim, fn)(_t(d)))


def test_vertex_normal_maps_and_pyramids(noisy_depth):
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jim.create_vertex_map(noisy_depth, ji)
    vt = tim.create_vertex_map(_t(noisy_depth), ti)
    _close(vj, vt)
    nj = jim.create_normal_map(vj)
    nt = tim.create_normal_map(vt)
    _close(nj, nt, 1e-4)
    for a, b in zip(jim.build_depth_pyramid(noisy_depth, 3), tim.build_depth_pyramid(_t(noisy_depth), 3)):
        _close(a, b)
    for a, b in zip(jim.build_normal_pyramid(nj, 3), tim.build_normal_pyramid(_t(np.asarray(nj)), 3)):
        _close(a, b, 1e-4)


def test_synthetic_render_matches(pair):
    """The port's renderer against the JAX package's on the same pose."""
    e0 = pair[4]
    dt, ct = tsyn.render_depth(tsyn.default_scene_sdf, TIntr(*INTR), _t(e0))
    dj = pair[0]
    np.testing.assert_array_equal(dj > 0, dt.numpy() > 0)
    both = dj > 0
    assert np.abs(dj - dt.numpy())[both].max() < 1e-4
    assert np.abs(pair[1] - ct.numpy())[both].max() < 1e-4
    ej = np.asarray(jsyn.orbit_trajectory(5, span=0.4))
    _close(ej, tsyn.orbit_trajectory(5, span=0.4, device="cpu"), 1e-6)


def test_point_to_plane_odometry(pair):
    d0, c0, d1, c1, _, T_gt = pair
    rj = jodo.rgbd_odometry_multi_scale(
        JRGBD(c0, d0), JRGBD(c1, d1), JIntr(*INTR), method=jodo.POINT_TO_PLANE
    )
    rt = todo.rgbd_odometry_multi_scale(
        TRGBD(_t(c0), _t(d0)), TRGBD(_t(c1), _t(d1)), TIntr(*INTR), method=todo.POINT_TO_PLANE
    )
    np.testing.assert_allclose(np.asarray(rj.transformation), rt.transformation.numpy(), atol=1e-3)
    assert abs(float(rj.fitness) - float(rt.fitness)) < 1e-3
    for rot, trans, fit in [
        (*jlie.pose_distance(rj.transformation, T_gt), rj.fitness),
        (*tlie.pose_distance(rt.transformation, _t(T_gt)), rt.fitness),
    ]:
        assert float(trans) < 0.01 and float(rot) < 0.01 and float(fit) > 0.5


@pytest.mark.parametrize("method", [todo.INTENSITY, todo.HYBRID])
def test_unported_odometry_methods_raise(pair, method):
    """INTENSITY and HYBRID are ported now (tests/test_torch_odometry_hybrid.py
    holds them against JAX): each runs on a frame pair, and a method name
    that neither package knows raises."""
    d0, c0 = _t(pair[0]), _t(pair[1])
    r = todo.rgbd_odometry_multi_scale(TRGBD(c0, d0), TRGBD(c0, d0), TIntr(*INTR), method=method)
    assert float(r.fitness) > 0.5
    with pytest.raises(ValueError):
        todo.rgbd_odometry_multi_scale(
            TRGBD(c0, d0), TRGBD(c0, d0), TIntr(*INTR), method=method + "_unported"
        )
