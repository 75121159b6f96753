"""Port parity: the intensity and hybrid odometry of open3d_tpu_torch against
open3d_tpu, the image functions they need, the odometry information matrix,
and the default method.

Tolerances: image functions atol 1e-5 (the same float32 formulas; sums and
exp may round differently). Odometry: T within 1e-4 of the JAX T (the
(6, HW) @ (HW, 6) products sum in another order; the Gauss-Newton loop
takes the same steps). Information matrix: relative 1e-4 of its largest
entry (a sum over ~10^4 pixels in another order).
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
from open3d_tpu_torch.geometry import image as tim
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.geometry.rgbd import RGBDImage as TRGBD
from open3d_tpu_torch.pipelines import odometry as todo

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
ATOL = 1e-5
T_TOL = 1e-4
INFO_RTOL = 1e-4


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
    return [np.asarray(x) for x in (d0, c0, d1, c1)] + [T_gt]


def test_image_functions(pair):
    _, c0, _, _, _ = pair
    rng = np.random.default_rng(2)
    _close(jim.rgb_to_gray(c0), tim.rgb_to_gray(_t(c0)))
    gray = np.asarray(jim.rgb_to_gray(c0))
    for ks, sigma in [(3, 1.0), (5, 1.5)]:
        _close(jim.filter_gaussian(gray, ks, sigma), tim.filter_gaussian(_t(gray), ks, sigma))
    _close(jim.filter_gaussian(c0, 3, 1.0), tim.filter_gaussian(_t(c0), 3, 1.0))
    _close(jim.pyrdown(gray), tim.pyrdown(_t(gray)))
    for a, b in zip(jim.build_intensity_pyramid(c0, 3), tim.build_intensity_pyramid(_t(c0), 3)):
        _close(a, b)
    # samples inside, on and beyond the border
    uv = np.stack([rng.uniform(-2, 162, 4000), rng.uniform(-2, 122, 4000)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [159, 119], [159.0, 60.5], [-0.0, 119.0]]
    _close(jim.bilinear_sample(gray, uv), tim.bilinear_sample(_t(gray), _t(uv)))
    _close(jim.bilinear_sample(c0, uv, 0.5), tim.bilinear_sample(_t(c0), _t(uv), 0.5))
    stack = np.stack([pair[0], gray], -1)
    for img in (gray, stack):
        for a, b in zip(jim.bilinear_sample_with_grad(img, uv), tim.bilinear_sample_with_grad(_t(img), _t(uv))):
            _close(a, b)


@pytest.mark.parametrize("method", [jodo.INTENSITY, jodo.HYBRID])
def test_odometry_method_matches_jax(pair, method):
    d0, c0, d1, c1, T_gt = pair
    rj = jodo.rgbd_odometry_multi_scale(JRGBD(c0, d0), JRGBD(c1, d1), JIntr(*INTR), method=method)
    rt = todo.rgbd_odometry_multi_scale(
        TRGBD(_t(c0), _t(d0)), TRGBD(_t(c1), _t(d1)), TIntr(*INTR), method=method
    )
    np.testing.assert_allclose(np.asarray(rj.transformation), rt.transformation.numpy(), atol=T_TOL)
    assert abs(float(rj.fitness) - float(rt.fitness)) < 1e-4
    rot, trans = tlie.pose_distance(rt.transformation, _t(T_gt))
    assert float(trans) < 0.01 and float(rot) < 0.01


def test_default_method_is_hybrid_in_both(pair):
    """The repair: a caller that relies on the default gets the same pose from
    both packages, and that default is HYBRID."""
    d0, c0, d1, c1, _ = pair
    rj = jodo.rgbd_odometry_multi_scale(JRGBD(c0, d0), JRGBD(c1, d1), JIntr(*INTR))
    rt = todo.rgbd_odometry_multi_scale(TRGBD(_t(c0), _t(d0)), TRGBD(_t(c1), _t(d1)), TIntr(*INTR))
    np.testing.assert_allclose(np.asarray(rj.transformation), rt.transformation.numpy(), atol=T_TOL)
    rh = todo.rgbd_odometry_multi_scale(
        TRGBD(_t(c0), _t(d0)), TRGBD(_t(c1), _t(d1)), TIntr(*INTR), method=todo.HYBRID
    )
    assert torch.equal(rh.transformation, rt.transformation)


def test_information_matrix(pair):
    d0, _, d1, _, T_gt = pair
    T = np.asarray(jlie.se3_exp(jnp.asarray([0.002, -0.001, 0.003, 0.004, 0.0, -0.002]))) @ T_gt
    T = T.astype(np.float32)
    ij = np.asarray(jodo.compute_odometry_information_matrix(d0, d1, JIntr(*INTR), T))
    it = todo.compute_odometry_information_matrix(_t(d0), _t(d1), TIntr(*INTR), _t(T)).numpy()
    assert ij[5, 5] > 1000  # thousands of associated pixels
    np.testing.assert_allclose(it, ij, atol=INFO_RTOL * np.abs(ij).max(), rtol=0)
    np.testing.assert_allclose(it, it.T, atol=1e-6 * np.abs(it).max())
