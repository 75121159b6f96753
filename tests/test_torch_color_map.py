"""Port parity: pipelines/color_map.py of open3d_tpu_torch against
open3d_tpu, on tests/test_color_map.py's setup (a textured plane seen by
three 160x120 cameras, two of them perturbed, from a numpy seed).

Bars: _prepare_images' masks and _visibility equal, the grey images and
their gradients within 1e-6. The rigid optimiser at 30 iterations: the
extrinsics within 1e-4, the vertex colours within 1e-3, the residual
history within 1e-3 relative. The non-rigid optimiser at 20 iterations and
8 anchors: the warp within 1e-3 px, the colours within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.pipelines import color_map as jcm
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.pipelines import color_map as tcm
from test_color_map import _setup

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)


@pytest.fixture(scope="module")
def scene():
    _, verts, grays, depths, bad, true = _setup()
    # a colour image from the grey texture, so the colour path is exercised
    colors = np.stack([np.asarray(grays), 0.5 * np.asarray(grays) + 0.2,
                       1.0 - np.asarray(grays)], axis=-1).astype(np.float32)
    return {k: np.asarray(v, np.float32) for k, v in dict(
        verts=verts, grays=grays, colors=colors, depths=depths, bad=bad, true=true).items()}


def _both(scene, *keys):
    return [jnp.asarray(scene[k]) for k in keys], [torch.from_numpy(scene[k]) for k in keys]


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("image", ["grays", "colors"])
def test_prepare_and_visibility(scene, image):
    (jc, jd, jv, je), (tc, td, tv, te) = _both(scene, image, "depths", "verts", "bad")
    opt = jcm.RigidOptimizerOption(image_boundary_margin=6)
    topt = tcm.RigidOptimizerOption(image_boundary_margin=6)
    a = jcm._prepare_images(jc, jd, opt)
    b = tcm._prepare_images(tc, td, topt)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    for f in ("gray", "dx", "dy", "depth"):
        _close(getattr(b, f), getattr(a, f), 1e-6)
    va = jcm._visibility(jv, a, je, JIntr(*INTR), opt)
    vb = tcm._visibility(tv, b, te, TIntr(*INTR), topt)
    np.testing.assert_array_equal(vb.numpy(), np.asarray(va))
    assert vb.shape == (scene["verts"].shape[0], 3) and 0.3 < float(vb.float().mean()) < 1.0


def test_rigid(scene):
    (jc, jd, jv, je), (tc, td, tv, te) = _both(scene, "colors", "depths", "verts", "bad")
    kw = dict(maximum_iteration=30, image_boundary_margin=6)
    ca, ea, ha = jcm.run_rigid_optimizer(jv, jc, jd, je, JIntr(*INTR),
                                         jcm.RigidOptimizerOption(**kw))
    cb, eb, hb = tcm.run_rigid_optimizer(tv, tc, td, te, TIntr(*INTR),
                                         tcm.RigidOptimizerOption(**kw))
    _close(eb, ea, 1e-4)
    _close(cb, ca, 1e-3)
    ha = np.asarray(ha)
    np.testing.assert_allclose(hb.numpy(), ha, rtol=1e-3, atol=0)
    assert hb[-1] < hb[0]


def test_non_rigid(scene):
    (jg, jd, jv, je), (tg, td, tv, te) = _both(scene, "grays", "depths", "verts", "bad")
    kw = dict(maximum_iteration=20, image_boundary_margin=6, number_of_vertical_anchors=8)
    ca, ea, wa = jcm.run_non_rigid_optimizer(jv, jg, jd, je, JIntr(*INTR),
                                             jcm.NonRigidOptimizerOption(**kw))
    cb, eb, wb = tcm.run_non_rigid_optimizer(tv, tg, td, te, TIntr(*INTR),
                                             tcm.NonRigidOptimizerOption(**kw))
    assert wb.shape == np.asarray(wa).shape == (3, 8, 11, 2)
    _close(eb, ea, 1e-4)
    _close(wb, wa, 1e-3)
    _close(cb, ca, 1e-3)
    assert float(wb.abs().max()) > 0.01  # the warp moved
