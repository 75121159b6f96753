"""Port parity for voxel_block_grid.extract_triangle_mesh (marching
tetrahedra) on grids the JAX package integrated, carried across with
convert.vbg_from_numpy, against open3d_tpu on the same grid.

Bars: topology exact (triangles, vertex and triangle masks); vertices
(m) and colours (unit) within 1e-6: both packages interpolate the same
float32 values along the same canonical edge, where XLA on the CPU may
contract `a + f (b - a)` into a fused multiply-add. The block chunk does
not change the result at all.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg

torch.set_num_threads(2)
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_grid(res: int, with_color: bool):
    """3 frames fused by the JAX package; the no-colour grid is the colour
    grid's tsdf and weights with an empty colour payload."""
    if not with_color:
        g = _jax_grid(res, True)
        return dataclasses.replace(g, color=jnp.zeros((g.tw.shape[0], 0, 0), jnp.int32))
    ji = JIntr(*INTR)
    d, c, e, _ = jsyn.render_sequence(3, intrinsic=ji, span=0.3)
    voxel = 0.05 if res == 8 else 0.03
    g = jvbg.create(voxel_size=voxel, block_resolution=res, block_count=512)
    for i in range(3):
        keys, _ = jvbg.compute_unique_block_coordinates(g, d[i], ji, e[i], 3.0,
                                                        frame_block_capacity=512)
        g = jvbg.integrate(g, keys, d[i], c[i], ji, e[i], depth_max=3.0)
    return g


def _carry(gj):
    return convert.vbg_from_numpy(np.asarray(gj.table), np.asarray(gj.tw), np.asarray(gj.color),
                                  gj.voxel_size, gj.block_resolution, gj.sdf_trunc, device="cpu")


def _assert_same_mesh(mt, mj):
    np.testing.assert_array_equal(mt.triangles.numpy(), np.asarray(mj.triangles))
    np.testing.assert_array_equal(mt.vertex_mask.numpy(), np.asarray(mj.vertex_mask))
    np.testing.assert_array_equal(mt.triangle_mask.numpy(), np.asarray(mj.triangle_mask))
    np.testing.assert_allclose(mt.vertices.numpy(), np.asarray(mj.vertices), atol=TOL, rtol=0)
    assert mt.vertex_attrs.keys() == mj.vertex_attrs.keys()
    for k in mt.vertex_attrs:
        np.testing.assert_allclose(mt.vertex_attrs[k].numpy(), np.asarray(mj.vertex_attrs[k]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "soup"])
@pytest.mark.parametrize("with_color", [True, False], ids=["colour", "no_colour"])
@pytest.mark.parametrize("res", [8, 16])
def test_extraction_matches_reference(res, with_color, indexed):
    gj = _jax_grid(res, with_color)
    mj = jvbg.extract_triangle_mesh(gj, triangle_capacity=65536, weight_threshold=2.0,
                                    indexed=indexed)
    mt = tvbg.extract_triangle_mesh(_carry(gj), triangle_capacity=65536, weight_threshold=2.0,
                                    indexed=indexed)
    n = int(mt.num_triangles())
    assert 1000 < n < 65536, n  # the surface is there, and the capacity holds it
    assert ("colors" in mt.vertex_attrs) == with_color
    _assert_same_mesh(mt, mj)
    if indexed:  # shared vertices: well under the soup's 3 a triangle
        assert int(mt.num_vertices()) < 1.5 * n


@pytest.mark.parametrize("res", [8, 16])
def test_capacity_overflow_keeps_the_first_triangles(res):
    """Past triangle_capacity the scan's later triangles are dropped: the
    kept ones are the full extraction's first, in the same order."""
    gj = _jax_grid(res, True)
    full = tvbg.extract_triangle_mesh(_carry(gj), triangle_capacity=65536,
                                      weight_threshold=2.0, indexed=False)
    cap = int(full.num_triangles()) // 3
    mj = jvbg.extract_triangle_mesh(gj, triangle_capacity=cap, weight_threshold=2.0)
    mt = tvbg.extract_triangle_mesh(_carry(gj), triangle_capacity=cap, weight_threshold=2.0)
    assert int(mt.num_triangles()) == cap and bool(mt.triangle_mask.all())
    _assert_same_mesh(mt, mj)
    soup = tvbg.extract_triangle_mesh(_carry(gj), triangle_capacity=cap, weight_threshold=2.0,
                                      indexed=False)
    assert torch.equal(soup.vertices, full.vertices[:3 * cap])


@pytest.mark.parametrize("indexed", [True, False], ids=["indexed", "soup"])
def test_block_chunk_does_not_change_the_result(indexed):
    gt = _carry(_jax_grid(8, True))
    n = int(tvbg.extract_triangle_mesh(gt, weight_threshold=2.0, indexed=False).num_triangles())
    cap = n // 2 + 1  # the capacity cut falls inside a chunk
    out = [tvbg.extract_triangle_mesh(gt, triangle_capacity=cap, weight_threshold=2.0,
                                      block_chunk=g, indexed=indexed) for g in (1, 8, 64)]
    assert int(out[0].num_triangles()) == cap
    for m in out[1:]:
        for f in ("vertices", "triangles", "vertex_mask", "triangle_mask"):
            assert torch.equal(getattr(m, f), getattr(out[0], f)), f
        assert torch.equal(m.vertex_attrs["colors"], out[0].vertex_attrs["colors"])

