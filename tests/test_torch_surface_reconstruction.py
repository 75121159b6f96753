"""Port parity: pipelines/surface_reconstruction.py of open3d_tpu_torch
against open3d_tpu, on tests/test_surface_reconstruction.py's seeded
sphere and cube clouds.

Bars: marching_tetrahedra_dense's soup: the triangle mask and order equal
and the live triangles' vertices within 1e-6 (the JAX package fills the
unused rows with its dead slots' vertices, the port with zeros); the
chunked marching equal to the unchunked one bit for bit. Poisson at depths
5 and 6: chi within 1e-4 x max|chi|, the origin and spacing within 1e-6,
the iso level within 1e-5. reconstruct_alpha_shape's arrays equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.pipelines import surface_reconstruction as jsr
from open3d_tpu_torch.pipelines import surface_reconstruction as tsr

torch.set_num_threads(2)


def _sphere_cloud(n=2000, r=0.5, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (r * v).astype(np.float32), v.astype(np.float32)


def _field(shape=(20, 24, 28), seed=0):
    """A sphere's SDF on a box grid, with noise so cases of every kind occur."""
    g = [(np.arange(s) + 0.5) / s - 0.5 for s in shape]
    xx, yy, zz = np.meshgrid(*g, indexing="ij")
    sdf = np.sqrt(xx**2 + yy**2 + zz**2) - 0.3
    return (sdf + np.random.default_rng(seed).normal(0, 0.01, shape)).astype(np.float32)


def _same_soup(b, a):
    tm = np.asarray(a.triangle_mask)
    np.testing.assert_array_equal(b.triangle_mask.numpy(), tm)
    np.testing.assert_array_equal(b.triangles.numpy(), np.asarray(a.triangles))
    vm = np.repeat(tm, 3)
    np.testing.assert_allclose(b.vertices.numpy()[vm], np.asarray(a.vertices)[vm], rtol=0,
                               atol=1e-6)
    return int(tm.sum())


@pytest.mark.parametrize("capacity", [65536, 700], ids=["whole", "clipped"])
def test_marching_tetrahedra_dense(capacity):
    f = _field()
    kw = dict(iso=0.01, origin=(-0.5, -0.4, -0.3), spacing=0.04, triangle_capacity=capacity)
    a = jsr.marching_tetrahedra_dense(jnp.asarray(f), **kw)
    b = tsr.marching_tetrahedra_dense(torch.from_numpy(f), **kw)
    n = _same_soup(b, a)
    assert n == min(capacity, n) and n > 600
    # the case pass over slabs of 1 000 cubes, the build in batches of 97
    c = tsr._marching(torch.from_numpy(f), kw["iso"], kw["origin"], kw["spacing"], capacity,
                      1000, 97)
    for k in ("vertices", "triangles", "vertex_mask", "triangle_mask"):
        assert torch.equal(getattr(c, k), getattr(b, k)), k


def _iso(chi, positions, origin, spacing):
    n = chi.shape[0]
    g = (positions - origin) / spacing - 0.5
    gi = np.clip(np.round(g).astype(np.int64), 0, n - 1)
    return float(chi[gi[:, 0], gi[:, 1], gi[:, 2]].mean())


@pytest.mark.parametrize("depth", [5, 6])
def test_poisson_fft(depth):
    pts, nrm = _sphere_cloud()
    mask = np.random.default_rng(1).uniform(size=len(pts)) > 0.05
    ma, chi_a, org_a, sp_a = jsr.reconstruct_poisson_fft(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask), depth=depth,
        triangle_capacity=65536)
    mb, chi_b, org_b, sp_b = tsr.reconstruct_poisson_fft(
        torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(mask), depth=depth,
        triangle_capacity=65536)
    chi_a = np.asarray(chi_a)
    assert chi_b.shape == chi_a.shape == (1 << depth,) * 3
    np.testing.assert_allclose(chi_b.numpy(), chi_a, rtol=0, atol=1e-4 * np.abs(chi_a).max())
    np.testing.assert_allclose(org_b.numpy(), np.asarray(org_a), rtol=0, atol=1e-6)
    assert abs(float(sp_b) - float(sp_a)) <= 1e-6
    kept = pts[mask]
    iso_a = _iso(chi_a, kept, np.asarray(org_a), float(sp_a))
    iso_b = _iso(chi_b.numpy(), kept, org_b.numpy(), float(sp_b))
    assert abs(iso_b - iso_a) <= 1e-5
    # the mesh: a shell near r = 0.5, as tests/test_surface_reconstruction.py asks
    tm = mb.triangle_mask.numpy()
    assert tm.sum() > 300
    rad = np.linalg.norm(mb.vertices.numpy()[mb.triangles.numpy()[tm].ravel()], axis=1)
    assert abs(rad.mean() - 0.5) < 0.08 and rad.std() < 0.05
    assert abs(int(tm.sum()) - int(np.asarray(ma.triangle_mask).sum())) <= 0.01 * tm.sum()


def test_alpha_shape():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, (1500, 3)).astype(np.float32)
    mask = rng.uniform(size=1500) > 0.1
    for m in (None, mask):
        vb, tb = tsr.reconstruct_alpha_shape(torch.from_numpy(pts), 0.3, m)
        va, ta = jsr.reconstruct_alpha_shape(pts, 0.3, m)
        assert vb.dtype == va.dtype and tb.dtype == ta.dtype
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_array_equal(tb, ta)
        assert len(tb) > 100
