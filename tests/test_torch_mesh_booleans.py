"""Port parity for the SDF booleans of ops/mesh.py (boolean_union,
boolean_intersection, boolean_difference): two overlapping icospheres
through open3d_tpu and open3d_tpu_torch, and tests/test_mesh_toolbox.py's
TestBooleans on the port.

Bars: the two signed-distance sweeps within 1e-5 m with equal signs; on a
grid with no sample within 1e-6 of either surface, so that no sign is left
to rounding, the marched meshes' triangles and masks equal and their live
vertices within 1e-5 (the unused rows differ: zero in the port, the grid's
origin in the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mesh_toolbox as ref_tb
from open3d_tpu.geometry.raycasting import RaycastingScene as JScene
from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
from open3d_tpu_torch.geometry.raycasting import RaycastingScene as TScene
from open3d_tpu_torch.ops import mesh as to
from test_torch_mesh_toolbox import _port

torch.set_num_threads(2)


def _spheres():
    a = ref_tb._icosphere(2, radius=0.5)
    b = JMesh.create(a.vertices + jnp.asarray([0.31, 0.043, 0.027]), a.triangles)
    return a, b


VS, PAD = 0.05, 0.0517  # no sample of the grid within 1e-6 of either surface


@pytest.fixture(scope="module")
def sphere_fields():
    """Each sphere's signed distance on the booleans' grid, from each
    package's RaycastingScene: the two sweeps every boolean combines."""
    ja, jb = _spheres()
    lo = np.asarray(jnp.minimum(ja.get_min_bound(), jb.get_min_bound()) - PAD)
    hi = np.asarray(jnp.maximum(ja.get_max_bound(), jb.get_max_bound()) + PAD)
    dims = np.maximum(np.ceil((hi - lo) / VS).astype(int) + 1, 2)
    xs = [np.asarray(lo[i] + np.arange(dims[i]) * VS, np.float32) for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    fields = []
    for m in (ja, jb):
        v, t = m.compact()
        js, ts = JScene(), TScene(device="cpu")
        js.add_triangles(v, t)
        ts.add_triangles(v, t)
        fields.append((np.asarray(js.compute_signed_distance(jnp.asarray(pts))),
                       ts.compute_signed_distance(torch.from_numpy(pts)).numpy()))
    return ja, jb, lo, tuple(int(d) for d in dims), fields


def test_boolean_fields_match_reference(sphere_fields):
    *_, fields = sphere_fields
    for fj, ft in fields:
        np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5)
        assert np.abs(fj).min() > 1e-6 and np.array_equal(fj < 0, ft < 0)


@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_booleans_match_reference(op, sphere_fields):
    """The port's boolean against the JAX package's marching of its own
    two fields, combined as its boolean combines them."""
    from open3d_tpu.pipelines.surface_reconstruction import marching_tetrahedra_dense

    ja, jb, lo, dims, ((da, _), (db, _)) = sphere_fields
    d = {"union": np.minimum(da, db), "intersection": np.maximum(da, db),
         "difference": np.maximum(da, -db)}[op]
    a = marching_tetrahedra_dense(jnp.asarray(d.reshape(dims)), iso=0.0,
                                  origin=tuple(lo.tolist()), spacing=VS, triangle_capacity=131072)
    b = getattr(to, f"boolean_{op}")(_port(ja), _port(jb), voxel_size=VS, padding=PAD)
    assert int(b.num_triangles()) > 50
    for f in ("triangles", "triangle_mask"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
    live = np.asarray(a.triangles)[np.asarray(a.triangle_mask)].reshape(-1)  # unused rows differ
    np.testing.assert_allclose(b.vertices.numpy()[live], np.asarray(a.vertices)[live], rtol=0,
                               atol=1e-5)


# ---- tests/test_mesh_toolbox.py's TestBooleans on the port -------------------


def test_ref_union_intersection_difference_volumes():
    a = _port(ref_tb.TestBooleans()._box((0.0, 0.0, 0.0)))
    b = _port(ref_tb.TestBooleans()._box((0.5, 0.0, 0.0)))
    g = np.linspace(-0.6, 1.1, 35, dtype=np.float32)
    pts = torch.from_numpy(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3))

    def volume(mesh):
        scene = TScene(device="cpu")
        scene.add_triangles(*mesh.compact())
        return float(scene.compute_occupancy(pts).sum()) * float(g[1] - g[0]) ** 3

    un, it, df = (getattr(to, f"boolean_{op}")(a, b, voxel_size=0.05)
                  for op in ("union", "intersection", "difference"))
    assert abs(volume(un) - 1.5) < 0.12
    assert abs(volume(it) - 0.5) < 0.08
    assert abs(volume(df) - 0.5) < 0.08
    for m in (un, it, df):
        assert int(m.num_triangles()) > 50
