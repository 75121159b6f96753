"""Port parity for the toolbox of ops/mesh.py (subdivision, clustering,
clipping, smoothing, quadric decimation, hole filling, ARAP, the UV
atlas and the bakes; the SDF booleans are in test_torch_mesh_booleans.py):
the meshes of tests/test_mesh_ops.py and tests/test_mesh_toolbox.py
through open3d_tpu and open3d_tpu_torch, and each assertion of those two
files on the port but the booleans'.

Bars: topology (triangles, masks) exact and positions within 1e-5, ARAP
within 1e-4; decimation's triangles and masks equal on the flat grid, where
every cost is exactly 0; on the icosphere its live triangle and vertex
counts equal (its costs tie in exact arithmetic, and the JAX package's
fused multiply-adds round them otherwise: 3.8e-6 on costs up to 8.9e-4,
so the two packages collapse other edges of a tie); UVs exact,
bakes within 1e-5. Repeated `.at[].set` indices keep the last write, as
the JAX package's CPU run does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mesh_toolbox as ref_tb
from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
from open3d_tpu.ops import mesh as jo
from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh as TMesh
from open3d_tpu_torch.ops import mesh as to

torch.set_num_threads(2)


def _port(jm) -> TMesh:
    return convert.triangle_mesh_from_numpy(
        {**{f: np.array(getattr(jm, f)) for f in convert.MESH_FIELDS},
         "vertex_attrs": {k: np.array(v) for k, v in jm.vertex_attrs.items()},
         "triangle_attrs": {k: np.array(v) for k, v in jm.triangle_attrs.items()}}, device="cpu")


def _same(jm, tm, atol=1e-5, topology=True):
    if topology:
        for f in ("triangles", "vertex_mask", "triangle_mask"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                          err_msg=f)
    np.testing.assert_allclose(tm.vertices.numpy(), np.asarray(jm.vertices), rtol=0, atol=atol)


def _octahedron():
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float32)
    t = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5],
                  [0, 3, 5]], np.int32)
    return JMesh.create(v, t)


def _capped(subdiv=2):
    """An icosphere with its cap z > 0.8 masked out: a boundary loop."""
    m = ref_tb._icosphere(subdiv)
    cz = np.asarray(m.vertices)[np.asarray(m.triangles)].mean(1)[:, 2]
    return JMesh.create(m.vertices, m.triangles, triangle_mask=jnp.asarray(cz <= 0.8))


def _grid(n=12):
    xs, ys = np.meshgrid(np.arange(n), np.arange(n))
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], -1).astype(np.float32)
    tris = [[y * n + x, y * n + x + 1, y * n + x + n] for y in range(n - 1) for x in range(n - 1)]
    tris += [[y * n + x + 1, y * n + x + n + 1, y * n + x + n] for y in range(n - 1)
             for x in range(n - 1)]
    return JMesh.create(verts, np.asarray(tris, np.int32))


# Each new shape costs the JAX package's eager ops a compile of several
# seconds, so the parity cases share the capped icosphere (a boundary loop
# and masked triangles); the reference tests' own meshes run on the port.


@pytest.mark.parametrize("op", ["subdivide_midpoint", "subdivide_loop"])
def test_subdivision_matches_reference(op):
    jm = _capped()
    _same(getattr(jo, op)(jm, 2), getattr(to, op)(_port(jm), 2))


@pytest.mark.parametrize("case", [("icosphere", 0.3), ("capped", 0.45)])
def test_vertex_clustering_matches_reference(case):
    name, vs = case
    jm = ref_tb._icosphere(3) if name == "icosphere" else _capped()
    _same(jo.simplify_vertex_clustering(jm, vs), to.simplify_vertex_clustering(_port(jm), vs))


def test_clip_plane_keeps_attributes_and_matches_reference():
    jm = _capped()
    jm = JMesh.create(jm.vertices, jm.triangles, vertex_attrs={"colors": jnp.abs(jm.vertices)},
                      triangle_mask=jm.triangle_mask)
    a = jo.clip_plane(jm, [0.1, 0.0, 0.05], [1.0, 0.2, -0.3])
    b = to.clip_plane(_port(jm), [0.1, 0.0, 0.05], [1.0, 0.2, -0.3])
    _same(a, b, atol=0)
    np.testing.assert_array_equal(b.vertex_attrs["colors"].numpy(),
                                  np.asarray(a.vertex_attrs["colors"]))


def _noisy(m: TMesh) -> TMesh:
    v = m.vertices.numpy().copy()
    v[:, 2] += np.random.default_rng(0).normal(0, 0.02, len(v))
    return TMesh.create(v, m.triangles, vertex_mask=m.vertex_mask, triangle_mask=m.triangle_mask,
                        device="cpu")


@pytest.mark.parametrize("op", ["laplacian", "taubin"])
def test_smoothing_matches_reference(op):
    m = _noisy(_port(_capped()))
    jm = JMesh.create(m.vertices.numpy(), m.triangles.numpy(),
                      triangle_mask=m.triangle_mask.numpy())
    if op == "laplacian":
        a, b = jo.filter_smooth_laplacian(jm, 5, 0.5), to.filter_smooth_laplacian(_port(jm), 5, 0.5)
    else:
        a, b = jo.filter_smooth_taubin(jm, 5), to.filter_smooth_taubin(_port(jm), 5)
    _same(a, b)


def test_quadric_decimation_matches_reference_on_the_grid():
    jm = _grid()
    _same(jo.simplify_quadric_decimation(jm, 60), to.simplify_quadric_decimation(_port(jm), 60))


@pytest.mark.parametrize("target", [320, 640])
def test_quadric_decimation_counts_match_reference_on_the_icosphere(target):
    jm = ref_tb._icosphere(3)
    a = jo.simplify_quadric_decimation(jm, target)
    b = to.simplify_quadric_decimation(_port(jm), target)
    assert int(b.num_triangles()) == int(a.num_triangles())
    assert int(b.num_vertices()) == int(a.num_vertices())
    vm, t = b.vertex_mask.numpy(), b.triangles.numpy()[b.triangle_mask.numpy()]
    assert vm[t].all()
    assert np.abs(np.linalg.norm(b.vertices.numpy()[vm], axis=1) - 1.0).max() < 0.05


@pytest.mark.parametrize("hole_size", [128, 3])
def test_fill_holes_matches_reference(hole_size):
    jm = _capped()
    a, b = jo.fill_holes(jm, hole_size), to.fill_holes(_port(jm), hole_size)
    _same(a, b, atol=0)


def test_fill_holes_keeps_the_last_successor_as_the_reference():
    """A bow tie: vertex 0 starts two boundary edges (0->1, 0->3); the JAX
    package's scatter keeps the later row's successor, and so does the
    port."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 0, 0], [-1, -1, 0]], np.float32)
    jm = JMesh.create(v, np.array([[0, 1, 2], [0, 3, 4]], np.int32))
    a, b = jo.fill_holes(jm), to.fill_holes(_port(jm))
    _same(a, b, atol=0)
    nxt = jnp.full((5,), -1).at[jnp.array([0, 0, 1, 3])].set(jnp.array([1, 3, 2, 4]))
    np.testing.assert_array_equal(
        to._set_last(torch.full((5,), -1), torch.tensor([0, 0, 1, 3]),
                     torch.tensor([1, 3, 2, 4])).numpy(), np.asarray(nxt))


@pytest.mark.parametrize("case", ["lift", "rigid"])
def test_arap_matches_reference(case):
    grid = ref_tb.TestARAP()._grid_mesh
    if case == "lift":
        jm, n = grid(9), 9
        cid = np.asarray([0, n - 1, n * (n - 1), n * n - 1, (n // 2) * n + n // 2], np.int32)
        cpos = np.asarray(jm.vertices)[cid].copy()
        cpos[-1, 2] = 0.3
        kw = dict(max_iter=8)
    else:
        jm = grid(5)
        cid = np.asarray([0, 4, 20, 24, 4], np.int32)  # a repeated id: the last target wins
        cpos = np.asarray(jm.vertices)[cid] + np.asarray([0.2, -0.1, 0.4], np.float32)
        cpos[-1] += 0.01
        kw = dict(max_iter=12)
    a = jo.deform_as_rigid_as_possible(jm, cid, cpos, **kw)
    b = to.deform_as_rigid_as_possible(_port(jm), cid, cpos, **kw)
    _same(a, b, atol=1e-4)


def test_uv_atlas_and_bakes_match_reference():
    jm = ref_tb._icosphere(2)
    cols = jnp.abs(jm.vertices)
    jm = JMesh.create(jm.vertices, jm.triangles, vertex_attrs={"colors": cols},
                      triangle_attrs={"labels": jnp.arange(320, dtype=jnp.float32) / 320.0},
                      triangle_mask=jnp.arange(320) % 7 != 3)
    a, b = jo.compute_uv_atlas(jm, size=160), to.compute_uv_atlas(_port(jm), size=160)
    _same(a, b, atol=0)
    np.testing.assert_array_equal(b.triangle_attrs["texture_uvs"].numpy(),
                                  np.asarray(a.triangle_attrs["texture_uvs"]))
    ta = jo.bake_vertex_attr_textures(a, ["colors"], size=160)["colors"]
    tb = to.bake_vertex_attr_textures(b, ["colors"], size=160)["colors"]
    assert tb.shape == (160, 160, 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(ta), rtol=0, atol=1e-5)
    ta = jo.bake_triangle_attr_textures(a, ["labels"], size=160)["labels"]
    tb = to.bake_triangle_attr_textures(b, ["labels"], size=160)["labels"]
    np.testing.assert_allclose(tb.numpy(), np.asarray(ta), rtol=0, atol=1e-5)
    for f in (jo.compute_uv_atlas, to.compute_uv_atlas):
        with pytest.raises(ValueError, match="too small"):
            f(a if f is jo.compute_uv_atlas else b, size=64)


# ---- tests/test_mesh_ops.py on the port -------------------------------------


def _quad() -> TMesh:
    return TMesh.create([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], [[0, 1, 2], [0, 2, 3]],
                        device="cpu")


def test_ref_subdivide_midpoint_counts_and_area():
    m = _quad()
    s = to.subdivide_midpoint(m, 1)
    assert int(s.num_triangles()) == 8 and int(s.num_vertices()) == 9
    np.testing.assert_allclose(float(s.surface_area()), float(m.surface_area()), rtol=1e-6)


def test_ref_simplify_vertex_clustering():
    m = to.subdivide_midpoint(_quad(), 2)
    simp = to.simplify_vertex_clustering(m, voxel_size=0.6)
    assert int(simp.num_vertices()) <= 6
    assert int(simp.num_triangles()) < int(m.num_triangles())
    t = simp.triangles.numpy()[simp.triangle_mask.numpy()]
    assert (t[:, 0] != t[:, 1]).all() and (t[:, 1] != t[:, 2]).all()


def test_ref_clip_plane():
    m = to.subdivide_midpoint(_quad(), 2)
    c = to.clip_plane(m, point=[0.5, 0, 0], normal=[1, 0, 0])
    assert (c.vertices.numpy()[c.vertex_mask.numpy()][:, 0] >= 0.5 - 1e-6).all()
    assert 0 < int(c.num_triangles()) < int(m.num_triangles())


def test_ref_remove_duplicated_vertices():
    m = TMesh.create([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0]], [[0, 1, 2], [0, 3, 2]],
                     device="cpu")
    d = to.remove_duplicated_vertices(m)
    assert int(d.num_vertices()) == 3
    tt = d.triangles.numpy()
    assert set(tt[0].tolist()) == set(tt[1].tolist())


def test_ref_laplacian_and_taubin_smoothing():
    noisy = _noisy(to.subdivide_midpoint(_quad(), 2))
    sm = to.filter_smooth_laplacian(noisy, 5, 0.5)
    assert np.abs(sm.vertices.numpy()[:, 2]).mean() < np.abs(noisy.vertices.numpy()[:, 2]).mean()
    assert np.ptp(to.filter_smooth_taubin(noisy, 5).vertices.numpy()[:, 0]) > 0.9


def test_ref_subdivide_loop_smooths_toward_sphere():
    mesh = _port(_octahedron())
    loop2, mid2 = to.subdivide_loop(mesh, 2), to.subdivide_midpoint(mesh, 2)
    assert int(loop2.num_triangles()) == 8 * 16
    nv, nf = int(loop2.num_vertices()), int(loop2.num_triangles())
    assert nv - (3 * nf) // 2 + nf == 2
    rl = np.linalg.norm(loop2.vertices.numpy()[loop2.vertex_mask.numpy()], axis=1)
    rm = np.linalg.norm(mid2.vertices.numpy()[mid2.vertex_mask.numpy()], axis=1)
    assert rl.std() / rl.mean() < 0.5 * (rm.std() / rm.mean())
    assert rl.max() < 1.0 + 1e-5


# ---- tests/test_mesh_toolbox.py on the port ---------------------------------


def test_ref_quadric_decimation_sphere():
    mesh = _port(ref_tb._icosphere(3))
    n0 = int(mesh.num_triangles())
    out = to.simplify_quadric_decimation(mesh, n0 // 4)
    assert n0 // 4 <= int(out.num_triangles()) <= int(n0 * 0.45)
    vm = out.vertex_mask.numpy()
    assert np.abs(np.linalg.norm(out.vertices.numpy()[vm], axis=1) - 1.0).max() < 0.05
    assert vm[out.triangles.numpy()[out.triangle_mask.numpy()]].all()


def test_ref_quadric_decimation_preserves_planes():
    out = to.simplify_quadric_decimation(_port(_grid()), 60)
    assert np.abs(out.vertices.numpy()[out.vertex_mask.numpy()][:, 2]).max() < 1e-4
    assert int(out.num_triangles()) <= 130


def test_ref_select_by_index_and_mask():
    mesh = _port(ref_tb._icosphere(1))
    keep = mesh.vertices.numpy()[:, 2] > 0
    out = to.select_by_mask(mesh, torch.from_numpy(keep))
    assert keep[out.triangles.numpy()[out.triangle_mask.numpy()]].all()
    assert 0 < int(out.num_triangles()) < int(mesh.num_triangles())
    assert int(to.select_by_index(mesh, np.nonzero(keep)[0]).num_triangles()) == \
        int(out.num_triangles())


def test_ref_remove_degenerate_and_unreferenced():
    mesh = TMesh.create(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], np.float32),
                        np.array([[0, 1, 2], [0, 0, 1], [1, 1, 1]], np.int32), device="cpu")
    out = to.remove_degenerate_triangles(mesh)
    assert int(out.num_triangles()) == 1
    out = to.remove_unreferenced_vertices(out)
    assert int(out.num_vertices()) == 3 and not bool(out.vertex_mask[3])


def _boundary_edges(mesh: TMesh) -> int:
    t = mesh.triangles.numpy()[mesh.triangle_mask.numpy()]
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1)
    return int((np.unique(e, axis=0, return_counts=True)[1] == 1).sum())


def test_ref_fill_holes_closes_cap():
    holed = _port(_capped())
    assert _boundary_edges(holed) > 3
    filled = to.fill_holes(holed)
    assert _boundary_edges(filled) == 0
    assert int(filled.num_triangles()) > int(holed.num_triangles())


def test_ref_fill_holes_respects_size_cutoff():
    holed = _port(_capped())
    assert _boundary_edges(to.fill_holes(holed, hole_size=3)) == _boundary_edges(holed)


def test_ref_arap_lifts_handle_smoothly():
    n = 9
    mesh = _port(ref_tb.TestARAP()._grid_mesh(n))
    cid = np.asarray([0, n - 1, n * (n - 1), n * n - 1, (n // 2) * n + n // 2], np.int32)
    cpos = mesh.vertices.numpy()[cid].copy()
    cpos[-1, 2] = 0.3
    v = to.deform_as_rigid_as_possible(mesh, cid, cpos, max_iter=8).vertices.numpy()
    np.testing.assert_allclose(v[cid], cpos, atol=1e-5)
    assert 0.03 < v[(n // 2) * n + n // 2 - 1, 2] < 0.3
    assert abs(v[1, 2]) < 0.1
    assert np.isfinite(v).all() and np.abs(v).max() < 2.0


def test_ref_arap_rigid_motion_is_free():
    mesh = _port(ref_tb.TestARAP()._grid_mesh(5))
    cid = np.asarray([0, 4, 20, 24], np.int32)
    shift = np.asarray([0.2, -0.1, 0.4], np.float32)
    out = to.deform_as_rigid_as_possible(mesh, cid, mesh.vertices.numpy()[cid] + shift,
                                         max_iter=12)
    np.testing.assert_allclose(out.vertices.numpy(), mesh.vertices.numpy() + shift, atol=2e-2)


def test_ref_atlas_and_vertex_bake_roundtrip():
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    tn = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mesh = TMesh.create(np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32), tn,
                        vertex_attrs={"colors": colors}, device="cpu")
    mesh = to.compute_uv_atlas(mesh, size=64)
    uvs = mesh.triangle_attrs["texture_uvs"].numpy()
    assert uvs.shape == (2, 3, 2) and (uvs >= 0).all() and (uvs <= 1).all()
    tex = to.bake_vertex_attr_textures(mesh, ["colors"], size=64)["colors"].numpy()
    assert tex.shape == (64, 64, 3)
    for k in range(2):
        x, y = (int(round(c)) for c in uvs[k].mean(axis=0) * 64)
        assert np.allclose(tex[y, x], colors[tn[k]].mean(axis=0), atol=0.12)
        for j in range(3):
            x, y = (uvs[k, j] * 64).round().astype(int)
            assert np.allclose(tex[y, x], colors[tn[k, j]], atol=0.15)


def test_ref_triangle_bake_constant_patches():
    mesh = TMesh.create(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                        np.array([[0, 1, 2]], np.int32),
                        triangle_attrs={"labels": np.array([[0.25]], np.float32)}, device="cpu")
    mesh = to.compute_uv_atlas(mesh, size=32)
    tex = to.bake_triangle_attr_textures(mesh, ["labels"], size=32)["labels"].numpy()
    uv_c = mesh.triangle_attrs["texture_uvs"].numpy()[0].mean(axis=0) * 32
    assert abs(tex[int(uv_c[1]), int(uv_c[0]), 0] - 0.25) < 1e-6
