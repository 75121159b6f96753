"""Port parity for the cleanup and connectivity family of ops/mesh.py, on
the meshes of tests/test_mesh_connectivity.py and on a mesh the JAX
package extracted from a fused grid (indexed, and its raw soup), against
open3d_tpu on the same meshes.

Bars: ids, masks, counts and adjacency equal; positions (a cell's
centroid, a representative vertex) within 1e-6 and cluster areas within
1e-5 relative (the segment sums may add in another order).
cluster_connected_triangles gives the same ids, counts and areas at a cap
below its fixed point and at one above it. The JAX package's own
assertions on those meshes hold on the port too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
from open3d_tpu.ops import mesh as jops
from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh as TMesh
from open3d_tpu_torch.ops import mesh as tops

torch.set_num_threads(2)
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)


def _both(verts, tris, tmask=None):
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int32)
    return (JMesh.create(v, t, triangle_mask=tmask),
            TMesh.create(v, t, triangle_mask=tmask, device="cpu"))


def _two_components():
    # a square (2 edge-adjacent triangles), a lone triangle, a masked one
    return _both([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [10, 0, 0], [11, 0, 0], [10, 1, 0],
                  [20, 0, 0], [21, 0, 0], [20, 1, 0]],
                 [[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9]], np.array([1, 1, 1, 0], bool))


def _vertex_touching():
    return _both([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]],
                 [[0, 1, 2], [0, 3, 4]])


def _near_duplicates():
    return _both([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 0, 1e-4], [1 + 1e-4, 1, 0], [0, 1, 0]],
                 [[0, 1, 2], [3, 4, 5]])


def _degenerate():
    # a repeated id, a zero-area sliver, one good triangle, a masked one
    return _both([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 1, 0], [5, 5, 5]],
                 [[0, 0, 1], [0, 1, 2], [0, 1, 3], [1, 2, 3]], np.array([1, 1, 1, 0], bool))


@functools.lru_cache(maxsize=None)
def _extracted(indexed: bool):
    """The JAX package's mesh of 3 fused frames (8^3 blocks, 5 cm voxels),
    carried to the port."""
    ji = JIntr(*INTR)
    d, c, e, _ = jsyn.render_sequence(3, intrinsic=ji, span=0.3)
    g = jvbg.create(voxel_size=0.05, block_resolution=8, block_count=512)
    for i in range(3):
        keys, _ = jvbg.compute_unique_block_coordinates(g, d[i], ji, e[i], 3.0,
                                                        frame_block_capacity=512)
        g = jvbg.integrate(g, keys, d[i], c[i], ji, e[i], depth_max=3.0)
    mj = jvbg.extract_triangle_mesh(g, triangle_capacity=8192, weight_threshold=2.0,
                                    indexed=indexed)
    arrays = {f: np.asarray(getattr(mj, f)) for f in convert.MESH_FIELDS}
    arrays["vertex_attrs"] = {k: np.asarray(v) for k, v in mj.vertex_attrs.items()}
    return mj, convert.triangle_mesh_from_numpy(arrays, device="cpu")


MESHES = {
    "two_components": _two_components,
    "vertex_touching": _vertex_touching,
    "near_duplicates": _near_duplicates,
    "degenerate": _degenerate,
    "extracted": lambda: _extracted(True),
    "extracted_soup": lambda: _extracted(False),
}


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _mesh_eq(mt, mj, atol=1e-6):
    for f in ("triangles", "vertex_mask", "triangle_mask"):
        _eq(getattr(mt, f), getattr(mj, f))
    np.testing.assert_allclose(mt.vertices.numpy(), np.asarray(mj.vertices), atol=atol, rtol=0)
    assert mt.vertex_attrs.keys() == mj.vertex_attrs.keys()


def _cluster_eq(rt, rj):
    ids_t, n_t, cnt_t, area_t = rt
    ids_j, n_j, cnt_j, area_j = rj
    _eq(ids_t, ids_j)
    assert int(n_t) == int(n_j)
    _eq(cnt_t, cnt_j)
    np.testing.assert_allclose(area_t.numpy(), np.asarray(area_j), rtol=1e-5, atol=1e-12)


def _select_index(mesh, pkg):
    idx = np.arange(0, mesh.vertices.shape[0], 3)
    return (jops if pkg == "jax" else tops).select_by_index(mesh, idx)


def _select_mask(mesh, pkg):
    keep = np.arange(mesh.vertices.shape[0]) % 4 != 1
    return (jops if pkg == "jax" else tops).select_by_mask(
        mesh, jnp.asarray(keep) if pkg == "jax" else torch.from_numpy(keep))


OPS = {
    "remove_duplicated_vertices": lambda m, ops, pkg: ops.remove_duplicated_vertices(m),
    "remove_duplicated_vertices_2dp": lambda m, ops, pkg: ops.remove_duplicated_vertices(m, 2),
    "select_by_mask": lambda m, ops, pkg: _select_mask(m, pkg),
    "select_by_index": lambda m, ops, pkg: _select_index(m, pkg),
    "remove_degenerate_triangles": lambda m, ops, pkg: ops.remove_degenerate_triangles(m),
    "remove_unreferenced_vertices": lambda m, ops, pkg: ops.remove_unreferenced_vertices(
        ops.select_by_mask(m, jnp.asarray(_half(m)) if pkg == "jax" else torch.from_numpy(_half(m)))),
    "merge_close_vertices": lambda m, ops, pkg: ops.merge_close_vertices(m, eps=1e-2),
    "merge_close_vertices_coarse": lambda m, ops, pkg: ops.merge_close_vertices(m, eps=0.07),
    "remove_small_components": lambda m, ops, pkg: ops.remove_small_components(m, min_triangles=2),
    "remove_small_components_area": lambda m, ops, pkg: ops.remove_small_components(
        m, min_area=0.9 if m.vertices.shape[0] < 100 else 0.01),
}


def _half(m):
    return np.arange(m.vertices.shape[0]) < m.vertices.shape[0] // 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_reference(op, mesh):
    mj, mt = MESHES[mesh]()
    _mesh_eq(OPS[op](mt, tops, "port"), OPS[op](mj, jops, "jax"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_adjacency_matches_reference(mesh):
    mj, mt = MESHES[mesh]()
    for d in (3, 8):
        at, dt = tops.compute_adjacency_list(mt, max_degree=d)
        aj, dj = jops.compute_adjacency_list(mj, max_degree=d)
        _eq(at, aj)
        _eq(dt, dj)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_clusters_match_reference_below_and_above_the_fixed_point(mesh):
    mj, mt = MESHES[mesh]()
    _, hops = tops._propagate_labels(mt, 512, check_every=1)
    assert hops < 512  # 512 reaches the fixed point on these meshes
    for cap in sorted({1, max(hops // 2, 1), hops - 1, hops, 512}):
        _cluster_eq(tops.cluster_connected_triangles(mt, max_iterations=cap),
                    jops.cluster_connected_triangles(mj, max_iterations=cap))


def test_extracted_mesh_needs_many_hops():
    """On the extracted mesh a cap below the fixed point leaves one surface
    in several clusters, in both packages alike."""
    mj, mt = _extracted(True)
    _, hops = tops._propagate_labels(mt, 512, check_every=1)
    assert hops > 8
    n_low = int(tops.cluster_connected_triangles(mt, max_iterations=4)[1])
    n_fix = int(tops.cluster_connected_triangles(mt, max_iterations=hops)[1])
    assert n_low > n_fix
    assert n_low == int(jops.cluster_connected_triangles(mj, max_iterations=4)[1])


def test_reference_assertions_hold_on_the_port():
    """tests/test_mesh_connectivity.py's checks, run on the port."""
    _, mesh = _two_components()
    ids, n, counts, areas = tops.cluster_connected_triangles(mesh)
    assert int(n) == 2 and ids.tolist() == [0, 0, 1, -1]
    assert counts.tolist()[:3] == [2, 2, 1]
    np.testing.assert_allclose(areas.numpy()[[0, 2]], [1.0, 0.5], atol=1e-6)
    assert int(tops.cluster_connected_triangles(_vertex_touching()[1])[1]) == 2
    assert tops.remove_small_components(mesh, min_triangles=2).triangle_mask.tolist() == \
        [True, True, False, False]
    out = tops.merge_close_vertices(_near_duplicates()[1], eps=1e-2)
    assert int(out.vertex_mask.sum()) == 4 and bool(out.triangle_mask.all())
    tri = out.triangles.numpy()
    assert tri[1, 0] == tri[0, 0] and tri[1, 1] == tri[0, 2]
    adj, deg = tops.compute_adjacency_list(mesh, max_degree=8)
    assert int(deg[0]) == 3 and set(adj[0, :3].tolist()) == {1, 2, 3}
    assert int(deg[4]) == 2 and set(adj[4, :2].tolist()) == {5, 6} and int(deg[7]) == 0
