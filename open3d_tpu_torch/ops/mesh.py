"""Triangle-mesh toolbox (port of open3d_tpu/ops/mesh.py): subdivision,
simplification, clipping, smoothing, quadric decimation, hole filling,
as-rigid-as-possible deformation, SDF booleans, the UV atlas and texture
baking, and the cleanup and connectivity family that
`reconstruction.extract_scene_mesh` calls.

Shapes stay at the mesh's capacity and results are masks, as in the JAX
package. Multi-key sorts are `core.masking.lexsort_rows`; every float
scatter-add is `core.masking._scatter_add`, so a run repeats bit for bit
(the card's segmented sums may group additions apart from the CPU's);
`jax.ops.segment_min` over an empty
segment yields INT32_MAX, so the port's `amin` reductions start from it.
Where the JAX package writes repeated indices with `.at[].set`, the last
write wins, as on its CPU run (`_set_last`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from open3d_tpu_torch.core.masking import (_div, _scatter_add, _scatter_apply, _scatter_plan,
                                           _unique_rows, lexsort_rows)
from open3d_tpu_torch.geometry.bvh import _cross, _dot
from open3d_tpu_torch.geometry.raycasting import RaycastingScene
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.pipelines.surface_reconstruction import marching_tetrahedra_dense

_INT_BIG = 2**30
_INT32_MAX = 2**31 - 1
# cluster_connected_triangles reads its `changed` flag once every this
# many label-propagation steps
_CHECK_EVERY = 16


def _segment_min(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """segment_min into n segments; an empty segment holds INT32_MAX."""
    out = torch.full((n,), _INT32_MAX, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ids.to(torch.int64), vals, "amin")


def _first_of_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(N, k) or (N,) sorted keys -> (N,) bool marking each new key."""
    first = torch.ones(sorted_keys.shape[0], dtype=torch.bool, device=sorted_keys.device)
    diff = sorted_keys[1:] != sorted_keys[:-1]
    first[1:] = diff if diff.dim() == 1 else diff.any(-1)
    return first


def _tri(mesh: TriangleMesh) -> torch.Tensor:
    return torch.clamp(mesh.triangles, min=0).to(torch.int64)


def _cluster_areas(mesh: TriangleMesh) -> torch.Tensor:
    tri = mesh.triangles.to(torch.int64)
    v0, v1, v2 = (mesh.vertices[tri[:, k]] for k in range(3))
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)
    return torch.where(mesh.triangle_mask, area, 0.0)


# ---------------------------------------------------------------------------
# Duplicates
# ---------------------------------------------------------------------------


def remove_duplicated_vertices(mesh: TriangleMesh, decimals: int = 6) -> TriangleMesh:
    """Merge vertices equal after rounding to `decimals`: the unique rows
    in lexicographic order (masked vertices form one row of 2^30, masked
    out), each represented by its first member; attributes are dropped."""
    v = mesh.vertices
    V = v.shape[0]
    q = torch.round(v * (10.0**decimals)).to(torch.int32)
    uniq, inv = _unique_rows(torch.where(mesh.vertex_mask[:, None], q, _INT_BIG), V, _INT_BIG)
    rep = _segment_min(torch.arange(V, dtype=torch.int32, device=v.device), inv, V)
    return TriangleMesh.create(
        v[torch.clamp(rep, 0, V - 1).to(torch.int64)], inv[_tri(mesh)],
        vertex_mask=uniq[:, 0] < _INT_BIG, triangle_mask=mesh.triangle_mask,
    )


# ---------------------------------------------------------------------------
# Selection / cleanup
# ---------------------------------------------------------------------------


def select_by_mask(mesh: TriangleMesh, vertex_mask: torch.Tensor) -> TriangleMesh:
    """Keep the masked vertices and every triangle whose 3 vertices
    survive; attributes are dropped."""
    keep_v = mesh.vertex_mask & torch.as_tensor(vertex_mask, dtype=torch.bool,
                                                 device=mesh.device)
    t = _tri(mesh)
    keep_t = mesh.triangle_mask & keep_v[t[:, 0]] & keep_v[t[:, 1]] & keep_v[t[:, 2]]
    return TriangleMesh.create(mesh.vertices, mesh.triangles, vertex_mask=keep_v,
                               triangle_mask=keep_t)


def select_by_index(mesh: TriangleMesh, indices) -> TriangleMesh:
    """select_by_mask of the listed vertex ids."""
    vm = torch.zeros(mesh.vertices.shape[0], dtype=torch.bool, device=mesh.device)
    vm[torch.as_tensor(indices, dtype=torch.int64, device=mesh.device)] = True
    return select_by_mask(mesh, vm)


def remove_degenerate_triangles(mesh: TriangleMesh) -> TriangleMesh:
    """Mask out triangles with repeated vertex ids or ~zero area."""
    t = _tri(mesh)
    distinct = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
    a, b, c = (mesh.vertices[t[:, k]] for k in range(3))
    area2 = torch.linalg.norm(torch.linalg.cross(b - a, c - a), dim=-1)
    ok = mesh.triangle_mask & distinct & (area2 > 1e-14)
    return TriangleMesh.create(mesh.vertices, mesh.triangles, vertex_mask=mesh.vertex_mask,
                               triangle_mask=ok)


def remove_unreferenced_vertices(mesh: TriangleMesh) -> TriangleMesh:
    """Mask out the vertices no live triangle references."""
    t = _tri(mesh)
    used = torch.zeros(mesh.vertices.shape[0], dtype=torch.bool, device=mesh.device)
    used[t[mesh.triangle_mask].reshape(-1)] = True
    return TriangleMesh.create(mesh.vertices, mesh.triangles,
                               vertex_mask=mesh.vertex_mask & used,
                               triangle_mask=mesh.triangle_mask)


# ---------------------------------------------------------------------------
# Connectivity (ref: geometry/TriangleMesh.h:117 ComputeAdjacencyList, :150
# MergeCloseVertices, :442 ClusterConnectedTriangles)
# ---------------------------------------------------------------------------


def _edge_groups(mesh: TriangleMesh):
    """Canonical edge ids of every triangle edge, sorted: (3T,) int32 group
    ids such that coincident edges (the same unordered vertex pair) share a
    group, and the owning triangle of each entry."""
    tri = mesh.triangles
    T = tri.shape[0]
    a = tri
    b = tri[:, [1, 2, 0]]
    valid = mesh.triangle_mask.repeat_interleave(3)
    lo = torch.where(valid, torch.minimum(a, b).reshape(-1), _INT_BIG)
    hi = torch.where(valid, torch.maximum(a, b).reshape(-1), _INT_BIG)
    key = torch.stack([lo, hi], dim=1)
    order = lexsort_rows(key)
    gid_s = torch.cumsum(_first_of_runs(key[order]).to(torch.int32), 0, dtype=torch.int32) - 1
    owner_s = (order // 3).to(torch.int32)
    return gid_s, owner_s


def _propagate_labels(mesh: TriangleMesh, max_iterations: int, check_every: int = _CHECK_EVERY):
    """Min-label propagation through shared edges, one edge hop a step,
    until a step changes nothing or `max_iterations` steps ran. Past its
    fixed point a step changes nothing, so reading `changed` only every
    `check_every` steps gives the same labels. Returns (labels (T,) int32,
    the steps run)."""
    T = mesh.triangles.shape[0]
    dev = mesh.device
    gid_s, owner_s = _edge_groups(mesh)
    owner = owner_s.to(torch.int64)
    labels = torch.where(mesh.triangle_mask, torch.arange(T, dtype=torch.int32, device=dev),
                         _INT_BIG)
    it = 0
    while it < max_iterations:
        grp_min = _segment_min(labels[owner], gid_s, 3 * T)
        new = torch.minimum(labels, _segment_min(grp_min[gid_s.to(torch.int64)], owner_s, T))
        it += 1
        done = it % check_every == 0 and torch.equal(new, labels)
        labels = new
        if done:
            break
    return labels, it


def cluster_connected_triangles(mesh: TriangleMesh, max_iterations: int = 512):
    """Connected components over edge-adjacent triangles, as min-label
    propagation (at most `max_iterations` edge hops).

    Returns (cluster_ids (T,) int32, -1 for masked-out triangles;
    n_clusters (); cluster_n_triangles (T,) the triangle count of each
    triangle's cluster; cluster_area (T,) its area). Cluster ids run 0..k-1
    in order of each cluster's smallest triangle id."""
    T = mesh.triangles.shape[0]
    dev = mesh.device
    m = mesh.triangle_mask
    labels, _ = _propagate_labels(mesh, max_iterations)
    labels = torch.where(m, labels, -1)
    arange = torch.arange(T, dtype=torch.int32, device=dev)
    is_root = m & (labels == arange)
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    cluster_ids = torch.where(m, rank[torch.clamp(labels, min=0).to(torch.int64)], -1)

    seg = torch.where(m, cluster_ids, T - 1)
    counts = _scatter_add(m.to(torch.int32), seg, T)
    areas = _scatter_add(_cluster_areas(mesh), seg, T)
    cid = torch.clamp(cluster_ids, min=0).to(torch.int64)
    per_tri_count = torch.where(m, counts[cid], 0)
    per_tri_area = torch.where(m, areas[cid], 0.0)
    return cluster_ids, is_root.to(torch.int32).sum(), per_tri_count, per_tri_area


def remove_small_components(
    mesh: TriangleMesh,
    min_triangles: int = 0,
    min_area: float = 0.0,
) -> TriangleMesh:
    """Mask out the connected components below a triangle count or area."""
    _, _, per_tri_count, per_tri_area = cluster_connected_triangles(mesh)
    keep = mesh.triangle_mask
    if min_triangles > 0:
        keep = keep & (per_tri_count >= min_triangles)
    if min_area > 0.0:
        keep = keep & (per_tri_area >= min_area)
    return dataclasses.replace(mesh, triangle_mask=keep)


def merge_close_vertices(mesh: TriangleMesh, eps: float) -> TriangleMesh:
    """Merge the vertices of each eps-sized grid cell into the cell's
    smallest vertex id, placed at the cell's centroid; triangles are
    remapped and the collapsed ones masked."""
    v = mesh.vertices
    V = v.shape[0]
    dev = v.device
    q = torch.floor(v / max(eps, 1e-12)).to(torch.int32)
    q = torch.where(mesh.vertex_mask[:, None], q, _INT_BIG)
    order = lexsort_rows(q)
    gid_s = torch.cumsum(_first_of_runs(q[order]).to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.empty(V, dtype=torch.int32, device=dev).scatter_(0, order, gid_s).to(torch.int64)
    w = mesh.vertex_mask.to(torch.float32)
    vsum = _scatter_add(v * w[:, None], gid, V)
    cnt = _scatter_add(w, gid, V)
    centroid = vsum / torch.clamp(cnt, min=1.0)[:, None]
    ids = torch.arange(V, dtype=torch.int32, device=dev)
    rep = _segment_min(torch.where(mesh.vertex_mask, ids, V - 1), gid, V).to(torch.int64)
    # every representative moves to its cell's centroid (the vertex V - 1
    # that masked cells name is moved to its own cell's)
    targets = rep[rep < V]
    new_verts = v.clone()
    new_verts[targets] = centroid[gid[targets]]
    remap = rep[gid].to(torch.int32)
    new_tri = remap[mesh.triangles.to(torch.int64)]
    degen = ((new_tri[:, 0] == new_tri[:, 1]) | (new_tri[:, 1] == new_tri[:, 2])
             | (new_tri[:, 2] == new_tri[:, 0]))
    return dataclasses.replace(
        mesh, vertices=new_verts, triangles=new_tri,
        vertex_mask=mesh.vertex_mask & (ids == remap),
        triangle_mask=mesh.triangle_mask & ~degen,
    )


def compute_adjacency_list(mesh: TriangleMesh, max_degree: int = 32):
    """Per-vertex adjacency as (V, max_degree) int32 padded with -1, each
    row's neighbours ascending, and the degree clamped to max_degree."""
    tri = mesh.triangles
    V = mesh.vertices.shape[0]
    dev = mesh.device
    src = torch.cat([tri[:, 0], tri[:, 1], tri[:, 2], tri[:, 1], tri[:, 2], tri[:, 0]])
    dst = torch.cat([tri[:, 1], tri[:, 2], tri[:, 0], tri[:, 0], tri[:, 1], tri[:, 2]])
    valid = mesh.triangle_mask.repeat(6)
    key = torch.stack([torch.where(valid, src, _INT_BIG), torch.where(valid, dst, _INT_BIG)], dim=1)
    key = key[lexsort_rows(key)]
    src_s, dst_s = key[:, 0], key[:, 1]
    uniq = _first_of_runs(key) & (src_s != _INT_BIG)
    slot = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32) - 1
    row = torch.where(uniq, src_s, V - 1)
    row_start = _segment_min(torch.where(uniq, slot, _INT_BIG), row, V)
    local = slot - row_start[torch.where(uniq, src_s, 0).to(torch.int64)]
    ok = uniq & (local < max_degree)
    adj = torch.full((V, max_degree), -1, dtype=torch.int32, device=dev)
    adj[src_s[ok].to(torch.int64), local[ok].to(torch.int64)] = dst_s[ok]
    degree = _scatter_add(uniq.to(torch.int32), row, V)
    return adj, torch.clamp(degree, max=max_degree)


# ---------------------------------------------------------------------------
# Shared pieces of the toolbox
# ---------------------------------------------------------------------------


def _set_last(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """`x.at[idx].set(vals)` with repeated indices resolved as the JAX
    package's CPU run resolves them: the last write wins (CUDA's
    `index_put_` keeps any one of them)."""
    idx = idx.to(torch.int64)
    ar = torch.arange(idx.shape[0], device=x.device)
    last = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    last = last.scatter_reduce(0, idx, ar, "amax")
    keep = last[idx] == ar
    out = x.clone()
    out[idx[keep]] = vals[keep].to(x.dtype)
    return out


def _edges(t: torch.Tensor) -> torch.Tensor:
    """(3T, 2) edges 01, 12, 20 of (T, 3) triangles, block by block."""
    return torch.cat([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], 0)


def _edge_groups_sorted(e: torch.Tensor):
    """The distinct rows of (n3, 2) ascending edges in lexicographic order:
    (inv (n3,) each row's group, ea, eb (n3,) the endpoints of group g at
    g and 0 past the last group, the group count)."""
    order = lexsort_rows(e)
    s = e[order]
    first = _first_of_runs(s)
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    inv = torch.empty_like(gid).scatter_(0, order, gid)
    ea = torch.zeros(e.shape[0], dtype=torch.int64, device=e.device)
    eb = torch.zeros_like(ea)
    ea[gid[first]] = s[first, 0].to(torch.int64)
    eb[gid[first]] = s[first, 1].to(torch.int64)
    return inv, ea, eb, first.sum()


def _split4(t: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """The 1:4 split of (T, 3) triangles given the new vertex id of each
    row of `_edges(t)`."""
    T = t.shape[0]
    m01, m12, m20 = mid[:T], mid[T:2 * T], mid[2 * T:]
    t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    return torch.cat([torch.stack([t0, m01, m20], -1), torch.stack([m01, t1, m12], -1),
                      torch.stack([m20, m12, t2], -1), torch.stack([m01, m12, m20], -1)],
                     0).to(torch.int32)


# ---------------------------------------------------------------------------
# Subdivision, clustering, clipping, smoothing
# ---------------------------------------------------------------------------


def subdivide_midpoint(mesh: TriangleMesh, number_of_iterations: int = 1) -> TriangleMesh:
    """Midpoint (1:4) subdivision (ref: TriangleMesh::SubdivideMidpoint).
    Edge midpoints are shared through sorted-edge keys, so the result stays
    watertight where the input was; one new vertex slot per triangle edge,
    the distinct edges' midpoints first."""
    for _ in range(number_of_iterations):
        v = mesh.vertices
        t = _tri(mesh)
        V = v.shape[0]
        inv, ea, eb, n_edges = _edge_groups_sorted(torch.sort(_edges(t), dim=1).values)
        mids = 0.5 * (v[ea] + v[eb])
        live = torch.arange(inv.shape[0], device=v.device) < n_edges
        mesh = TriangleMesh.create(torch.cat([v, mids], 0), _split4(t, V + inv),
                                   vertex_mask=torch.cat([mesh.vertex_mask, live]),
                                   triangle_mask=mesh.triangle_mask.repeat(4))
    return mesh


def subdivide_loop(mesh: TriangleMesh, number_of_iterations: int = 1) -> TriangleMesh:
    """Loop subdivision (ref: TriangleMesh::SubdivideLoop): the topology of
    subdivide_midpoint; interior edge points 3/8 (a + b) + 1/8 (the
    opposite corners), boundary edge points (a + b) / 2, interior vertices
    (1 - n b) v + b sum(neighbours) with b = (5/8 - (3/8 + cos(2 pi / n) /
    4)^2) / n, boundary vertices 3/4 v + 1/8 (boundary neighbours)."""
    for _ in range(number_of_iterations):
        v = mesh.vertices
        t = _tri(mesh)
        V = v.shape[0]
        opp = torch.cat([t[:, 2], t[:, 0], t[:, 1]], 0)
        inv, ea, eb, _ = _edge_groups_sorted(torch.sort(_edges(t), dim=1).values)
        # per distinct edge: its live faces and the sum of their opposite corners
        wl = mesh.triangle_mask.repeat(3).to(torch.float32)
        plan = _scatter_plan(inv, inv.shape[0])
        cnt = _scatter_apply(wl, plan)
        opp_sum = _scatter_apply(v[opp] * wl[:, None], plan)
        va, vb = v[ea], v[eb]
        mids = torch.where((cnt >= 2.0)[:, None], 0.375 * (va + vb) + 0.125 * opp_sum,
                           0.5 * (va + vb))
        edge_live = cnt >= 1.0
        # the original vertices, smoothed over the live distinct edges
        elw = edge_live.to(torch.float32)
        bnd = (cnt == 1.0).to(torch.float32)
        plan = _scatter_plan(torch.cat([ea, eb]), V)
        nb_sum = _scatter_apply(torch.cat([vb * elw[:, None], va * elw[:, None]]), plan)
        val = _scatter_apply(torch.cat([elw, elw]), plan)
        bnd_sum = _scatter_apply(torch.cat([vb * bnd[:, None], va * bnd[:, None]]), plan)
        bnd_cnt = _scatter_apply(torch.cat([bnd, bnd]), plan)
        n = torch.clamp(val, min=1.0)
        beta = (0.625 - (0.375 + 0.25 * torch.cos(2.0 * math.pi / n)) ** 2) / n
        v_new = torch.where((bnd_cnt > 0.0)[:, None], 0.75 * v + 0.125 * bnd_sum,
                            (1.0 - n * beta)[:, None] * v + beta[:, None] * nb_sum)
        v_new = torch.where(((val > 0.0) & mesh.vertex_mask)[:, None], v_new, v)
        mesh = TriangleMesh.create(torch.cat([v_new, mids], 0), _split4(t, V + inv),
                                   vertex_mask=torch.cat([mesh.vertex_mask, edge_live]),
                                   triangle_mask=mesh.triangle_mask.repeat(4))
    return mesh


def _collapse_mask(tri: torch.Tensor) -> torch.Tensor:
    return (tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2]) | (tri[:, 0] == tri[:, 2])


def simplify_vertex_clustering(mesh: TriangleMesh, voxel_size: float) -> TriangleMesh:
    """Vertex clustering (ref: TriangleMesh::SimplifyVertexClustering): the
    vertices of a voxel merge to their mean, slot by slot in the voxels'
    lexicographic order; collapsed triangles are masked out."""
    v = mesh.vertices
    V = v.shape[0]
    c = torch.floor(_div(v, voxel_size)).to(torch.int32)
    c = torch.where(mesh.vertex_mask[:, None], c, _INT_BIG)
    uniq, inv = _unique_rows(c, V, _INT_BIG)
    w = mesh.vertex_mask.to(torch.float32)
    plan = _scatter_plan(inv, V)
    new_v = _scatter_apply(v * w[:, None], plan) / torch.clamp(_scatter_apply(w, plan),
                                                               min=1.0)[:, None]
    new_t = inv[_tri(mesh)].to(torch.int32)
    return TriangleMesh.create(new_v, new_t, vertex_mask=uniq[:, 0] < _INT_BIG,
                               triangle_mask=mesh.triangle_mask & ~_collapse_mask(new_t))


def clip_plane(mesh: TriangleMesh, point, normal) -> TriangleMesh:
    """Keep the half-space n . (x - p) >= 0 (ref: t::TriangleMesh::ClipPlane);
    a triangle crossing the plane is masked out (the reference
    re-triangulates the crossing band)."""
    p = torch.as_tensor(point, dtype=torch.float32, device=mesh.device)
    n = torch.as_tensor(normal, dtype=torch.float32, device=mesh.device)
    keep_v = _dot(mesh.vertices - p, n) >= 0
    t = _tri(mesh)
    keep_t = keep_v[t[:, 0]] & keep_v[t[:, 1]] & keep_v[t[:, 2]]
    return TriangleMesh.create(mesh.vertices, mesh.triangles,
                               vertex_mask=mesh.vertex_mask & keep_v,
                               triangle_mask=mesh.triangle_mask & keep_t,
                               vertex_attrs=mesh.vertex_attrs, triangle_attrs=mesh.triangle_attrs)


def filter_smooth_laplacian(
    mesh: TriangleMesh, number_of_iterations: int = 1, lambda_filter: float = 0.5,
    max_degree: int = 16,
) -> TriangleMesh:
    """Laplacian smoothing (ref: TriangleMesh::FilterSmoothLaplacian):
    v += lambda (mean of the neighbours over every live triangle edge, with
    multiplicity - v); `max_degree` is unused, as in the JAX package."""
    t = _tri(mesh)
    V = mesh.vertices.shape[0]
    src = torch.cat([t[:, 0], t[:, 1], t[:, 2], t[:, 1], t[:, 2], t[:, 0]])
    dst = torch.cat([t[:, 1], t[:, 2], t[:, 0], t[:, 0], t[:, 1], t[:, 2]])
    ew = mesh.triangle_mask.to(torch.float32).repeat(6)
    plan = _scatter_plan(src, V)
    c = _scatter_apply(ew, plan)
    move = ((c > 0) & mesh.vertex_mask)[:, None]
    v = mesh.vertices
    for _ in range(number_of_iterations):
        mean = _scatter_apply(v[dst] * ew[:, None], plan) / torch.clamp(c, min=1.0)[:, None]
        v = torch.where(move, v + lambda_filter * (mean - v), v)
    return TriangleMesh.create(v, mesh.triangles, vertex_mask=mesh.vertex_mask,
                               triangle_mask=mesh.triangle_mask, vertex_attrs=mesh.vertex_attrs,
                               triangle_attrs=mesh.triangle_attrs)


def filter_smooth_taubin(
    mesh: TriangleMesh, number_of_iterations: int = 1,
    lambda_filter: float = 0.5, mu: float = -0.53,
) -> TriangleMesh:
    """Taubin lambda|mu smoothing (ref: TriangleMesh::FilterSmoothTaubin):
    a positive and a negative Laplacian step an iteration."""
    for _ in range(number_of_iterations):
        mesh = filter_smooth_laplacian(mesh, 1, lambda_filter)
        mesh = filter_smooth_laplacian(mesh, 1, mu)
    return mesh


# ---------------------------------------------------------------------------
# Quadric-error decimation
# ---------------------------------------------------------------------------


def _edge_costs(v, t, tmask):
    """The quadric error of collapsing each row of the ascending
    `_edges(t)` into its midpoint (inf on a dead or collapsed row), the
    rows and their midpoints."""
    V = v.shape[0]
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    n = _cross(b - a, c - a)
    n = n / torch.clamp(torch.sqrt(_dot(n, n)), min=1e-12)[:, None]
    plane = torch.cat([n, -_dot(n, a)[:, None]], -1)  # (T, 4)
    K = torch.where(tmask[:, None, None], plane[:, :, None] * plane[:, None, :], 0.0)
    Q = _scatter_add(torch.cat([K, K, K]), t.T.reshape(-1), V)
    e = torch.sort(_edges(t), dim=1).values
    e_live = tmask.repeat(3) & (e[:, 0] != e[:, 1])
    vbar = 0.5 * (v[e[:, 0]] + v[e[:, 1]])
    vb4 = torch.cat([vbar, torch.ones_like(vbar[:, :1])], -1)
    Qe = Q[e[:, 0]] + Q[e[:, 1]]
    qv = ((vb4[:, 0, None] * Qe[:, 0] + vb4[:, 1, None] * Qe[:, 1])
          + vb4[:, 2, None] * Qe[:, 2]) + vb4[:, 3, None] * Qe[:, 3]
    cost = ((qv[:, 0] * vb4[:, 0] + qv[:, 1] * vb4[:, 1]) + qv[:, 2] * vb4[:, 2]) \
        + qv[:, 3] * vb4[:, 3]
    return torch.where(e_live, cost, float("inf")), e, e_live, vbar


def simplify_quadric_decimation(
    mesh: TriangleMesh,
    target_number_of_triangles: int,
    max_rounds: int = 24,
) -> TriangleMesh:
    """Quadric-error decimation (ref: TriangleMesh::SimplifyQuadricDecimation,
    Garland-Heckbert), as the JAX package runs it: each round collapses an
    independent set of cheap edges at once (every vertex claims its
    cheapest incident edge by rank, an edge that wins both its ends
    collapses to its midpoint), at most (live - target) / 2 of them, while
    more than the target live. A round that starts at or under the target
    only masks collapsed triangles, and every round after it repeats it,
    so the loop stops there."""
    v = mesh.vertices
    t = _tri(mesh)
    V = v.shape[0]
    dev = v.device
    vmask, tmask = mesh.vertex_mask, mesh.triangle_mask
    target = int(target_number_of_triangles)
    ids = torch.arange(V, device=dev)
    for _ in range(max_rounds):
        n_live = tmask.sum()
        active = n_live > target
        cost, e, e_live, vbar = _edge_costs(v, t, tmask)
        n3 = e.shape[0]
        rank = torch.empty(n3, dtype=torch.int64, device=dev).scatter_(
            0, torch.argsort(cost, stable=True), torch.arange(n3, device=dev))
        rank = torch.where(e_live, rank, _INT_BIG)
        claim = torch.full((V,), _INT_BIG, dtype=torch.int64, device=dev)
        claim = claim.scatter_reduce(0, e[:, 0], rank, "amin").scatter_reduce(0, e[:, 1], rank,
                                                                              "amin")
        win = active & e_live & (claim[e[:, 0]] == rank) & (claim[e[:, 1]] == rank)
        quota = torch.clamp(torch.div(n_live - target, 2, rounding_mode="floor"), min=1)
        win = win & (torch.cumsum(win.to(torch.int64), 0) - win.to(torch.int64) < quota)
        # b -> a, a to the midpoint; a vertex claims one edge, so each
        # written index is unique
        a_, b_ = e[win, 0], e[win, 1]
        parent = ids.clone()
        parent[b_] = a_
        v = v.clone()
        v[a_] = vbar[win]
        gone = torch.zeros(V, dtype=torch.bool, device=dev)
        gone[b_] = True
        vmask = vmask & ~gone
        t = parent[t]
        tmask = tmask & ~_collapse_mask(t)
        if not bool(active):
            break
    return TriangleMesh.create(v, t.to(torch.int32), vertex_mask=vmask, triangle_mask=tmask)


# ---------------------------------------------------------------------------
# Hole filling
# ---------------------------------------------------------------------------


def fill_holes(mesh: TriangleMesh, hole_size: int = 128) -> TriangleMesh:
    """Close boundary loops with triangle fans
    (ref: t/geometry/TriangleMesh::FillHoles): the boundary directed edges
    (an undirected edge of one live triangle), each boundary vertex's
    successor, pointer doubling to each loop's smallest vertex id, and a
    fan from every boundary edge of a loop of at most `hole_size` vertices
    to it. A vertex with two outgoing boundary edges keeps the last."""
    v = mesh.vertices
    t = _tri(mesh)
    V = v.shape[0]
    dev = v.device
    tmask = mesh.triangle_mask
    de = _edges(t)
    dlive = tmask.repeat(3)
    key = torch.where(dlive[:, None], torch.sort(de, dim=1).values, _INT_BIG)
    order = lexsort_rows(key)
    s = key[order]
    same_prev = torch.zeros(s.shape[0], dtype=torch.bool, device=dev)
    same_prev[1:] = (s[1:] == s[:-1]).all(-1)
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    single = torch.empty_like(same_prev).scatter_(0, order, ~same_prev & ~same_next)
    bnd = dlive & single
    a_, b_ = de[:, 0], de[:, 1]
    nxt = _set_last(torch.full((V,), -1, dtype=torch.int64, device=dev), a_[bnd], b_[bnd])
    is_bnd_v = nxt >= 0
    rounds = max(int(np.ceil(np.log2(max(hole_size, 2)))) + 1, 4)
    ids = torch.arange(V, device=dev)
    rep = torch.where(is_bnd_v, ids, _INT_BIG)
    hop = torch.where(is_bnd_v, nxt, ids)
    for _ in range(rounds):
        rep = torch.minimum(rep, rep[hop])
        hop = hop[hop]
    rep_v = torch.clamp(rep, max=V)
    cnt = torch.zeros(V + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(is_bnd_v, rep_v, V), torch.ones(V, dtype=torch.int64, device=dev))
    loop_len = torch.where(is_bnd_v, cnt[rep_v], 0)
    r = rep[torch.where(bnd, a_, 0)]
    emit = (bnd & (r != a_) & (r != b_) & (loop_len[torch.where(bnd, a_, 0)] <= hole_size)
            & (r < _INT_BIG))
    fan = torch.where(emit[:, None], torch.stack([b_, a_, r], -1), 0).to(torch.int32)
    return TriangleMesh.create(v, torch.cat([mesh.triangles, fan], 0),
                               vertex_mask=mesh.vertex_mask,
                               triangle_mask=torch.cat([tmask, emit]))


# ---------------------------------------------------------------------------
# As-rigid-as-possible deformation
# ---------------------------------------------------------------------------


def deform_as_rigid_as_possible(
    mesh: TriangleMesh,
    constraint_ids,
    constraint_positions,
    max_iter: int = 10,
    n_cg: int = 32,
    max_degree: int = 16,
):
    """ARAP surface deformation (Sorkine-Alexa 2007; ref:
    geometry/TriangleMeshDeformation.cpp DeformAsRigidAsPossible), as the
    JAX package runs it: `max_iter` rounds of a local step (each vertex's
    rotation from the batched 3x3 SVD of its edge fan's covariance, with
    the reflection fixed on det) and a global step (the uniform-weight
    Laplacian system with the constraints as a 1e4 diagonal penalty, `n_cg`
    CG steps from the rest positions). Neighbours are each vertex's first
    `max_degree` directed edge ends, with multiplicity; the triangle mask
    is read as the JAX package reads it (`repeat`, triangle by triangle,
    against edges laid out block by block). Returns the deformed mesh, the
    constraints exactly on their targets."""
    V = mesh.vertices.shape[0]
    dev = mesh.device
    tris = mesh.triangles.to(torch.int64)
    D = max_degree
    e_src = torch.cat([tris[:, 0], tris[:, 1], tris[:, 2], tris[:, 1], tris[:, 2], tris[:, 0]])
    e_dst = torch.cat([tris[:, 1], tris[:, 2], tris[:, 0], tris[:, 0], tris[:, 1], tris[:, 2]])
    tri_live = mesh.triangle_mask.repeat_interleave(3)
    live = torch.cat([tri_live, tri_live])
    order = torch.argsort(torch.where(live, e_src, V), stable=True)
    s_sorted, l_sorted = e_src[order], live[order]
    first = _first_of_runs(s_sorted)
    pos = torch.arange(s_sorted.shape[0], device=dev)
    seg_pos = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    ok = l_sorted & (seg_pos < D)
    nbr = torch.full((V, D), -1, dtype=torch.int64, device=dev)
    nbr[s_sorted[ok], seg_pos[ok]] = e_dst[order][ok]
    nmask = nbr >= 0
    nsafe = torch.clamp(nbr, min=0)
    deg = nmask.sum(1).to(torch.float32)
    nm = nmask[..., None].to(torch.float32)

    p0 = mesh.vertices
    cid = torch.as_tensor(constraint_ids, device=dev).to(torch.int64)
    cpos = torch.as_tensor(constraint_positions, dtype=torch.float32, device=dev)
    pen = torch.zeros(V, device=dev).index_fill_(0, cid, 1e4)
    pen_b = _set_last(torch.zeros((V, 3), device=dev), cid, 1e4 * cpos)

    def A(p):
        return deg[:, None] * p - (p[nsafe] * nm).sum(1) + pen[:, None] * p

    d0 = (p0[:, None, :] - p0[nsafe]) * nm  # (V, D, 3)

    def global_step(R):
        Rsum = 0.5 * (R[:, None] + R[nsafe])
        b = (torch.einsum("vdij,vdj->vdi", Rsum, p0[:, None, :] - p0[nsafe]) * nm).sum(1) + pen_b
        x = p0
        r = b - A(x)
        pdir = r
        rs = (r * r).sum()
        for _ in range(n_cg):
            Ap = A(pdir)
            alpha = rs / torch.clamp((pdir * Ap).sum(), min=1e-30)
            x = x + alpha * pdir
            r = r - alpha * Ap
            rs2 = (r * r).sum()
            pdir = r + (rs2 / torch.clamp(rs, min=1e-30)) * pdir
            rs = rs2
        return x

    def local_step(p):
        d1 = (p[:, None, :] - p[nsafe]) * nm
        S = torch.einsum("vdi,vdj->vij", d0, d1)
        U, _, Vt = torch.linalg.svd(S + 1e-9 * torch.eye(3, device=dev))
        det = torch.linalg.det((U @ Vt).transpose(1, 2))
        Dg = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        return torch.einsum("vji,vj,vkj->vik", Vt, Dg, U)  # V diag(D) U^T

    p = p0
    for _ in range(max_iter):
        p = global_step(local_step(p))
    p = _set_last(p, cid, cpos)
    return dataclasses.replace(mesh, vertices=torch.where(mesh.vertex_mask[:, None], p,
                                                          mesh.vertices))


# ---------------------------------------------------------------------------
# Boolean operations (SDF-based)
# ---------------------------------------------------------------------------


def _boolean_sdf(mesh_a: TriangleMesh, mesh_b: TriangleMesh, op: str,
                 voxel_size: float, padding: float, triangle_capacity: int):
    """Both meshes' signed distances on a dense grid of `voxel_size` over
    the union of their boxes grown by `padding` (two RaycastingScene sweeps,
    parity sign, so the inputs must be watertight), combined by min / max
    (Ricci '73), then marching tetrahedra at 0 (ref:
    TriangleMesh::BooleanUnion / Intersection / Difference, exact in VTK)."""
    dev = mesh_a.device
    lo = (torch.minimum(mesh_a.get_min_bound(), mesh_b.get_min_bound()) - padding).cpu().numpy()
    hi = (torch.maximum(mesh_a.get_max_bound(), mesh_b.get_max_bound()) + padding).cpu().numpy()
    dims = np.maximum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, 2)
    xs = [torch.as_tensor(np.asarray(lo[i] + np.arange(dims[i]) * voxel_size, np.float32),
                          device=dev) for i in range(3)]
    pts = torch.stack(torch.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)

    def sdf_of(mesh):
        v, t = mesh.compact()
        scene = RaycastingScene(device=dev)
        scene.add_triangles(v, t)
        return scene.compute_signed_distance(pts)

    da, db = sdf_of(mesh_a), sdf_of(mesh_b)
    if op == "union":
        d = torch.minimum(da, db)
    elif op == "intersection":
        d = torch.maximum(da, db)
    elif op == "difference":
        d = torch.maximum(da, -db)
    else:
        raise ValueError(op)
    return marching_tetrahedra_dense(d.reshape(tuple(int(x) for x in dims)), iso=0.0,
                                     origin=tuple(lo.tolist()), spacing=voxel_size,
                                     triangle_capacity=triangle_capacity)


def boolean_union(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                  voxel_size: float = 0.02, padding: float = 0.05,
                  triangle_capacity: int = 131072) -> TriangleMesh:
    """(ref: TriangleMesh::BooleanUnion)"""
    return _boolean_sdf(mesh_a, mesh_b, "union", voxel_size, padding, triangle_capacity)


def boolean_intersection(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                         voxel_size: float = 0.02, padding: float = 0.05,
                         triangle_capacity: int = 131072) -> TriangleMesh:
    """(ref: TriangleMesh::BooleanIntersection)"""
    return _boolean_sdf(mesh_a, mesh_b, "intersection", voxel_size, padding, triangle_capacity)


def boolean_difference(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                       voxel_size: float = 0.02, padding: float = 0.05,
                       triangle_capacity: int = 131072) -> TriangleMesh:
    """(ref: TriangleMesh::BooleanDifference)"""
    return _boolean_sdf(mesh_a, mesh_b, "difference", voxel_size, padding, triangle_capacity)


# ---------------------------------------------------------------------------
# UV atlas + texture baking
# ---------------------------------------------------------------------------


def _atlas_layout(n_tris: int, size: int):
    """One square patch of P x P texels per triangle, bpr patches a row
    (the reference's UVAtlas charts are a sequential mesh-cut optimiser).
    Raises ValueError when a patch would be under 4 texels."""
    bpr = int(np.ceil(np.sqrt(max(n_tris, 1))))
    P = size // bpr
    if P < 4:
        raise ValueError(
            f"texture size {size} too small for {n_tris} triangles (needs >= {4 * bpr})")
    return P, bpr


def compute_uv_atlas(mesh: TriangleMesh, size: int = 512) -> TriangleMesh:
    """Per-triangle texture UVs as the triangle attribute "texture_uvs"
    (T, 3, 2) in [0, 1]: triangle i's patch at (i % bpr, i // bpr), its
    corners one texel in from the patch's (ref: TriangleMesh::ComputeUVAtlas)."""
    T = mesh.triangles.shape[0]
    P, bpr = _atlas_layout(T, size)
    t = torch.arange(T, device=mesh.device)
    lo, hi = 1.0, P - 2.0
    corners = torch.tensor([[lo, lo], [hi, lo], [lo, hi]], device=mesh.device)
    orig = torch.stack([(t % bpr) * P, (t // bpr) * P], -1).to(torch.float32)
    uvs = _div(corners[None] + orig[:, None, :], float(size))
    return dataclasses.replace(mesh, triangle_attrs={**mesh.triangle_attrs, "texture_uvs": uvs})


def _patch_barycentrics(P: int, device):
    """(P, P) barycentric maps of the canonical patch, axis 0 = x (u),
    axis 1 = y (v): (lam0, lam1, lam2, inside)."""
    xs = torch.arange(P, dtype=torch.float32, device=device)[:, None]
    ys = torch.arange(P, dtype=torch.float32, device=device)[None, :]
    denom = max(P - 3.0, 1.0)
    lam1 = _div(xs - 1.0, denom) + 0.0 * ys
    lam2 = _div(ys - 1.0, denom) + 0.0 * xs
    lam0 = 1.0 - lam1 - lam2
    inside = (lam0 >= -1e-6) & (lam1 >= -1e-6) & (lam2 >= -1e-6)
    return lam0, lam1, lam2, inside


def _atlas_image(tex: torch.Tensor, bpr: int, P: int, size: int) -> torch.Tensor:
    """(blocks, P, P, C) patches (axes block, x, y) -> the (size, size, C)
    image, blocks row-major, image[y, x]."""
    C = tex.shape[-1]
    img = tex.reshape(bpr, bpr, P, P, C).permute(0, 3, 1, 2, 4).reshape(bpr * P, bpr * P, C)
    full = torch.zeros((size, size, C), dtype=torch.float32, device=tex.device)
    full[:bpr * P, :bpr * P] = img
    return full


def bake_vertex_attr_textures(
    mesh: TriangleMesh, attr_names, size: int = 512
) -> dict:
    """Vertex attributes blended barycentrically over compute_uv_atlas's
    patches (ref: TriangleMesh::BakeVertexAttrTextures): every texel's
    triangle and barycentrics are closed-form, so the bake is one blend
    over (blocks, P, P) texels. Returns {name: (size, size, C) f32}."""
    T = mesh.triangles.shape[0]
    P, bpr = _atlas_layout(T, size)
    pad = bpr * bpr - T
    dev = mesh.device
    lam0, lam1, lam2, inside = _patch_barycentrics(P, dev)
    tri = torch.cat([_tri(mesh), torch.zeros((pad, 3), dtype=torch.int64, device=dev)])
    tmask = torch.cat([mesh.triangle_mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
    live = inside[None, ..., None] & tmask[:, None, None, None]
    out = {}
    for name in attr_names:
        va = mesh.vertex_attrs[name]
        va = va[:, None] if va.dim() == 1 else va
        v012 = va[tri]  # (blocks, 3, C)
        tex = (lam0[None, ..., None] * v012[:, None, None, 0]
               + lam1[None, ..., None] * v012[:, None, None, 1]
               + lam2[None, ..., None] * v012[:, None, None, 2])
        out[name] = _atlas_image(torch.where(live, tex, 0.0), bpr, P, size)
    return out


def bake_triangle_attr_textures(
    mesh: TriangleMesh, attr_names, size: int = 512
) -> dict:
    """Each triangle attribute as a constant fill of its triangle's patch
    (ref: TriangleMesh::BakeTriangleAttrTextures)."""
    T = mesh.triangles.shape[0]
    P, bpr = _atlas_layout(T, size)
    pad = bpr * bpr - T
    dev = mesh.device
    inside = _patch_barycentrics(P, dev)[3]
    tmask = torch.cat([mesh.triangle_mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
    live = inside[None, ..., None] & tmask[:, None, None, None]
    out = {}
    for name in attr_names:
        ta = mesh.triangle_attrs[name]
        ta = ta[:, None] if ta.dim() == 1 else ta
        tp = torch.cat([ta, ta.new_zeros((pad, ta.shape[1]))])
        out[name] = _atlas_image(torch.where(live, tp[:, None, None, :], 0.0), bpr, P, size)
    return out
