"""Triangle-mesh cleanup and connectivity (port of the selection, cleanup
and connectivity family of open3d_tpu/ops/mesh.py: what
`reconstruction.extract_scene_mesh` and users of a TSDF mesh call).

Shapes stay at the mesh's capacity and results are masks, as in the JAX
package. Multi-key sorts are `core.masking.lexsort_rows`;
`jax.ops.segment_min` over an empty segment yields
INT32_MAX, so the port's `amin` reductions start from it.
"""

from __future__ import annotations

import dataclasses

import torch

from open3d_tpu_torch.core.masking import _scatter_add, lexsort_rows
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh

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
    q = torch.where(mesh.vertex_mask[:, None], q, _INT_BIG)
    order = lexsort_rows(q)
    first = _first_of_runs(q[order])
    gid_sorted = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    inv = torch.empty(V, dtype=torch.int32, device=v.device).scatter_(0, order, gid_sorted)
    uniq0 = torch.full((V,), _INT_BIG, dtype=torch.int32, device=v.device)
    uniq0[:int(first.sum())] = q[order][first, 0]
    rep = _segment_min(torch.arange(V, dtype=torch.int32, device=v.device), inv, V)
    return TriangleMesh.create(
        v[torch.clamp(rep, 0, V - 1).to(torch.int64)], inv[_tri(mesh)],
        vertex_mask=uniq0 < _INT_BIG, triangle_mask=mesh.triangle_mask,
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
