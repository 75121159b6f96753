"""3D ML ops (port of open3d_tpu/ml/ops.py): Open3D-ML's voxelize and voxel
pooling, ball query, k-NN and radius search, three_nn / three_interpolate,
the CSR helpers, rotated-box IoU and NMS, continuous and sparse
convolution, RoI pooling and trilinear devoxelisation.

Every function runs on the device of its input tensors; scalars and lists
(voxel sizes, ranges, extents) are taken onto that device. Ragged
structures use the reference's CSR convention (values + row_splits) with
fixed caps, as in the JAX package. Gradients come from autograd.

Where the JAX package relies on a scatter or a sum whose order XLA picks,
the port fixes the order, so that the card and the CPU give the same bits
wherever their elementwise arithmetic does:
- float scatter-adds go through `core.masking._scatter_add` (a stable sort
  by index, then one segmented sum), and so do the gradients of the row
  gathers whose backward is a scatter-add (`_gather_rows`);
- short sums (a polygon's shoelace terms, the eight trilinear corners) add
  their terms one at a time in index order.
The JAX package's own order differs, so the port agrees with it within
float32 rounding, not bit for bit (tests/test_torch_ml_ops.py states the
bars).

`continuous_conv` computes the reference's sum in another order: the
neighbours' features are first accumulated by filter cell into an
(M, kx*ky*kz, Cin) tensor, which is then contracted with the filter bank
once. The JAX package gathers an (M, max_nn, Cin, Cout) slice of the filter
bank for each of the eight corners instead, 8.6 GB per corner in float32
at M = 16 384, max_nn 64, 32 -> 64 channels.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core import nns
from open3d_tpu_torch.core.masking import _div, _scatter_add, _scatter_apply, _scatter_plan, _unique_rows
from open3d_tpu_torch.ops.pointcloud import farthest_point_down_sample  # noqa: F401

_NO_VOXEL = 2**31 - 1  # the sort key of a point outside the voxelize range
_POOL_FILL = 2**30  # voxel_pooling's padding coordinate (jnp.unique's fill_value)
_CAP = 16  # vertices a clipped polygon may hold, as in the reference
_PAIR_CHUNK = 1 << 18  # box pairs clipped at once: ~0.5 GB of temporaries
_CORNERS = tuple(itertools.product((0, 1), repeat=3))  # (dx, dy, dz), dz fastest


def _on(x, ref: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """x (a number, list, array or tensor) as a `dtype` tensor on ref's device."""
    return torch.as_tensor(x, dtype=dtype, device=ref.device)


class _RowGather(torch.autograd.Function):
    """table[idx] whose gradient sums the rows by index through
    `_scatter_add`, in a fixed order (indexing's own backward adds them with
    atomics on the card, in whatever order they land)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = grad.reshape((idx.numel(),) + tuple(grad.shape[idx.ndim:]))
        return _scatter_add(g, idx.reshape(-1), ctx.rows), None


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and table.requires_grad:
        return _RowGather.apply(table, idx)
    return table[idx]


def _first_in_run(s: torch.Tensor) -> torch.Tensor:
    """(n,) bool: s[i] differs from s[i - 1] (True at 0) for sorted s."""
    first = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    return first


def _rank_in_run(first: torch.Tensor) -> torch.Tensor:
    """(n,) int64: each position's distance from the start of its run."""
    ar = torch.arange(first.shape[0], device=first.device)
    return ar - torch.cummax(torch.where(first, ar, 0), 0).values


# ---------------------------------------------------------------- voxelize --
def voxelize(
    points: torch.Tensor,
    voxel_size,
    points_range_min,
    points_range_max,
    max_points_per_voxel: int = 64,
    max_voxels: int = 4096,
):
    """Group points into occupied voxels (Open3D-ML's Voxelize). Returns
    (voxel_coords (V, 3) int32, voxel_point_indices (V, max_points) int32
    padded with -1, voxel_point_counts (V,) int32, num_voxels () int32) with
    V = max_voxels; rows beyond num_voxels have coords -1. Voxels are in
    ascending linear id, the points of a voxel in input order (a stable
    sort, as jnp.argsort's)."""
    points = points.to(torch.float32)
    vs = _on(voxel_size, points).expand(3)
    lo = _on(points_range_min, points)
    hi = _on(points_range_max, points)
    inside = ((points >= lo) & (points <= hi)).all(-1)
    coords = torch.floor((points - lo) / vs).to(torch.int32)
    dims = torch.clamp(torch.ceil((hi - lo) / vs).to(torch.int32), min=1)
    coords = torch.minimum(torch.clamp(coords, min=0), dims - 1)
    lin = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    lin = torch.where(inside, lin, _NO_VOXEL)

    slin, order = torch.sort(lin, stable=True)
    real = slin < _NO_VOXEL
    is_first = _first_in_run(slin) & real
    rank = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    rank = torch.where(real, rank, max_voxels)
    num_voxels = torch.clamp(torch.where(is_first, rank + 1, 0).amax(), max=max_voxels)
    within = _rank_in_run(is_first)

    ok = (rank < max_voxels) & (within < max_points_per_voxel)
    spare = max_voxels * max_points_per_voxel  # the dropped writes land here
    flat = torch.where(ok, rank.to(torch.int64) * max_points_per_voxel + within, spare)
    vpi = torch.full((spare + 1,), -1, dtype=torch.int32, device=points.device)
    vpi.scatter_(0, flat, order.to(torch.int32))
    vpi = vpi[:-1].reshape(max_voxels, max_points_per_voxel)

    counts = torch.bincount(torch.clamp(rank, max=max_voxels).to(torch.int64),
                            minlength=max_voxels + 1)[:max_voxels].to(torch.int32)
    rows = torch.where(is_first & (rank < max_voxels), rank, max_voxels).to(torch.int64)
    vcoords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=points.device)
    vcoords[rows] = coords[order]
    return vcoords[:max_voxels], vpi, torch.clamp(counts, max=max_points_per_voxel), num_voxels


def voxel_pooling(points, features, voxel_size, position_fn: str = "average",
                  feature_fn: str = "average", max_voxels: int = 4096):
    """Pool the features of points in the same voxel (Open3D-ML's
    VoxelPooling). Returns (pooled_positions, pooled_features, valid_mask)
    with the fixed cap max_voxels; voxels in lexicographic order of their
    integer coordinates, as jnp.unique gives them."""
    points = points.to(torch.float32)
    features = features.to(torch.float32)
    coords = torch.floor(_div(points, voxel_size)).to(torch.int32)
    uniq, seg = _unique_rows(coords, max_voxels, _POOL_FILL)
    valid = uniq[:, 0] < _POOL_FILL
    plan = _scatter_plan(seg, max_voxels)
    cnt = _scatter_apply(torch.ones_like(points[:, 0]), plan)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    if position_fn == "center":
        pos = (uniq.to(torch.float32) + 0.5) * voxel_size
    else:  # average; nearest_neighbor takes the mean too, as in the reference
        pos = _scatter_apply(points, plan) / denom
    if feature_fn == "average":
        feat = _scatter_apply(features, plan) / denom
    else:  # max, else min: exact in any order
        red, init = ("amax", -float("inf")) if feature_fn == "max" else ("amin", float("inf"))
        out = features.new_full((max_voxels + 1,) + tuple(features.shape[1:]), init)
        idx = torch.clamp(seg, max=max_voxels).reshape((-1,) + (1,) * (features.ndim - 1))
        out.scatter_reduce_(0, idx.expand_as(features), features, red)
        feat = torch.where(valid[:, None], out[:max_voxels], 0.0)
    return pos, feat, valid


# ----------------------------------------------------------- neighborhoods --
def ball_query(points, queries, radius: float, nsample: int):
    """Indices of up to nsample points within radius of each query, nearest
    first (Open3D-ML's BallQuery); empty slots repeat the first index found
    (the reference's convention), all -1 when none. Returns (idx, count)."""
    idx, d2, cnt = nns.hybrid_search(queries, points, radius, nsample)
    filled = torch.where(idx >= 0, idx, idx[:, :1])
    return torch.where(cnt[:, None] > 0, filled, -1), cnt


def knn_search(queries, points, k: int):
    """Exact k-NN (core/nns.py's tiled brute force)."""
    return nns.knn_search(queries, points, k)


def fixed_radius_search(queries, points, radius: float, max_nn: int = 64):
    return nns.fixed_radius_search(queries, points, radius, max_nn)


def three_nn(queries, points):
    """The 3 nearest neighbours and their inverse-squared-distance weights,
    normalised (Open3D-ML's three_nn)."""
    idx, d2 = nns.knn_search(queries, points, 3)
    w = 1.0 / torch.clamp(d2, min=1e-10)
    return idx, w / w.sum(-1, keepdim=True)


def three_interpolate(features, idx, weights):
    """features (M, C) at idx (N, 3) weighted by weights (N, 3) -> (N, C)."""
    return torch.einsum("nkc,nk->nc", features[torch.clamp(idx, min=0).to(torch.int64)], weights)


def _row_of(row_splits: torch.Tensor, n: int) -> torch.Tensor:
    """The CSR row of each of n entries (int64)."""
    rs = row_splits.to(torch.int64).contiguous()
    return torch.searchsorted(rs, torch.arange(n, device=rs.device), right=True) - 1


def reduce_subarrays_sum(values, row_splits):
    """Sum each CSR row (Open3D-ML's ReduceSubarraysSum)."""
    return _scatter_add(values, _row_of(row_splits, values.shape[0]), row_splits.shape[0] - 1)


def invert_neighbors_list(num_points: int, neighbors_index, row_splits, k: int = 64):
    """Invert a CSR neighbour list (Open3D-ML's InvertNeighborsList): who
    lists each point as a neighbour, in edge order, capped at k per row and
    -1 padded. Returns (inverted (num_points, k) int32, counts (num_points,)
    int32 capped at k)."""
    n_edges = neighbors_index.shape[0]
    src = _row_of(row_splits, n_edges)
    dst = neighbors_index.to(torch.int64)
    sdst, order = torch.sort(dst, stable=True)
    within = _rank_in_run(_first_in_run(sdst))
    ok = (within < k) & (sdst >= 0) & (sdst < num_points)
    flat = torch.where(ok, sdst * k + within, num_points * k)
    out = torch.full((num_points * k + 1,), -1, dtype=torch.int32, device=dst.device)
    out.scatter_(0, flat, src[order].to(torch.int32))
    counts = torch.bincount(torch.clamp(dst, 0, num_points), minlength=num_points + 1)
    return out[:-1].reshape(num_points, k), torch.clamp(counts[:num_points], max=k).to(torch.int32)


def ragged_to_dense(values, row_splits, out_col_size: int, default_value):
    """CSR -> dense, rows cut at out_col_size and padded with default_value
    (Open3D-ML's RaggedToDense)."""
    n_rows = row_splits.shape[0] - 1
    n = values.shape[0]
    rows = _row_of(row_splits, n)
    within = torch.arange(n, device=values.device) - row_splits.to(torch.int64)[rows]
    flat = torch.where(within < out_col_size, rows * out_col_size + within, n_rows * out_col_size)
    out = values.new_full((n_rows * out_col_size + 1,) + tuple(values.shape[1:]), default_value)
    out[flat] = values
    return out[:-1].reshape((n_rows, out_col_size) + tuple(values.shape[1:]))


# ------------------------------------------------------------- boxes / NMS --
def _rot_box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """BEV corners of (x, z, dx, dz, yaw) boxes -> (N, 4, 2), counter-clockwise."""
    x, z, dx, dz, yaw = boxes.unbind(1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    ex, ez = dx / 2, dz / 2
    lx = torch.stack([ex, -ex, -ex, ex], 1)
    lz = torch.stack([ez, ez, -ez, -ez], 1)
    px = c[:, None] * lx - s[:, None] * lz
    pz = s[:, None] * lx + c[:, None] * lz
    return torch.stack([px + x[:, None], pz + z[:, None]], -1)


def _clip_polys(subject: torch.Tensor, clip: torch.Tensor):
    """Sutherland-Hodgman clip of each quad of subject (P, 4, 2) by the
    convex quad of the same row of clip (P, 4, 2): the reference's per-pair
    scan over the four clip edges, each edge one batched step over the pair
    axis, with its capacity of 16 vertices. Returns (poly (P, 16, 2),
    count (P,))."""
    P = subject.shape[0]
    dev = subject.device
    poly = subject.new_zeros((P, _CAP, 2))
    poly[:, :4] = subject
    cnt = torch.full((P,), 4, dtype=torch.int64, device=dev)
    slot = torch.arange(_CAP, device=dev)
    for e in range(4):
        a, b = clip[:, e], clip[:, (e + 1) % 4]
        d0, d1 = (b[:, 0] - a[:, 0])[:, None], (b[:, 1] - a[:, 1])[:, None]
        a0, a1 = a[:, 0:1], a[:, 1:2]
        # the successor of vertex cnt - 1 is vertex 0, not the padding slot cnt
        nxt = torch.where((slot == cnt[:, None] - 1)[..., None], poly[:, :1], torch.roll(poly, -1, 1))
        ins_cur = d0 * (poly[..., 1] - a1) - d1 * (poly[..., 0] - a0) >= -1e-9
        ins_nxt = d0 * (nxt[..., 1] - a1) - d1 * (nxt[..., 0] - a0) >= -1e-9
        step = nxt - poly
        t_den = step[..., 0] * -d1 + step[..., 1] * d0
        t_num = -(-d1 * (poly[..., 0] - a0) + d0 * (poly[..., 1] - a1))
        t = t_num / torch.where(t_den.abs() > 1e-12, t_den, 1.0)
        inter = poly + t[..., None] * step
        valid = slot < cnt[:, None]
        # for each input vertex emit [itself if inside, the crossing if any]
        out_pts = torch.stack([poly, inter], 2).reshape(P, 2 * _CAP, 2)
        out_ok = torch.stack([ins_cur & valid, (ins_cur != ins_nxt) & valid], 2).reshape(P, 2 * _CAP)
        pos = torch.cumsum(out_ok, 1) - 1
        tgt = torch.where(out_ok & (pos < _CAP), pos, _CAP)  # slot _CAP is dropped
        newp = poly.new_zeros((P, _CAP + 1, 2))
        newp.scatter_(1, tgt[..., None].expand(-1, -1, 2), out_pts)
        poly = newp[:, :_CAP]
        cnt = torch.clamp(out_ok.sum(1), max=_CAP)
    return poly, cnt


def _poly_areas(poly: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Shoelace area of each padded polygon, its terms added in vertex order."""
    slot = torch.arange(_CAP, device=poly.device)
    nxt = torch.where((slot == cnt[:, None] - 1)[..., None], poly[:, :1], torch.roll(poly, -1, 1))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(slot < cnt[:, None], cross, 0.0)
    total = cross[:, 0]
    for j in range(1, _CAP):
        total = total + cross[:, j]
    return 0.5 * total.abs()


def _bev_intersections(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(A, B) intersection areas of the quads ca (A, 4, 2) clipped by cb
    (B, 4, 2), over a flat pair axis in chunks of about _PAIR_CHUNK pairs."""
    A, B = ca.shape[0], cb.shape[0]
    out = ca.new_empty((A, B))
    rows = max(1, _PAIR_CHUNK // max(B, 1))
    for s in range(0, A, rows):
        r = min(rows, A - s)
        subj = ca[s:s + r, None].expand(r, B, 4, 2).reshape(r * B, 4, 2)
        clip = cb[None].expand(r, B, 4, 2).reshape(r * B, 4, 2)
        out[s:s + r] = _poly_areas(*_clip_polys(subj, clip)).reshape(r, B)
    return out


def iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU of (x, z, dx, dz, yaw) boxes, all pairs (A, B), by
    exact polygon clipping (Open3D-ML's IoUBev)."""
    boxes_a, boxes_b = boxes_a.to(torch.float32), boxes_b.to(torch.float32)
    inter = _bev_intersections(_rot_box_corners(boxes_a), _rot_box_corners(boxes_b))
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def iou_3d(boxes_a, boxes_b):
    """3D IoU of (x, y, z, dx, dy, dz, yaw) boxes, yaw about y (Open3D-ML's
    IoU3d): the BEV intersection times the vertical overlap."""
    boxes_a, boxes_b = boxes_a.to(torch.float32), boxes_b.to(torch.float32)
    bev = [0, 2, 3, 5, 6]
    inter_bev = _bev_intersections(_rot_box_corners(boxes_a[:, bev]),
                                   _rot_box_corners(boxes_b[:, bev]))
    ymin_a, ymax_a = boxes_a[:, 1] - boxes_a[:, 4] / 2, boxes_a[:, 1] + boxes_a[:, 4] / 2
    ymin_b, ymax_b = boxes_b[:, 1] - boxes_b[:, 4] / 2, boxes_b[:, 1] + boxes_b[:, 4] / 2
    h = torch.clamp(torch.minimum(ymax_a[:, None], ymax_b[None, :])
                    - torch.maximum(ymin_a[:, None], ymin_b[None, :]), min=0.0)
    inter = inter_bev * h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return inter / torch.clamp(vol_a[:, None] + vol_b[None, :] - inter, min=1e-9)


def nms(boxes, scores, iou_threshold: float):
    """Rotated-BEV NMS (Open3D-ML's Nms): greedy suppression in descending
    score order (ties in input order) on the all-pairs IoU. The reference's
    fori_loop runs as N dependent device steps with no read back to the
    host. Returns a keep mask (N,) bool."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True).indices
    b = boxes[order]
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou_bev(b, b) > iou_threshold) & later
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep = keep & ~(sup[i] & keep[i])
    return torch.empty_like(keep).scatter_(0, order, keep)


# ------------------------------------------------------------ convolutions --
def continuous_conv(
    features, points, queries, weights, extents, max_nn: int = 32,
    interpolation: str = "linear",
):
    """Continuous convolution (Open3D-ML's ContinuousConv, Ummenhofer et al.
    2020): each query's neighbours within the box of `extents` are mapped
    into the filter grid (ball-to-cube for "linear", then trilinear
    weights) and contracted with the filter bank; normalised by the
    neighbour count.

    features (N, Cin), points (N, 3), queries (M, 3), weights (kx, ky, kz,
    Cin, Cout), extents a number or three (a host value: it sets the search
    radius). Returns (M, Cout). The weighted features are summed by filter
    cell into (M, kx*ky*kz, Cin), one `_scatter_add` a corner, then
    contracted with the bank in one product; no (M, max_nn, Cin, Cout)
    tensor is built."""
    kx, ky, kz, cin, cout = weights.shape
    ext_host = np.asarray(extents.detach().cpu() if torch.is_tensor(extents) else extents,
                          np.float32)
    ext = _on(ext_host, points).expand(3)
    radius = float(np.max(ext_host)) * 0.5 * (3.0**0.5)  # the box's circumradius
    idx, _, cnt = nns.hybrid_search(queries, points, radius, max_nn)
    M, k = idx.shape
    safe = torch.clamp(idx, min=0).to(torch.int64)
    rel = (_gather_rows(points, safe) - queries[:, None, :]) / (ext * 0.5)  # [-1, 1] in the box
    inbox = (rel.abs() <= 1.0).all(-1) & (idx >= 0)

    # ball-to-cube radial mapping, then into the filter grid
    r = torch.sqrt(nns._sq3(rel))[..., None]
    linf = rel.abs().amax(-1, keepdim=True)
    scale = torch.where(r > 1e-8, linf / torch.clamp(r, min=1e-8), 1.0)
    cube = rel * scale if interpolation == "linear" else rel
    grid = (cube + 1.0) * 0.5 * _on([kx - 1, ky - 1, kz - 1], points)
    g0 = torch.floor(grid).to(torch.int64)
    frac = grid - g0.to(grid.dtype)
    feat = torch.where(inbox[..., None], _gather_rows(features, safe), 0.0)  # (M, k, Cin)

    L = kx * ky * kz
    cell0 = torch.arange(M, device=points.device)[:, None] * L
    acc = None
    for dx, dy, dz in _CORNERS:
        gx = torch.clamp(g0[..., 0] + dx, 0, kx - 1)
        gy = torch.clamp(g0[..., 1] + dy, 0, ky - 1)
        gz = torch.clamp(g0[..., 2] + dz, 0, kz - 1)
        w8 = ((frac[..., 0] if dx else 1 - frac[..., 0])
              * (frac[..., 1] if dy else 1 - frac[..., 1])
              * (frac[..., 2] if dz else 1 - frac[..., 2]))  # (M, k)
        cell = cell0 + (gx * ky + gy) * kz + gz
        part = _scatter_add((feat * w8[..., None]).reshape(M * k, cin), cell.reshape(-1), M * L)
        acc = part if acc is None else acc + part
    out = acc.reshape(M, L * cin) @ weights.reshape(L * cin, cout)
    return out / torch.clamp(cnt, min=1)[:, None]


def sparse_conv(features, coords, weights, queries_coords=None):
    """Submanifold sparse convolution on integer voxel coordinates
    (Open3D-ML's SparseConv): each kernel offset is looked up in a
    coordinate hash map and contracted with one product.

    features (N, Cin), coords (N, 3) int32 (distinct), weights (K, K, K,
    Cin, Cout) with odd K. Output (Q, Cout) at queries_coords (default: the
    input coords)."""
    K = weights.shape[0]
    cin, cout = weights.shape[3], weights.shape[4]
    if queries_coords is None:
        queries_coords = coords
    dev = features.device
    N = coords.shape[0]
    cap = max(4 * N, 64)  # load factor <= 0.25
    table, slot, ok = hm.activate(hm.make_table(cap, device=dev), hm.pack_coords(coords),
                                  max_rounds=32)
    # activate gives distinct coordinates distinct slots, so this set writes
    # no slot twice; a row that failed to insert writes the spare row `cap`,
    # which the misses below read, as in the JAX package
    feat_by_slot = features.new_zeros((cap + 1, cin)).index_put(
        (torch.where(ok, slot, cap).to(torch.int64),), features)
    half = K // 2
    qc = queries_coords.to(torch.int32)
    out = torch.zeros((qc.shape[0], cout), dtype=torch.float32, device=dev)
    for ox, oy, oz in itertools.product(range(-half, half + 1), repeat=3):
        off = torch.tensor([ox, oy, oz], dtype=torch.int32, device=dev)
        qslot, hit = hm.find(table, hm.pack_coords(qc + off), max_probes=16)
        f = _gather_rows(feat_by_slot, torch.where(hit, qslot, cap).to(torch.int64))
        out = out + f @ weights[ox + half, oy + half, oz + half]
    return out


# --------------------------------------------------- roi pool / devoxelize --
def roi_pool(points, features, boxes, num_sampled_points: int = 512):
    """Pool the points and features inside rotated 3D RoI boxes (Open3D-ML's
    RoiPool, PointRCNN-style): per box, the points whose (x, y) lie in the
    yaw-rotated footprint and z within the height span, in input order, cut
    or padded to num_sampled_points by repeating the first hit.

    points (N, 3), features (N, C), boxes (B, 7) [cx, cy, cz, dx, dy, dz,
    heading]. Returns (pooled (B, S, 3 + C), empty (B,) bool). All boxes at
    once: a (B, N) membership mask and one batched stable compaction."""
    N = points.shape[0]
    S = int(num_sampled_points)
    ca, sa = torch.cos(-boxes[:, 6])[:, None], torch.sin(-boxes[:, 6])[:, None]
    rel = points[None] - boxes[:, None, :3]  # (B, N, 3)
    x = rel[..., 0] * ca - rel[..., 1] * sa
    y = rel[..., 0] * sa + rel[..., 1] * ca
    inside = ((x.abs() <= boxes[:, 3:4] * 0.5) & (y.abs() <= boxes[:, 4:5] * 0.5)
              & (rel[..., 2].abs() <= boxes[:, 5:6] * 0.5))
    # the True positions first, each row in input order (core.masking's
    # compact_indices a row); past the row's count every slot repeats the first
    order = torch.sort((~inside).to(torch.int8), dim=1, stable=True).indices
    if S > N:
        order = torch.cat([order, order.new_full((order.shape[0], S - N), N - 1)], 1)
    idx = order[:, :S]
    cnt = torch.clamp(inside.sum(1), max=S)
    live = torch.arange(S, device=points.device)[None, :] < cnt[:, None]
    sel = torch.where(live, idx, idx[:, :1])
    pooled = torch.cat([points[sel], features[sel]], dim=-1)
    return torch.where((cnt > 0)[:, None, None], pooled, 0.0), cnt == 0


def trilinear_devoxelize(voxel_features, coords, resolution: int):
    """Trilinear interpolation of dense voxel features at point coordinates
    (PVCNN's TrilinearDevoxelize). voxel_features (C, R, R, R); coords
    (N, 3) in voxel units [0, R-1]. Returns (features (N, C), indices (N, 8)
    int32, weights (N, 8)), the corners in (dx, dy, dz) order, dz fastest;
    gradients come from autograd."""
    R = int(resolution)
    C = voxel_features.shape[0]
    rows = voxel_features.reshape(C, -1).t()  # (R^3, C)
    g = torch.clamp(coords, 0.0, R - 1 - 1e-5)
    g0 = torch.floor(g).to(torch.int64)
    f = g - g0.to(g.dtype)
    out, idxs, wts = None, [], []
    for dx, dy, dz in _CORNERS:
        i = (torch.clamp(g0[:, 0] + dx, max=R - 1) * R * R + torch.clamp(g0[:, 1] + dy, max=R - 1) * R
             + torch.clamp(g0[:, 2] + dz, max=R - 1))
        w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
             * (f[:, 2] if dz else 1 - f[:, 2]))
        term = _gather_rows(rows, i) * w[:, None]
        out = term if out is None else out + term
        idxs.append(i)
        wts.append(w)
    return out, torch.stack(idxs, -1).to(torch.int32), torch.stack(wts, -1)
