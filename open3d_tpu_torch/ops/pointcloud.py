"""Point-cloud operations: down-sampling, normals, outlier removal (port of
open3d_tpu/ops/pointcloud.py).

Every operation keeps the fixed-capacity idiom: it returns a cloud of the
input's capacity (or a smaller one asked for) with an updated mask.

- voxel_down_sample sorts the points by voxel and averages each voxel's
  run of sorted rows with a sequential segmented sum, so its result is the
  same on the card and on the CPU and from one run to the next (no float
  atomics).
- estimate_normals gathers (radius-capped) k-NN neighbourhoods through
  core.nns and takes the smallest-eigenvalue direction of each 3x3
  covariance (core.linalg.eigh3x3, closed form).

- extrude_linear and extrude_rotation sweep every point into line
  segments and return a geometry.lineset.LineSet.
"""

from __future__ import annotations

import math

import torch

from open3d_tpu_torch.core import linalg, nns
from open3d_tpu_torch.core.masking import FAR_COORD, _div, _scatter_add, lexsort_rows
from open3d_tpu_torch.geometry.pointcloud import PointCloud


def voxel_down_sample(
    pcd: PointCloud, voxel_size: float, capacity: int | None = None
) -> PointCloud:
    """Average the points (and attributes) of each occupied voxel. Result
    rows 0..n_voxels-1 are valid, in the lexicographic order of their voxel
    coordinates (x, then y, then z).

    capacity: an optional SMALLER output capacity: valid rows are compacted
    to the front, so shrinking is a slice; voxels beyond `capacity` are
    dropped (count() == capacity shows it)."""
    N = pcd.capacity
    pos = pcd.positions
    mask = pcd.mask
    # voxel coordinates; invalid rows go to huge coordinates and sort last
    coords = torch.floor(_div(pos, voxel_size)).to(torch.int32)
    coords = torch.where(mask[:, None], coords, 2**30)
    order = lexsort_rows(coords)  # jnp.lexsort((z, y, x))
    sc = coords[order]
    sorted_mask = mask[order]
    first = torch.ones(N, dtype=torch.bool, device=pos.device)
    first[1:] = torch.any(sc[1:] != sc[:-1], dim=1)
    first = first & sorted_mask
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    seg_id = torch.where(sorted_mask, seg_id, N - 1)  # invalid rows join the last slot
    n_seg = first.to(torch.int64).sum()
    # seg_id is non-decreasing (valid rows sort first), so the segments are
    # runs of sorted rows; segment_reduce adds each run in row order from 0,
    # as the JAX package's segment_sum does on the CPU
    lengths = torch.bincount(seg_id, minlength=N)
    w = sorted_mask.to(torch.float32)
    cnts = torch.segment_reduce(w, "sum", lengths=lengths, unsafe=True)

    def seg_mean(vals_sorted):
        ww = w.reshape((N,) + (1,) * (vals_sorted.ndim - 1))
        sums = torch.segment_reduce(vals_sorted * ww, "sum", lengths=lengths, unsafe=True)
        return sums / torch.clamp(cnts.reshape(ww.shape), min=1.0)

    new_mask = torch.arange(N, device=pos.device) < n_seg
    new_pos = torch.where(new_mask[:, None], seg_mean(pos[order]), FAR_COORD)
    new_attrs = {k: seg_mean(v[order]) for k, v in pcd.attrs.items()}
    if "normals" in new_attrs:
        nrm = new_attrs["normals"]
        new_attrs["normals"] = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-12)
    if capacity is not None and capacity < N:
        new_pos = new_pos[:capacity]
        new_mask = new_mask[:capacity]
        new_attrs = {k: v[:capacity] for k, v in new_attrs.items()}
    return PointCloud(positions=new_pos, mask=new_mask, attrs=new_attrs)


def random_down_sample(pcd: PointCloud, sampling_ratio: float, key) -> PointCloud:
    """Keep each valid point with probability `sampling_ratio`. `key` is a
    torch.Generator; the uniforms are drawn on its own device."""
    keep = torch.rand((pcd.capacity,), generator=key, device=key.device) < sampling_ratio
    return pcd.select_by_mask(keep.to(pcd.mask.device))


def uniform_down_sample(pcd: PointCloud, every_k_points: int) -> PointCloud:
    """Keep every k-th valid point, by valid ordinal."""
    ordinal = torch.cumsum(pcd.mask.to(torch.int64), 0) - 1
    return pcd.select_by_mask(ordinal % every_k_points == 0)


def farthest_point_down_sample(pcd: PointCloud, num_samples: int) -> PointCloud:
    """Iterative farthest-point sampling from the first valid point:
    num_samples - 1 rounds, each adding the unselected valid point farthest
    from the selected set (the first one on a tie). No host sync."""
    pos = pcd.valid_positions()
    N = pcd.capacity
    # the chosen row stays a 1-element tensor, so nothing is read back
    last = torch.argmax(pcd.mask.to(torch.int8)).reshape(1)
    selected = torch.zeros(N, dtype=torch.bool, device=pos.device).index_fill_(0, last, True)
    min_d2 = torch.full((N,), float("inf"), dtype=torch.float32, device=pos.device)
    for _ in range(max(num_samples - 1, 0)):
        min_d2 = torch.minimum(min_d2, nns._sq3(pos - pos.index_select(0, last)))
        cand = torch.where(pcd.mask & ~selected, min_d2, -1.0)
        last = torch.argmax(cand).reshape(1)
        selected.index_fill_(0, last, True)
    return pcd.select_by_mask(selected)


def gather_neighbors(values: torch.Tensor, idx: torch.Tensor, fill=0.0):
    """Gather (N, k) neighbour rows from (M, ...) values; idx < 0 -> fill."""
    out = values[torch.clamp(idx, min=0).to(torch.int64)]
    m = idx >= 0
    m = m[..., None] if out.ndim == idx.ndim + 1 else m
    return torch.where(m, out, fill)


def _neighbourhood_covariance(pos, idx):
    """(N, 3, 3) covariance of each point's gathered neighbours (idx < 0
    slots left out), divided by their count."""
    nbr = gather_neighbors(pos, idx)  # (N, k, 3)
    w = (idx >= 0).to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (nbr * w).sum(1) / cnt
    d = (nbr - mean[:, None, :]) * w
    return torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]


def estimate_normals(
    pcd: PointCloud,
    max_nn: int = 30,
    radius: float | None = None,
    nns_grid_threshold: int | None = 65536,
    nns_max_per_cell: int = 64,
) -> PointCloud:
    """Per-point normals: the smallest-eigenvalue direction of the
    covariance of each point's k nearest neighbours (within `radius` when
    given). nns_grid_threshold / nns_max_per_cell pass through to the
    hybrid search (None forces its exact path). The sign is arbitrary."""
    pos = pcd.positions
    if radius is None:
        idx, _ = nns.knn_search(pos, pos, max_nn, target_mask=pcd.mask)
    else:
        idx, _, _ = nns.hybrid_search(
            pos, pos, radius, max_nn, target_mask=pcd.mask,
            grid_threshold=nns_grid_threshold, max_per_cell=nns_max_per_cell,
        )
    _, evecs = linalg.eigh3x3(_neighbourhood_covariance(pos, idx))
    normals = torch.where(pcd.mask[:, None], evecs[..., 0], 0.0)
    return pcd.with_attrs(normals=normals)


def estimate_covariances(
    pcd: PointCloud,
    max_nn: int = 30,
    radius: float | None = None,
) -> PointCloud:
    """Per-point neighbourhood covariances as the (N, 3, 3) attribute
    "covariances" (the generalized ICP's input)."""
    pos = pcd.positions
    if radius is None:
        idx, _ = nns.knn_search(pos, pos, max_nn, target_mask=pcd.mask)
    else:
        idx, _, _ = nns.hybrid_search(pos, pos, radius, max_nn, target_mask=pcd.mask)
    return pcd.with_attrs(covariances=_neighbourhood_covariance(pos, idx))


def orient_normals_to_align_with_direction(pcd: PointCloud, direction=(0.0, 0.0, 1.0)) -> PointCloud:
    n = pcd.attrs["normals"]
    d = torch.as_tensor(direction, dtype=torch.float32, device=n.device)
    flip = torch.sum(n * d, dim=-1, keepdim=True) < 0
    return pcd.with_attrs(normals=torch.where(flip, -n, n))


def orient_normals_towards_camera_location(pcd: PointCloud, camera=(0.0, 0.0, 0.0)) -> PointCloud:
    n = pcd.attrs["normals"]
    cam = torch.as_tensor(camera, dtype=torch.float32, device=n.device)
    flip = torch.sum(n * (cam - pcd.positions), dim=-1, keepdim=True) < 0
    return pcd.with_attrs(normals=torch.where(flip, -n, n))


def estimate_color_gradients(
    pcd: PointCloud,
    max_nn: int = 30,
    radius: float | None = None,
) -> PointCloud:
    """Per-point tangent-plane intensity gradient for coloured ICP: for
    point i with normal n and intensity c_i, the least-squares g of
    g . d_j = c_j - c_i over its neighbours j, d_j the tangent-plane
    projection of p_j - p_i, with g . n = 0 added as one more row."""
    if "normals" not in pcd.attrs:
        raise ValueError("estimate_color_gradients requires normals")
    pos = pcd.positions
    nrm = pcd.attrs["normals"]
    colors = pcd.attrs["colors"]
    inten = colors.mean(-1) if colors.ndim == 2 and colors.shape[-1] == 3 else colors.reshape(-1)
    if radius is None:
        idx, _ = nns.knn_search(pos, pos, max_nn, target_mask=pcd.mask)
    else:
        idx, _, _ = nns.hybrid_search(pos, pos, radius, max_nn, target_mask=pcd.mask)
    w = (idx >= 0).to(torch.float32)
    d = gather_neighbors(pos, idx) - pos[:, None, :]
    d = d - nrm[:, None, :] * torch.sum(d * nrm[:, None, :], dim=-1, keepdim=True)
    dc = gather_neighbors(inten, idx) - inten[:, None]
    dw = d * w[..., None]
    AtA = torch.einsum("nki,nkj->nij", dw, d) + nrm[:, :, None] * nrm[:, None, :]
    Atb = torch.einsum("nki,nk->ni", dw, dc)
    g = linalg.solve3x3(AtA + 1e-6 * torch.eye(3, dtype=pos.dtype, device=pos.device), Atb)
    return pcd.with_attrs(color_gradients=torch.where(pcd.mask[:, None], g, 0.0))


def remove_statistical_outliers(pcd: PointCloud, nb_neighbors: int = 20, std_ratio: float = 2.0) -> PointCloud:
    """Drop points whose mean k-NN distance exceeds mean + std_ratio * std."""
    idx, d2 = nns.knn_search(pcd.positions, pcd.positions, nb_neighbors + 1, target_mask=pcd.mask)
    d = torch.sqrt(torch.clamp(d2[:, 1:], min=0.0))  # skip self
    valid = idx[:, 1:] >= 0
    mean_d = torch.where(valid, d, 0.0).sum(1) / torch.clamp(valid.sum(1), min=1)
    m = pcd.mask
    n = torch.clamp(m.sum(), min=1)
    mu = torch.where(m, mean_d, 0.0).sum() / n
    var = torch.where(m, (mean_d - mu) ** 2, 0.0).sum() / n
    return pcd.select_by_mask(mean_d <= mu + std_ratio * torch.sqrt(var))


def remove_radius_outliers(pcd: PointCloud, nb_points: int = 16, search_radius: float = 0.05) -> PointCloud:
    """Drop points with fewer than nb_points neighbours within search_radius."""
    _, _, counts = nns.hybrid_search(
        pcd.positions, pcd.positions, search_radius, nb_points + 1, target_mask=pcd.mask
    )
    return pcd.select_by_mask(counts - 1 >= nb_points)  # self excluded


def compute_point_cloud_distance(source: PointCloud, target: PointCloud) -> torch.Tensor:
    """Per-point distance to the nearest target point, 0 on invalid rows."""
    _, d2 = nns.one_nn_search(source.positions, target.positions, target_mask=target.mask)
    return torch.where(source.mask, torch.sqrt(torch.clamp(d2, min=0.0)), 0.0)


def orient_normals_consistent_tangent_plane(
    pcd: PointCloud,
    k: int = 10,
    max_sweeps: int | None = None,
) -> PointCloud:
    """Consistent normal orientation by propagation over the kNN graph.

    The seed is the +z-extremal valid point, its normal turned upward.
    Every sweep, each unoriented point adopts the orientation of its most
    parallel oriented neighbour; the sweeps stop at the first that changes
    nothing (one host read a sweep) or after max_sweeps (default N). Points
    the graph never reaches keep their estimated sign."""
    if "normals" not in pcd.attrs:
        raise ValueError("orient_normals_consistent_tangent_plane requires normals")
    pos = pcd.positions
    n = pcd.attrs["normals"]
    N = pos.shape[0]
    idx, _ = nns.knn_search(pos, pos, k, target_mask=pcd.mask)  # (N, k)
    nbr_ok = (idx >= 0) & pcd.mask[:, None]
    safe = torch.clamp(idx, min=0).to(torch.int64)
    dots = torch.einsum("ni,nki->nk", n, n[safe])  # n_i . n_j

    seed = torch.argmax(torch.where(pcd.mask, pos[:, 2], -math.inf))
    sign = torch.zeros(N, dtype=torch.float32, device=pos.device)
    sign[seed] = torch.where(n[seed, 2] >= 0.0, 1.0, -1.0)
    if max_sweeps is None:
        # the kNN graph's diameter grows as N / k on elongated clouds
        max_sweeps = N
    for _ in range(max_sweeps):
        nbr_sign = torch.where(nbr_ok, sign[safe], 0.0)  # (N, k)
        strength = torch.where(nbr_sign != 0.0, dots.abs(), -1.0)
        best = torch.argmax(strength, dim=1, keepdim=True)
        bs = torch.gather(nbr_sign, 1, best)[:, 0]
        bd = torch.gather(dots, 1, best)[:, 0]
        bw = torch.gather(strength, 1, best)[:, 0]
        fresh = (sign == 0.0) & (bw > 0.0) & pcd.mask
        new = torch.where(fresh, torch.where(bd >= 0, bs, -bs), sign)
        changed = bool(torch.any(new != sign))
        sign = new
        if not changed:
            break
    sign = torch.where(sign == 0.0, 1.0, sign)
    return pcd.with_attrs(normals=n * sign[:, None])


def compute_boundary_points(
    pcd: PointCloud,
    radius: float,
    max_nn: int = 30,
    angle_threshold: float = 90.0,
) -> torch.Tensor:
    """Boundary-point mask by the tangent-plane angular gap: a point is on
    the boundary when its neighbours leave a gap wider than
    `angle_threshold` degrees around it in its tangent plane, or when it
    has fewer than three. Returns (N,) bool, False on invalid rows.
    Requires normals."""
    if "normals" not in pcd.attrs:
        raise ValueError("compute_boundary_points requires normals")
    pos = pcd.positions
    nrm = pcd.attrs["normals"]
    idx, _, _ = nns.hybrid_search(pos, pos, radius, max_nn, target_mask=pcd.mask)
    ok = idx >= 0
    d = pos[torch.clamp(idx, min=0).to(torch.int64)] - pos[:, None, :]  # (N, k, 3)
    # a tangent basis (u, v) a point
    z = torch.tensor([0.0, 0.0, 1.0], device=pos.device)
    x = torch.tensor([1.0, 0.0, 0.0], device=pos.device)
    ref = torch.where(nrm[:, 2:3].abs() < 0.9, z, x)
    u = torch.linalg.cross(nrm, ref, dim=-1)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-9)
    v = torch.linalg.cross(nrm, u, dim=-1)
    au = torch.einsum("nki,ni->nk", d, u)
    av = torch.einsum("nki,ni->nk", d, v)
    # the self match and invalid slots go to +inf and sort last
    ang = torch.where(ok & (au**2 + av**2 > 1e-12), torch.atan2(av, au), math.inf)
    ang_s, _ = torch.sort(ang, dim=1)
    nv = torch.isfinite(ang_s).sum(1)
    nxt = torch.cat([ang_s[:, 1:], ang_s[:, :1]], dim=1)
    gap = torch.where(torch.isfinite(nxt) & torch.isfinite(ang_s), nxt - ang_s, 0.0)
    # the wrap-around gap: first valid + 2 pi - last valid
    first = ang_s[:, 0]
    last = torch.gather(ang_s, 1, torch.clamp(nv - 1, min=0)[:, None])[:, 0]
    wrap = torch.where(nv >= 2, first + 2.0 * math.pi - last, 2.0 * math.pi)
    max_gap = torch.maximum(gap.amax(1), wrap)
    return pcd.mask & ((nv < 3) | (max_gap > math.radians(angle_threshold)))


def extrude_linear(pcd: PointCloud, vector, scale: float = 1.0):
    """Sweep every point along `vector * scale`: a LineSet with one segment
    a point (rows i and N + i), the invalid points' segments masked out."""
    from open3d_tpu_torch.geometry.lineset import LineSet

    dev = pcd.positions.device
    v = torch.as_tensor(vector, dtype=torch.float32, device=dev) * scale
    N = pcd.capacity
    p0 = pcd.positions
    p1 = torch.where(pcd.mask[:, None], p0 + v, p0)
    seg = torch.arange(N, dtype=torch.int32, device=dev)
    return LineSet.create(torch.cat([p0, p1]), torch.stack([seg, seg + N], dim=-1),
                          point_mask=torch.cat([pcd.mask, pcd.mask]), line_mask=pcd.mask)


def extrude_rotation(
    pcd: PointCloud,
    angle_deg: float,
    axis,
    resolution: int = 16,
    translation: float = 0.0,
):
    """Sweep every point about `axis` (through the origin) by `angle_deg` in
    `resolution` steps, moving `translation` along the axis over the sweep
    (a helix): a LineSet of the (resolution + 1) copies, step k's points at
    rows k N .. k N + N - 1, and `resolution` segments a point."""
    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.geometry.lineset import LineSet

    dev = pcd.positions.device
    ax = torch.as_tensor(axis, dtype=torch.float32, device=dev)
    ax = ax / torch.clamp(torch.linalg.norm(ax), min=1e-12)
    N = pcd.capacity
    R = resolution
    ks = torch.arange(R + 1, dtype=torch.float32, device=dev) / R
    angles = math.radians(angle_deg) * ks
    rots = lie.so3_exp(ax[None, :] * angles[:, None])  # (R + 1, 3, 3)
    offs = ks[:, None] * translation * ax[None, :]
    pts = (torch.einsum("kij,nj->kni", rots, pcd.positions) + offs[:, None, :]).reshape(
        (R + 1) * N, 3)
    seg = torch.arange(N, dtype=torch.int32, device=dev)
    lines = torch.cat([torch.stack([seg + k * N, seg + (k + 1) * N], dim=-1) for k in range(R)])
    return LineSet.create(pts, lines, point_mask=pcd.mask.repeat(R + 1),
                          line_mask=pcd.mask.repeat(R))


def pca_partition(pcd: PointCloud, max_points: int):
    """Partition the cloud by recursive PCA splits until every partition
    holds <= max_points points. Every oversize partition splits each round
    at the mid-extent along its principal axis, and ids are re-compacted
    after every round; the rounds stop when no partition is oversize (one
    host read a round). Returns (num_partitions (), partition_ids (N,)
    int32, -1 on invalid rows)."""
    N = pcd.capacity
    pos = pcd.positions
    mask = pcd.mask
    dev = pos.device
    w = mask.to(torch.float32)
    big_id = 2**30

    def compact(ids):
        key = torch.where(mask, ids, big_id)
        uniq, _ = torch.sort(key)
        first = torch.ones(N, dtype=torch.bool, device=dev)
        first[1:] = uniq[1:] != uniq[:-1]
        valid_first = first & (uniq < big_id)
        roots, _ = torch.sort(torch.where(valid_first, uniq, big_id))
        rank = torch.searchsorted(roots, key)
        return torch.where(mask, rank, 0), valid_first.to(torch.int32).sum()

    ids, _ = compact(torch.zeros(N, dtype=torch.int64, device=dev))
    oversize_any = bool(w.sum() > max_points)
    it = 0
    big = 3e38
    while oversize_any and it < N:
        cnt = _scatter_add(w, ids, N)
        mean = _scatter_add(pos * w[:, None], ids, N) / torch.clamp(cnt, min=1.0)[:, None]
        d = (pos - mean[ids]) * w[:, None]
        cov = _scatter_add(d[:, :, None] * d[:, None, :], ids, N) / torch.clamp(cnt, min=1.0)[:, None, None]
        _, evecs = linalg.eigh3x3(cov)
        ax = evecs[..., 2]  # largest-eigenvalue axis
        dot = torch.sum((pos - mean[ids]) * ax[ids], dim=-1)
        dmin = torch.full((N,), big, device=dev).scatter_reduce(0, ids, torch.where(mask, dot, big), "amin")
        dmax = torch.full((N,), -big, device=dev).scatter_reduce(0, ids, torch.where(mask, dot, -big), "amax")
        center = 0.5 * (dmin + dmax)
        split = (cnt > max_points)[ids] & mask
        new_ids = torch.where(split, 2 * ids + (dot >= center[ids]).to(torch.int64), 2 * ids)
        ids, _ = compact(new_ids)
        oversize_any = bool((_scatter_add(w, ids, N) > max_points).any())
        it += 1
    out, n_parts = compact(ids)
    return n_parts, torch.where(mask, out, -1).to(torch.int32)
