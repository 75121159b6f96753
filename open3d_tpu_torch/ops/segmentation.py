"""Point-cloud segmentation, clustering, keypoints and hulls (port of
open3d_tpu/ops/segmentation.py).

- segment_plane scores every RANSAC hypothesis in one batched pass (in
  chunks of hypotheses that bound the (I, N) distance matrix), then refits
  the winner to its inliers. The draws come from a torch.Generator seeded
  with `seed` on the host (`_plane_draws`), so the card and a CPU copy use
  the same hypotheses; they are not JAX's draws.
- cluster_dbscan and detect_planar_patches propagate minimum labels over a
  fixed neighbour graph to a fixed point; the host reads the "changed" flag
  every `_READ_EVERY` steps (the steps past the fixed point change
  nothing), where the JAX package's while_loop reads it on the device.
- compute_convex_hull and hidden_point_removal run on the host through
  scipy's Qhull, as the reference does.

No module here holds a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from open3d_tpu_torch.core import nns
from open3d_tpu_torch.core.masking import _scatter_add

_INT_BIG = 2**30
_READ_EVERY = 16  # label-propagation steps between two host reads of the flag
_DIST_ELEMS = 1 << 26  # elements of one chunk of the (hypotheses, points) distances


def _fit_planes_3pts(p0, p1, p2):
    """(I, 4) planes (nx, ny, nz, d) through three points each, unit
    normals; a degenerate triple gives n = 0."""
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = torch.where(norm > 1e-12, n / torch.clamp(norm, min=1e-12), 0.0)
    d = -(n * p0).sum(-1, keepdim=True)
    return torch.cat([n, d], dim=-1)


def _plane_dist(planes, positions):
    """|n . p + d| of every plane (I, 4) at every point (N, 3), elementwise
    (the same bits on the card and the CPU)."""
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    return torch.abs(planes[:, 0:1] * x + planes[:, 1:2] * y + planes[:, 2:3] * z
                     + planes[:, 3:4])


def _plane_draws(num_iterations: int, seed: int, device) -> torch.Tensor:
    """(I, 3) int64 draws in [0, 2^31 - 1) from a host generator seeded with
    `seed`, moved to `device`."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**31 - 1, (num_iterations, 3), generator=g).to(device)


def segment_plane(
    positions: torch.Tensor,
    mask: torch.Tensor | None = None,
    distance_threshold: float = 0.01,
    ransac_n: int = 3,
    num_iterations: int = 100,
    probability: float = 0.999,
    seed: int = 0,
):
    """RANSAC plane segmentation: all `num_iterations` three-point
    hypotheses drawn, fitted and scored (no early exit; the confidence test
    is a static iteration count), then a least-squares refit over the
    winner's inliers. Returns (plane_model (4,) f32, inlier_mask (N,) bool)."""
    del ransac_n, probability
    n = positions.shape[0]
    dev = positions.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    # valid indices first, in order; each draw picks one modulo their count
    valid_ids = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev), -1)
    compact = valid_ids[torch.argsort((valid_ids < 0).to(torch.int8), stable=True)]
    n_valid = torch.clamp(mask.to(torch.int64).sum(), min=1)
    idx = compact[_plane_draws(num_iterations, seed, dev) % n_valid].long()  # (I, 3)
    tri = positions[idx]  # (I, 3, 3)
    planes = _fit_planes_3pts(tri[:, 0], tri[:, 1], tri[:, 2])

    ok_plane = torch.linalg.norm(planes[:, :3], dim=-1) > 0.5
    step = max(1, _DIST_ELEMS // max(n, 1))
    counts = torch.cat([
        ((_plane_dist(planes[s:s + step], positions) <= distance_threshold) & mask[None]
         & ok_plane[s:s + step, None]).sum(1)
        for s in range(0, num_iterations, step)])
    best = torch.argmax(counts)  # the first of equal counts
    inliers = (_plane_dist(planes[best][None], positions)[0] <= distance_threshold) & mask

    # least-squares refit over the inliers: the covariance's smallest
    # eigenvector, oriented as the RANSAC winner
    w = inliers.to(positions.dtype)[:, None]
    c = (positions * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    q = (positions - c) * w
    _, vecs = torch.linalg.eigh(q.T @ q)
    nrm = vecs[:, 0]
    plane = torch.cat([nrm, -(nrm * c).sum()[None]])
    plane = plane * torch.sign((plane[:3] * planes[best, :3]).sum() + 1e-20)
    inliers = (_plane_dist(plane[None], positions)[0] <= distance_threshold) & mask
    return plane, inliers


def _propagate_min_labels(labels, nbr, edge, active):
    """Minimum-label propagation to the fixed point: each `active` row takes
    the least of its own label and those of its neighbours `nbr` (N, k)
    over `edge` (N, k); inactive rows keep theirs."""
    step = 0
    while True:
        new = torch.minimum(labels, torch.where(edge, labels[nbr], _INT_BIG).amin(1))
        new = torch.where(active, new, labels)
        changed = (new != labels).any()
        labels = new
        step += 1
        if step % _READ_EVERY == 0 and not bool(changed):
            return labels


def cluster_dbscan(
    positions: torch.Tensor,
    eps: float,
    min_points: int,
    mask: torch.Tensor | None = None,
    max_neighbors: int = 64,
):
    """DBSCAN as minimum-label propagation over the core-core edges of the
    radius-capped k-NN graph; a border point takes its smallest core
    neighbour's label, noise -1. Labels are compacted to 0..k-1 in the
    order of each cluster's first point. The graph holds at most
    max(max_neighbors, min_points) neighbours a point."""
    max_neighbors = max(int(max_neighbors), int(min_points))
    n = positions.shape[0]
    dev = positions.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    idx, _, cnt = nns.hybrid_search(positions, positions, radius=eps, max_knn=max_neighbors,
                                    target_mask=mask)
    cnt = torch.where(mask, cnt, 0)
    core = cnt >= min_points  # a point counts as its own neighbour
    safe = torch.clamp(idx, min=0).long()
    neigh_core = core[safe] & (idx >= 0)  # (N, k)

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    labels = _propagate_min_labels(torch.where(core, ids, _INT_BIG), safe, neigh_core, core)
    border = torch.where(neigh_core, labels[safe], _INT_BIG).amin(1)
    labels = torch.where(core, labels, border)
    labels = torch.where(mask & (labels < _INT_BIG), labels, -1)

    # the root of each cluster is its least point index, so ranking the
    # roots by value follows the scan order
    roots = torch.unique(labels[labels >= 0])  # sorted
    rank = torch.searchsorted(roots, torch.clamp(labels, min=0))
    return torch.where(labels >= 0, rank, -1).to(torch.int32)


def compute_iss_keypoints(
    positions: torch.Tensor,
    mask: torch.Tensor | None = None,
    salient_radius: float = 0.0,
    non_max_radius: float = 0.0,
    gamma_21: float = 0.975,
    gamma_32: float = 0.975,
    min_neighbors: int = 5,
    max_neighbors: int = 64,
):
    """ISS keypoint mask (N,) bool. Radii of 0 default to 6x and 4x the
    model resolution, the mean 1-NN distance."""
    n = positions.shape[0]
    dev = positions.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    if salient_radius <= 0.0 or non_max_radius <= 0.0:
        _, d2 = nns.knn_search(positions, positions, k=2, target_mask=mask)
        res = torch.sqrt(torch.clamp(d2[:, 1], min=0.0))
        res = torch.where(mask, res, 0.0).sum() / torch.clamp(mask.to(torch.float32).sum(),
                                                              min=1.0)
        salient_radius = 6.0 * float(res)
        non_max_radius = 4.0 * float(res)

    idx, _, cnt = nns.hybrid_search(positions, positions, radius=salient_radius,
                                    max_knn=max_neighbors, target_mask=mask)
    valid = idx >= 0
    pts = positions[torch.clamp(idx, min=0).long()]  # (N, k, 3)
    w = valid.to(positions.dtype)[..., None]
    nn = torch.clamp(w.sum(1), min=1.0)
    mu = (pts * w).sum(1) / nn
    q = (pts - mu[:, None, :]) * w
    cov = torch.einsum("nkd,nke->nde", q, q) / nn[..., None]
    evals = torch.linalg.eigvalsh(cov)  # ascending: l3 <= l2 <= l1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    sal = ((l2 / torch.clamp(l1, min=1e-12) < gamma_21)
           & (l3 / torch.clamp(l2, min=1e-12) < gamma_32)
           & (cnt >= min_neighbors) & mask)
    # non-maximum suppression on l3: strictly above every other neighbour's
    nidx, _, _ = nns.hybrid_search(positions, positions, radius=non_max_radius,
                                   max_knn=max_neighbors, target_mask=mask)
    self_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    nvalid = (nidx >= 0) & (nidx != self_ids)
    neigh_l3 = torch.where(nvalid, l3[torch.clamp(nidx, min=0).long()], -3.0e38)
    return sal & (l3 > neigh_l3.amax(1))


def _host(x, dtype):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x, dtype)


def compute_convex_hull(positions: np.ndarray, mask: np.ndarray | None = None):
    """Convex hull through Qhull on the host. Returns (vertices (V, 3) f32,
    triangles (T, 3) i32 oriented outward, point_indices (V,) i32), numpy."""
    from scipy.spatial import ConvexHull

    pts = _host(positions, np.float64)
    if mask is not None:
        ids = np.nonzero(_host(mask, bool))[0]
        pts = pts[ids]
    else:
        ids = np.arange(len(pts))
    hull = ConvexHull(pts)
    verts = pts[hull.vertices].astype(np.float32)
    remap = np.full(len(pts), -1, np.int64)
    remap[hull.vertices] = np.arange(len(hull.vertices))
    tris = remap[hull.simplices].astype(np.int32)
    c = pts.mean(0)
    for t in range(len(tris)):  # orient each triangle away from the centroid
        a, b, d = verts[tris[t]]
        if np.dot(np.cross(b - a, d - a), a - c) < 0:
            tris[t] = tris[t][[0, 2, 1]]
    return verts, tris, ids[hull.vertices].astype(np.int32)


def hidden_point_removal(
    positions: np.ndarray,
    camera_location,
    radius: float,
    mask: np.ndarray | None = None,
):
    """Katz et al. hidden-point removal: a spherical flip about the camera,
    then the convex hull; the points on the hull are visible. Returns the
    visible indices (numpy int32), on the host."""
    from scipy.spatial import ConvexHull

    pts = _host(positions, np.float64)
    if mask is not None:
        ids = np.nonzero(_host(mask, bool))[0]
        pts = pts[ids]
    else:
        ids = np.arange(len(pts))
    p = pts - _host(camera_location, np.float64).reshape(1, 3)
    norm = np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-12)
    flipped = p + 2.0 * (radius - norm) * (p / norm)
    hull = ConvexHull(np.vstack([flipped, np.zeros((1, 3))]))  # the camera at the origin
    vis = hull.vertices[hull.vertices < len(pts)]
    return ids[np.sort(vis)].astype(np.int32)


def detect_planar_patches(
    pcd,
    normal_variance_threshold_deg: float = 60.0,
    coplanarity_deg: float = 75.0,
    distance_threshold: float = 0.02,
    min_num_points: int = 30,
    knn: int = 16,
    max_patches: int = 32,
):
    """Planar patches as minimum-label propagation over the k-NN edges whose
    normals agree within `normal_variance_threshold_deg` and whose ends lie
    within `distance_threshold` of, and within `coplanarity_deg` of, each
    other's tangent plane. Components of at least `min_num_points` become
    patches, the `max_patches` largest kept, each with an oriented bounding
    box in its plane frame (normal and in-plane principal axes).

    Returns (labels (N,) int32, -1 unassigned; an OrientedBoundingBox
    batched over a leading (max_patches,) axis; n_patches () int32).
    Requires normals."""
    import math

    from open3d_tpu_torch.core import linalg
    from open3d_tpu_torch.geometry.bounding_volume import OrientedBoundingBox

    if "normals" not in pcd.attrs:
        raise ValueError("detect_planar_patches requires normals")
    pos = pcd.positions
    nrm = pcd.attrs["normals"]
    n = pos.shape[0]
    dev = pos.device
    mask = pcd.mask

    idx, _ = nns.knn_search(pos, pos, knn, target_mask=mask)
    ok = (idx >= 0) & mask[:, None]
    safe = torch.clamp(idx, min=0).long()
    nj = nrm[safe]  # (N, k, 3)
    dvec = pos[safe] - pos[:, None, :]
    dlen = torch.linalg.norm(dvec, dim=-1)
    ndot = torch.abs(torch.einsum("ni,nki->nk", nrm, nj))
    d_ij = torch.abs(torch.einsum("ni,nki->nk", nrm, dvec))
    d_ji = torch.abs(torch.einsum("nki,nki->nk", nj, -dvec))
    cos_n = math.cos(math.radians(normal_variance_threshold_deg))
    cos_c = math.cos(math.radians(coplanarity_deg))
    edge = (ok & (ndot > cos_n) & (d_ij < distance_threshold) & (d_ji < distance_threshold)
            & (d_ij <= dlen * cos_c) & (d_ji <= dlen * cos_c))

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    labels = _propagate_min_labels(torch.where(mask, ids, _INT_BIG), safe, edge, mask)
    labels = torch.where(mask, labels, _INT_BIG)

    # component sizes; keep the max_patches largest of min_num_points or more
    lab_c = torch.clamp(labels, max=n - 1)
    sizes = _scatter_add(mask.to(torch.int64), lab_c, n)
    root_size = torch.where(mask, sizes[lab_c], 0)
    is_root = mask & (labels == ids)
    root_order = torch.argsort(torch.where(is_root, -sizes, 1), stable=True)[:max_patches]
    picked = sizes[root_order] >= min_num_points
    n_patches = picked.to(torch.int32).sum()

    # each patch's plane frame and box, batched over the patches (P, N)
    sel = mask[None] & (labels[None] == labels[root_order][:, None]) & picked[:, None]
    w = sel.to(torch.float32)
    cnt = torch.clamp(w.sum(1), min=1.0)  # (P,)
    c = (w @ pos) / cnt[:, None]
    nmean = w @ nrm
    nhat = nmean / torch.clamp(torch.linalg.norm(nmean, dim=-1, keepdim=True), min=1e-9)
    d = (pos[None] - c[:, None]) * w[..., None]  # (P, N, 3)
    dt = d - (d * nhat[:, None]).sum(-1, keepdim=True) * nhat[:, None]
    cov = torch.einsum("pni,pnj->pij", dt, dt) / cnt[:, None, None]
    _, evecs = linalg.eigh3x3(cov)
    u = evecs[..., 2]
    u = u - (u * nhat).sum(-1, keepdim=True) * nhat
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-9)
    v = torch.linalg.cross(nhat, u, dim=-1)
    R = torch.stack([u, v, nhat], dim=-1)  # (P, 3, 3), columns = axes
    proj = torch.einsum("pni,pij->pnj", d, R)
    lo = torch.where(sel[..., None], proj, float("inf")).amin(1)
    hi = torch.where(sel[..., None], proj, float("-inf")).amax(1)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    centers = c + torch.einsum("pij,pj->pi", R, (lo + hi) * 0.5)
    obbs = OrientedBoundingBox(center=centers, rotation=R, extent=torch.clamp(hi - lo, min=1e-6))

    # compact labels: the rank of the patch's root, -1 for small or unpicked
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    rank[root_order[picked]] = torch.arange(max_patches, device=dev)[:root_order.numel()][picked]
    out = torch.where(mask & (root_size >= min_num_points), rank[torch.clamp(labels, max=n)], -1)
    return out.to(torch.int32), obbs, n_patches
