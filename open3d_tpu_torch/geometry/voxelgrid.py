"""VoxelGrid and a linear Octree (port of open3d_tpu/geometry/voxelgrid.py).

- VoxelGrid (ref: geometry/VoxelGrid.h:61, VoxelGridFactory.cpp): integer
  voxel coordinates, unique and in lexicographic order, with the invalid
  rows parked at 2^30, and each voxel's mean colour.
- Octree (ref: geometry/Octree.h:244): a LINEAR octree, as in the JAX
  package: the points' Morton codes, sorted; each level is the sorted
  distinct prefixes of those codes; locating a point is a searchsorted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from open3d_tpu_torch.core.masking import (_div, _scatter_apply, _scatter_plan, _unique_rows,
                                           lexsort_rows)
from open3d_tpu_torch.core.platform import default_device

_INT_BIG = 2**30


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Sparse voxel set (ref: geometry/VoxelGrid.h:61): `coords` (V, 3)
    int32 voxel indices (rows past `num_voxels` = 2^30), `colors` (V, 3)
    f32 mean colour of each voxel, `num_voxels` (), `origin` (3,)."""

    coords: torch.Tensor
    colors: torch.Tensor
    num_voxels: torch.Tensor
    origin: torch.Tensor
    voxel_size: float

    @property
    def valid(self) -> torch.Tensor:
        return self.coords[:, 0] < _INT_BIG

    def get_voxel_centers(self) -> torch.Tensor:
        return (self.coords.to(torch.float32) + 0.5) * self.voxel_size + self.origin

    def check_if_included(self, queries: torch.Tensor) -> torch.Tensor:
        """(ref: VoxelGrid::CheckIfIncluded) bool per query point."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.coords.device)
        q = torch.floor(_div(q - self.origin, self.voxel_size)).to(torch.int32)
        return _rows_in_sorted(self.coords, q)


def _rows_in_sorted(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Membership of (Q, 3) int32 query rows among (N, 3) table rows: a
    batched lower-bound binary search over the lexicographically sorted
    table, ceil(log2 N) + 1 steps, then an equality test."""
    t = table[lexsort_rows(table)].to(torch.int64)
    q = queries.to(torch.int64)
    n = t.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, n)
    for _ in range(int(np.ceil(np.log2(max(n, 1)))) + 1):
        mid = torch.clamp(torch.div(lo + hi, 2, rounding_mode="floor"), max=n - 1)
        r = t[mid]
        # q > t[mid], lexicographically: go right
        gt = (q[:, 0] > r[:, 0]) | ((q[:, 0] == r[:, 0]) & (
            (q[:, 1] > r[:, 1]) | ((q[:, 1] == r[:, 1]) & (q[:, 2] > r[:, 2]))))
        go = lo < hi
        lo = torch.where(go & gt, mid + 1, lo)
        hi = torch.where(go & ~gt, mid, hi)
    return (t[torch.clamp(lo, max=n - 1)] == q).all(-1)


def _dev(x, device) -> torch.device:
    return x.device if device is None and isinstance(x, torch.Tensor) else default_device(device)


def create_from_point_cloud(
    points,
    voxel_size: float,
    colors=None,
    mask=None,
    max_voxels: int | None = None,
    origin=None,
    device=None,
) -> VoxelGrid:
    """(ref: VoxelGridFactory.cpp CreateFromPointCloud): one voxel per
    occupied cell, colour = the mean of its points (summed in input order).
    `device` defaults to that of `points` when it is a tensor, else to the
    card."""
    dev = _dev(points, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev))
    max_voxels = n if max_voxels is None else max_voxels
    origin = (torch.where(mask[:, None], points, float("inf")).amin(0) if origin is None
              else torch.as_tensor(origin, dtype=torch.float32, device=dev))
    c = torch.floor(_div(points - origin, voxel_size)).to(torch.int32)
    c = torch.where(mask[:, None], c, _INT_BIG)
    uniq, inv = _unique_rows(c, max_voxels, _INT_BIG)
    colors = (torch.zeros((n, 3), device=dev) if colors is None
              else torch.as_tensor(colors, dtype=torch.float32, device=dev))
    w = mask.to(torch.float32)
    plan = _scatter_plan(inv, max_voxels)
    col = _scatter_apply(colors * w[:, None], plan) / torch.clamp(_scatter_apply(w, plan),
                                                                  min=1.0)[:, None]
    nvox = (uniq[:, 0] < _INT_BIG).sum().to(torch.int32)
    return VoxelGrid(uniq, col, nvox, origin, float(voxel_size))


def create_dense(origin, color, voxel_size: float, width: float, height: float,
                 depth: float, device=None) -> VoxelGrid:
    """(ref: VoxelGrid::CreateDense) every voxel of the box, x-major."""
    dev = default_device(device)
    nx = max(int(round(width / voxel_size)), 1)
    ny = max(int(round(height / voxel_size)), 1)
    nz = max(int(round(depth / voxel_size)), 1)
    g = torch.stack(torch.meshgrid(*(torch.arange(k, dtype=torch.int32, device=dev)
                                     for k in (nx, ny, nz)), indexing="ij"), -1).reshape(-1, 3)
    col = torch.as_tensor(color, dtype=torch.float32, device=dev).expand(g.shape[0], 3)
    return VoxelGrid(g, col.clone(), torch.tensor(g.shape[0], dtype=torch.int32, device=dev),
                     torch.as_tensor(origin, dtype=torch.float32, device=dev), float(voxel_size))


def carve_depth_map(
    grid: VoxelGrid, depth, intrinsic, extrinsic,
    keep_voxels_outside_image: bool = True,
) -> VoxelGrid:
    """Depth carving (ref: VoxelGrid::CarveDepthMap): remove the voxels whose
    centre projects in front of the observed depth (provably empty space).
    Pixel coordinates truncate toward zero, as the JAX package's do."""
    dev = grid.coords.device
    K = intrinsic.intrinsic_matrix_on(dev)
    E = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    c = grid.get_voxel_centers()
    pc = [((c[:, 0] * E[i, 0] + c[:, 1] * E[i, 1]) + c[:, 2] * E[i, 2]) + E[i, 3]
          for i in range(3)]
    z = pc[2]
    zc = torch.clamp(z, min=1e-6)
    u = pc[0] / zc * K[0, 0] + K[0, 2]
    v = pc[1] / zc * K[1, 1] + K[1, 2]
    h, w = depth.shape
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).to(torch.int64)
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).to(torch.int64)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 0)
    d = depth[vi, ui]
    carved = inside & (d > 0) & (z < d)  # the voxel lies strictly in front of the surface
    if not keep_voxels_outside_image:
        carved = carved | ~inside
    keep = grid.valid & ~carved
    coords = torch.where(keep[:, None], grid.coords, _INT_BIG)
    return VoxelGrid(coords, grid.colors, keep.sum().to(torch.int32), grid.origin,
                     grid.voxel_size)


# ------------------------------------------------------------------ octree --
def _spread(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_encode(coords: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Interleave (N, 3) int coords, clipped to [0, 2^bits), into (N,) int32
    Morton codes (in int64, every step masked to the reference's 32 bits)."""
    c = torch.clamp(coords.to(torch.int64), 0, (1 << bits) - 1)
    code = _spread(c[..., 0]) | (_spread(c[..., 1]) << 1) | (_spread(c[..., 2]) << 2)
    return (code & 0xFFFFFFFF).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Octree:
    """Linear octree (ref class: geometry/Octree.h:244). level_codes[d]: the
    sorted distinct Morton prefixes (codes >> 3 (max_depth - 1 - d)) of the
    occupied nodes at depth d + 1, padded with 2^30."""

    point_codes: torch.Tensor  # (N,) sorted full-depth codes of the input points
    point_order: torch.Tensor  # (N,) permutation into the original cloud
    level_codes: tuple  # a (N,) int32 tensor a depth
    level_counts: tuple  # occupied node count a depth
    origin: torch.Tensor
    size: float
    max_depth: int

    def locate_leaf(self, points: torch.Tensor) -> torch.Tensor:
        """Leaf node index at max_depth for each query (-1 if empty)."""
        p = torch.as_tensor(points, dtype=torch.float32, device=self.origin.device)
        q = torch.floor(_div(p - self.origin, self.size) * (1 << self.max_depth)).to(torch.int32)
        code = morton_encode(q, self.max_depth)
        table = self.level_codes[-1]
        pos = torch.clamp(torch.searchsorted(table, code), 0, table.shape[0] - 1)
        return torch.where(table[pos] == code, pos.to(torch.int32), -1)


def octree_from_point_cloud(
    points,
    max_depth: int = 6,
    mask=None,
    size_expand: float = 0.01,
    device=None,
) -> Octree:
    """A linear octree (ref: Octree::ConvertFromPointCloud): the root cell
    is the points' box grown by `size_expand`, its side read to the host;
    one sort, then the distinct prefixes a level. `device` defaults to that
    of `points` when it is a tensor, else to the card."""
    dev = _dev(points, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev))
    lo = torch.where(mask[:, None], points, float("inf")).amin(0)
    hi = torch.where(mask[:, None], points, float("-inf")).amax(0)
    size = float((hi - lo).amax() * (1.0 + size_expand))
    res = 1 << max_depth
    q = torch.clamp(torch.floor(_div(points - lo, size) * res).to(torch.int32), 0, res - 1)
    codes = torch.where(mask, morton_encode(q, max_depth), _INT_BIG)
    scodes, order = torch.sort(codes, stable=True)
    levels, counts = [], []
    for d in range(1, max_depth + 1):
        pref = torch.where(scodes < _INT_BIG, scodes >> (3 * (max_depth - d)), _INT_BIG)
        u = torch.unique_consecutive(pref)
        uniq = torch.full((n,), _INT_BIG, dtype=torch.int32, device=dev)
        uniq[:u.shape[0]] = u
        levels.append(uniq)
        counts.append((uniq < _INT_BIG).sum().to(torch.int32))
    return Octree(scodes, order.to(torch.int32), tuple(levels), tuple(counts), lo, size,
                  max_depth)
