"""TriangleMesh: a fixed-capacity, masked triangle mesh (port of
open3d_tpu/geometry/trianglemesh.py).

`vertices (V, 3) f32`, `triangles (T, 3) int32` vertex ids, `vertex_mask
(V,)` and `triangle_mask (T,)` bool, and the `vertex_attrs` and
`triangle_attrs` dicts ("colors", "normals"). The triangle soup is the form
that TSDF extraction produces; `compact()` merges shared vertices on the
host for IO. Methods return new meshes. A `key` is a torch.Generator on the
mesh's device; without one, a generator seeded 0 there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from open3d_tpu_torch.core import lie, nns
from open3d_tpu_torch.core.masking import _scatter_add
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.pointcloud import PointCloud


def _generator(key, device) -> torch.Generator:
    return key if key is not None else torch.Generator(device=device).manual_seed(0)


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    vertices: torch.Tensor  # (V, 3) f32
    triangles: torch.Tensor  # (T, 3) int32 vertex ids
    vertex_mask: torch.Tensor  # (V,) bool
    triangle_mask: torch.Tensor  # (T,) bool
    vertex_attrs: Dict[str, torch.Tensor]
    triangle_attrs: Dict[str, torch.Tensor]

    @staticmethod
    def create(vertices, triangles, vertex_attrs=None, triangle_attrs=None,
               vertex_mask=None, triangle_mask=None, device=None) -> "TriangleMesh":
        """From host or device arrays; `device` defaults to that of
        `vertices` when it is a tensor, else to the card."""
        if device is None and isinstance(vertices, torch.Tensor):
            dev = vertices.device
        else:
            dev = default_device(device)

        def arr(x, dtype=None):
            t = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=dev)
            return t if dtype is None else t.to(dtype)

        vertices = arr(vertices, torch.float32)
        triangles = arr(triangles, torch.int32)
        V, T = vertices.shape[0], triangles.shape[0]
        return TriangleMesh(
            vertices=vertices,
            triangles=triangles,
            vertex_mask=(torch.ones(V, dtype=torch.bool, device=dev) if vertex_mask is None
                         else arr(vertex_mask, torch.bool)),
            triangle_mask=(torch.ones(T, dtype=torch.bool, device=dev) if triangle_mask is None
                           else arr(triangle_mask, torch.bool)),
            vertex_attrs={k: arr(v) for k, v in (vertex_attrs or {}).items()},
            triangle_attrs={k: arr(v) for k, v in (triangle_attrs or {}).items()},
        )

    @staticmethod
    def from_triangle_soup(tri_verts, tri_mask, colors=None) -> "TriangleMesh":
        """(T, 3, 3) per-triangle vertex soup -> mesh with V = 3T vertices."""
        tri_verts = torch.as_tensor(tri_verts, dtype=torch.float32)
        dev = tri_verts.device
        T = tri_verts.shape[0]
        tri_mask = torch.as_tensor(tri_mask, dtype=torch.bool, device=dev)
        vattrs = {}
        if colors is not None:
            vattrs["colors"] = torch.as_tensor(colors, dtype=torch.float32,
                                               device=dev).reshape(3 * T, 3)
        return TriangleMesh(
            vertices=tri_verts.reshape(3 * T, 3),
            triangles=torch.arange(3 * T, dtype=torch.int32, device=dev).reshape(T, 3),
            vertex_mask=tri_mask.repeat_interleave(3),
            triangle_mask=tri_mask,
            vertex_attrs=vattrs,
            triangle_attrs={},
        )

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    # ---- counts -------------------------------------------------------

    def num_vertices(self) -> torch.Tensor:
        return self.vertex_mask.to(torch.int32).sum()

    def num_triangles(self) -> torch.Tensor:
        return self.triangle_mask.to(torch.int32).sum()

    # ---- geometry -----------------------------------------------------

    def _tri_corners(self):
        tri = torch.clamp(self.triangles, min=0).to(torch.int64)
        return self.vertices[tri[:, 0]], self.vertices[tri[:, 1]], self.vertices[tri[:, 2]]

    def compute_triangle_normals(self) -> "TriangleMesh":
        a, b, c = self._tri_corners()
        n = torch.linalg.cross(b - a, c - a)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        n = torch.where(self.triangle_mask[:, None], n, 0.0)
        return dataclasses.replace(self, triangle_attrs={**self.triangle_attrs, "normals": n})

    def compute_vertex_normals(self) -> "TriangleMesh":
        """Area-weighted incident-triangle normals."""
        a, b, c = self._tri_corners()
        fn = torch.where(self.triangle_mask[:, None], torch.linalg.cross(b - a, c - a), 0.0)
        tri = torch.clamp(self.triangles, min=0).to(torch.int64)
        vn = _scatter_add(fn.repeat(3, 1), tri.T.reshape(-1), self.vertices.shape[0])
        vn = vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-12)
        vn = torch.where(self.vertex_mask[:, None], vn, 0.0)
        return dataclasses.replace(self, vertex_attrs={**self.vertex_attrs, "normals": vn})

    def triangle_areas(self) -> torch.Tensor:
        a, b, c = self._tri_corners()
        ar = 0.5 * torch.linalg.norm(torch.linalg.cross(b - a, c - a), dim=-1)
        return torch.where(self.triangle_mask, ar, 0.0)

    def surface_area(self) -> torch.Tensor:
        return self.triangle_areas().sum()

    def transform(self, T: torch.Tensor) -> "TriangleMesh":
        T = torch.as_tensor(T, dtype=torch.float32, device=self.device)
        va = dict(self.vertex_attrs)
        if "normals" in va:
            va["normals"] = lie.rotate_vectors(T, va["normals"])
        return dataclasses.replace(self, vertices=lie.transform_points(T, self.vertices),
                                   vertex_attrs=va)

    def sample_points_uniformly(self, number_of_points: int, key=None) -> PointCloud:
        """Area-weighted triangle choice, then uniform barycentric
        coordinates (the square folded onto the triangle)."""
        gen = _generator(key, self.device)
        areas = self.triangle_areas()
        p = areas / torch.clamp(areas.sum(), min=1e-12)
        tid = torch.multinomial(p, number_of_points, replacement=True, generator=gen)
        a, b, c = self._tri_corners()
        u = torch.rand((number_of_points, 2), generator=gen, device=self.device)
        su = torch.sqrt(u[:, 0])
        w0, w1, w2 = 1.0 - su, su * (1.0 - u[:, 1]), su * u[:, 1]
        pts = w0[:, None] * a[tid] + w1[:, None] * b[tid] + w2[:, None] * c[tid]
        return PointCloud.create(pts, mask=self.triangle_mask[tid])

    def sample_points_poisson_disk(
        self, number_of_points: int, init_factor: int = 5, key=None
    ) -> PointCloud:
        """`init_factor * number_of_points` uniform samples thinned by
        farthest-point selection (the reference's sample elimination as a
        data-parallel eliminator)."""
        from open3d_tpu_torch.ops import pointcloud as _pc_ops

        dense = self.sample_points_uniformly(init_factor * number_of_points, key=key)
        return _pc_ops.farthest_point_down_sample(dense, number_of_points)

    def get_min_bound(self) -> torch.Tensor:
        return torch.where(self.vertex_mask[:, None], self.vertices, float("inf")).amin(0)

    def get_max_bound(self) -> torch.Tensor:
        return torch.where(self.vertex_mask[:, None], self.vertices, float("-inf")).amax(0)

    # ---- host-side ----------------------------------------------------

    def compact(self, decimals: int = 6):
        """Host-side: drop masked rows and merge duplicate vertices.
        Returns (vertices (V', 3) np, triangles (T', 3) np)."""
        v = self.vertices.cpu().numpy()
        t = self.triangles.cpu().numpy()
        vm = self.vertex_mask.cpu().numpy()
        tm = self.triangle_mask.cpu().numpy()
        t = t[tm]
        key = np.round(v, decimals)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        # representative position per unique key: its first live occurrence
        first = np.full(uniq.shape[0], -1, np.int64)
        live = np.flatnonzero(vm)
        groups, at = np.unique(inv[live], return_index=True)
        first[groups] = live[at]
        new_tris = inv[t]
        good = (
            (new_tris[:, 0] != new_tris[:, 1])
            & (new_tris[:, 1] != new_tris[:, 2])
            & (new_tris[:, 0] != new_tris[:, 2])
        )
        new_tris = new_tris[good]
        used = np.zeros(uniq.shape[0], bool)
        used[new_tris.reshape(-1)] = True
        old2new = np.cumsum(used) - 1
        verts = np.where(first[used][:, None] >= 0, v[np.maximum(first[used], 0)], uniq[used])
        return verts.astype(np.float32), old2new[new_tris].astype(np.int32)


# ---------------------------------------------------------------------------
# Metrics (Chamfer / Hausdorff / F-score over point sets)
# ---------------------------------------------------------------------------


class GeometryMetrics(NamedTuple):
    chamfer_distance: torch.Tensor
    hausdorff_distance: torch.Tensor
    fscore: torch.Tensor


def compute_metrics_point_cloud(
    a: PointCloud, b: PointCloud, fscore_radius: float = 0.01
) -> GeometryMetrics:
    """Chamfer / Hausdorff / F-score between the valid points of two clouds."""
    _, d2_ab = nns.one_nn_search(a.positions, b.positions, target_mask=b.mask)
    _, d2_ba = nns.one_nn_search(b.positions, a.positions, target_mask=a.mask)
    d_ab = torch.sqrt(torch.clamp(d2_ab, min=0.0))
    d_ba = torch.sqrt(torch.clamp(d2_ba, min=0.0))
    na = torch.clamp(a.mask.sum(), min=1)
    nb = torch.clamp(b.mask.sum(), min=1)
    chamfer = (torch.where(a.mask, d_ab, 0.0).sum() / na
               + torch.where(b.mask, d_ba, 0.0).sum() / nb)
    haus = torch.maximum(torch.where(a.mask, d_ab, 0.0).max(), torch.where(b.mask, d_ba, 0.0).max())
    prec = torch.where(a.mask, (d_ab < fscore_radius).to(torch.float32), 0.0).sum() / na
    rec = torch.where(b.mask, (d_ba < fscore_radius).to(torch.float32), 0.0).sum() / nb
    f = 2.0 * prec * rec / torch.clamp(prec + rec, min=1e-12)
    return GeometryMetrics(chamfer, haus, f)


def compute_metrics_mesh(
    a: TriangleMesh, b: TriangleMesh, n_samples: int = 20000,
    fscore_radius: float = 0.01, key=None,
) -> GeometryMetrics:
    """The metrics between `n_samples` uniform samples of each mesh, drawn
    from one generator, `a`'s first."""
    gen = _generator(key, a.device)
    return compute_metrics_point_cloud(
        a.sample_points_uniformly(n_samples, gen),
        b.sample_points_uniformly(n_samples, gen),
        fscore_radius,
    )
