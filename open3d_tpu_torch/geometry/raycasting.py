"""RaycastingScene: ray and distance queries against triangle meshes (port
of open3d_tpu/geometry/raycasting.py).

Two routes, as in the reference: a scene of at least `bvh_threshold`
triangles casts rays and finds closest points through the Morton BVH
(geometry/bvh.py); a smaller one, and `count_intersections` at any size,
through the brute force over every (ray, triangle) pair. The brute force
runs in blocks of rays by tiles of triangles sized so that the block's
intermediates stay within `_PAIR_BYTES`; it keeps the first triangle at a
tie, as the reference's tile scan does (argmin within a tile, strict `<`
across tiles). Every float32 product sum is written out left to right, so
a scene on the card and its CPU copy decide each hit alike; the
one-direction count (occupancy's) is a float64 product instead, whose
rounding lies far below the float32 terms.

The sign of the signed distance is ray-parity occupancy (an odd number of
crossings along a fixed direction is inside), for watertight meshes.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry import bvh as bvh_mod
from open3d_tpu_torch.geometry.bvh import _cross, _dot, _sq

_BIG = 3.0e38
_EPS = 1e-9
# bytes of (ray, triangle) intermediates a brute-force block may hold: on
# the card large blocks keep the launches few; on the CPU a block that stays
# in cache runs about 3x faster than a 1 GB one
_PAIR_BYTES = {"cuda": 1 << 30, "cpu": 1 << 26}
# compute_occupancy's probe direction: an axis-aligned one hits shared
# triangle edges exactly on symmetric meshes and double-counts
_PROBE = (0.9212961, 0.3716541, 0.1130201)


def _blocks(R: int, T: int, tile: int, bytes_per_pair: int, device: torch.device):
    """(ray slices, triangle slices) of a brute force over R x T pairs."""
    tc = max(min(tile, T), 1)
    rc = max(_PAIR_BYTES.get(device.type, _PAIR_BYTES["cuda"]) // (bytes_per_pair * tc), 1)
    return ([slice(s, min(s + rc, R)) for s in range(0, R, rc)],
            [slice(s, min(s + tc, T)) for s in range(0, T, tc)])


def _moller_trumbore(o, d, v0, e1, e2):
    """Rays (r, 1, 3) against triangles (1, t, 3) -> (t, u, v, hit), each
    (r, t)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > _EPS
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > _EPS)
    return t, u, v, hit


def _count_one_direction(o, d, v0, e1, e2):
    """Moller-Trumbore's hit count for rays from origins `o` (R, 3) along
    one direction `d` (3,). With d fixed, u, v and t are each linear in the
    origin: u = (o - v0) . p / det with p = d x e2, v = (o - v0) . (e1 x d)
    / det and t = (o - v0) . (e1 x e2) / det, det = e1 . p (the reference's
    triple products, rearranged), so one float64 product [o, 1] @ W gives
    all three for a block of rays and triangles. float64 keeps the rounding
    far below the reference's float32 terms, on the card and on the CPU
    alike, whatever the float32 matmul precision; a triangle with |det| <=
    1e-9 gets t = 0 and never counts."""
    dd = d.double()
    e1d, e2d, v0d = e1.double(), e2.double(), v0.double()
    pvec = _cross(dd, e2d)
    det = _dot(e1d, pvec)
    inv = torch.where(det.abs() > _EPS, 1.0 / det, 0.0)
    k = torch.stack([pvec, _cross(e1d, dd), _cross(e1d, e2d)], 1) * inv[:, None, None]
    W = torch.cat([k, -(k * v0d[:, None, :]).sum(-1, keepdim=True)], -1)  # (T, 3 [u v t], 4)
    R, T = o.shape[0], v0.shape[0]
    cnt = torch.zeros(R, dtype=torch.int32, device=o.device)
    ray_blocks, tiles = _blocks(R, T, 16384, 48, o.device)
    tiles = [(ts, W[ts].permute(2, 1, 0).reshape(4, -1)) for ts in tiles]
    for rs in ray_blocks:
        o4 = torch.cat([o[rs].double(), torch.ones_like(o[rs, :1], dtype=torch.float64)], 1)
        for ts, w in tiles:
            uvt = (o4 @ w).view(-1, 3, ts.stop - ts.start)
            u, v, t = uvt[:, 0], uvt[:, 1], uvt[:, 2]
            hit = (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS) & (t > _EPS)
            cnt[rs] += hit.sum(1, dtype=torch.int32)
    return cnt


def _closest_point_on_triangle(p, a, b, c):
    """Ericson RTCD 5.1.5 by regions, as the reference's brute force runs
    it: points (r, 1, 3), triangles (1, t, 3) -> (r, t, 3)."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=_EPS)
    res = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
    # edge and vertex regions override in the reference's order
    t_ab = torch.clamp(d1 / torch.where((d1 - d3).abs() > _EPS, d1 - d3, 1.0), 0.0, 1.0)
    on = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    res = torch.where(on[..., None], a + t_ab[..., None] * ab, res)
    t_ac = torch.clamp(d2 / torch.where((d2 - d6).abs() > _EPS, d2 - d6, 1.0), 0.0, 1.0)
    on = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    res = torch.where(on[..., None], a + t_ac[..., None] * ac, res)
    den = (d4 - d3) + (d5 - d6)
    t_bc = torch.clamp((d4 - d3) / torch.where(den.abs() > _EPS, den, 1.0), 0.0, 1.0)
    on = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    res = torch.where(on[..., None], b + t_bc[..., None] * (c - b), res)
    res = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, res)
    res = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, res)
    return torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, res)


def _unit_normals(e1, e2):
    n = _cross(e1, e2)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)


class RaycastingScene:
    """Mirror of t/geometry/RaycastingScene.h:43.

    `add_triangles()` takes (V, 3) vertices and (T, 3) triangles and returns
    a geometry id. The scene lives on `device`: by default the device of the
    first tensor added, else the card."""

    def __init__(self, tile: int = 2048, bvh_threshold: int = 4096, device=None):
        self._v0, self._v1, self._v2, self._geom_of_tri = [], [], [], []
        self._tile = tile
        # at or above this triangle count, cast_rays and
        # compute_closest_points go through the BVH
        self._bvh_threshold = bvh_threshold
        self._device = device
        self._packed = None
        self._bvh = None

    def _dev(self, x=None) -> torch.device:
        if self._device is None:
            self._device = x.device if isinstance(x, torch.Tensor) else default_device(None)
        return torch.device(self._device)

    def add_triangles(self, vertices, triangles) -> int:
        dev = self._dev(vertices)
        vertices = torch.as_tensor(vertices, dtype=torch.float32, device=dev)
        triangles = torch.as_tensor(triangles, device=dev).to(torch.int64)
        gid = len(self._geom_of_tri)
        self._v0.append(vertices[triangles[:, 0]])
        self._v1.append(vertices[triangles[:, 1]])
        self._v2.append(vertices[triangles[:, 2]])
        self._geom_of_tri.append(torch.full((triangles.shape[0],), gid, dtype=torch.int32,
                                            device=dev))
        self._packed = None
        self._bvh = None
        return gid

    def _pack(self):
        if self._packed is None:
            v0, v1, v2 = (torch.cat(x, 0) for x in (self._v0, self._v1, self._v2))
            self._packed = (v0, v1, v2, torch.cat(self._geom_of_tri, 0))
        return self._packed

    def _get_bvh(self):
        if self._bvh is None:
            v0, v1, v2, _ = self._pack()
            T = v0.shape[0]
            tris = torch.arange(3 * T, device=v0.device).reshape(3, T).T
            self._bvh = bvh_mod.build_bvh(torch.cat([v0, v1, v2], 0), tris)
        return self._bvh

    def _rays(self, rays, width: int):
        r = torch.as_tensor(rays, dtype=torch.float32, device=self._dev())
        return r.reshape(-1, width), tuple(r.shape[:-1])

    # ---- ray queries -----------------------------------------------------

    def cast_rays(self, rays):
        """rays: (..., 6) [origin, direction]. Returns a dict with t_hit (inf
        on a miss), geometry_ids, primitive_ids, primitive_normals and
        primitive_uvs (ref: RaycastingScene::CastRays)."""
        v0, v1, v2, gid = self._pack()
        r, shape = self._rays(rays, 6)
        e1, e2 = v1 - v0, v2 - v0
        T, R = v0.shape[0], r.shape[0]
        if T >= self._bvh_threshold:
            bt, bi, buv = bvh_mod.cast_rays(self._get_bvh(), r[:, :3], r[:, 3:])
        else:
            bt = torch.full((R,), _BIG, device=r.device)
            bi = torch.full((R,), -1, dtype=torch.int64, device=r.device)
            buv = torch.zeros((R, 2), device=r.device)
            ray_blocks, tiles = _blocks(R, T, self._tile, 160, r.device)
            for rs in ray_blocks:
                o, d = r[rs, None, :3], r[rs, None, 3:]
                for ts in tiles:
                    t, u, v, hit = _moller_trumbore(o, d, v0[None, ts], e1[None, ts],
                                                    e2[None, ts])
                    t = torch.where(hit, t, _BIG)
                    tmin, j = t.min(1)
                    take = tmin < bt[rs]
                    bt[rs] = torch.where(take, tmin, bt[rs])
                    bi[rs] = torch.where(take, j + ts.start, bi[rs])
                    uv = torch.stack([u.gather(1, j[:, None])[:, 0], v.gather(1, j[:, None])[:, 0]],
                                     -1)
                    buv[rs] = torch.where(take[:, None], uv, buv[rs])
        bi = bi.to(torch.int64)
        safe = torch.clamp(bi, min=0)
        miss = bi < 0
        return {
            "t_hit": torch.where(miss, float("inf"), bt).reshape(shape),
            "geometry_ids": torch.where(miss, -1, gid[safe]).reshape(shape),
            "primitive_ids": bi.to(torch.int32).reshape(shape),
            "primitive_normals": torch.where(miss[:, None], 0.0, _unit_normals(e1[safe], e2[safe]))
            .reshape(shape + (3,)),
            "primitive_uvs": torch.where(miss[:, None], 0.0, buv).reshape(shape + (2,)),
        }

    def count_intersections(self, rays):
        """The number of triangles each ray crosses, over every triangle
        (ref: RaycastingScene::CountIntersections). Rays of one shared
        direction (compute_occupancy's) take `_count_one_direction`."""
        v0, v1, v2, _ = self._pack()
        r, shape = self._rays(rays, 6)
        e1, e2 = v1 - v0, v2 - v0
        R, T = r.shape[0], v0.shape[0]
        if R > 0 and bool((r[:, 3:] == r[:1, 3:]).all()):
            return _count_one_direction(r[:, :3], r[0, 3:], v0, e1, e2).reshape(shape)
        cnt = torch.zeros(R, dtype=torch.int32, device=r.device)
        ray_blocks, tiles = _blocks(R, T, max(self._tile, 8192), 160, r.device)
        for rs in ray_blocks:
            for ts in tiles:
                hit = _moller_trumbore(r[rs, None, :3], r[rs, None, 3:], v0[None, ts],
                                       e1[None, ts], e2[None, ts])[3]
                cnt[rs] += hit.sum(1, dtype=torch.int32)
        return cnt.reshape(shape)

    # ---- distance queries --------------------------------------------------

    def compute_closest_points(self, points):
        """(ref: RaycastingScene::ComputeClosestPoints) Returns a dict with
        points (the closest surface points), primitive_ids, geometry_ids,
        primitive_normals and distance2."""
        v0, v1, v2, gid = self._pack()
        p, shape = self._rays(points, 3)
        T, Q = v0.shape[0], p.shape[0]
        if T >= self._bvh_threshold:
            bp, bi, dist = bvh_mod.closest_points(self._get_bvh(), p)
            bd = dist * dist
        else:
            bd = torch.full((Q,), _BIG, device=p.device)
            bi = torch.full((Q,), -1, dtype=torch.int64, device=p.device)
            bp = torch.zeros((Q, 3), device=p.device)
            ray_blocks, tiles = _blocks(Q, T, self._tile, 480, p.device)
            for rs in ray_blocks:
                q = p[rs, None]
                for ts in tiles:
                    cp = _closest_point_on_triangle(q, v0[None, ts], v1[None, ts], v2[None, ts])
                    dmin, j = _sq(cp - q).min(1)
                    take = dmin < bd[rs]
                    bd[rs] = torch.where(take, dmin, bd[rs])
                    bi[rs] = torch.where(take, j + ts.start, bi[rs])
                    bp[rs] = torch.where(take[:, None],
                                         cp.gather(1, j[:, None, None].expand(-1, 1, 3))[:, 0],
                                         bp[rs])
        safe = torch.clamp(bi.to(torch.int64), min=0)
        return {
            "points": bp.reshape(shape + (3,)),
            "primitive_ids": bi.to(torch.int32).reshape(shape),
            "geometry_ids": gid[safe].reshape(shape),
            "primitive_normals": _unit_normals(v1[safe] - v0[safe], v2[safe] - v0[safe])
            .reshape(shape + (3,)),
            "distance2": bd.reshape(shape),
        }

    def compute_distance(self, points):
        """(ref: RaycastingScene::ComputeDistance)"""
        return torch.sqrt(torch.clamp(self.compute_closest_points(points)["distance2"], min=0.0))

    def compute_occupancy(self, points):
        """1.0 inside, 0.0 outside, by the crossing parity of a ray along a
        fixed direction on a watertight mesh
        (ref: RaycastingScene::ComputeOccupancy)."""
        p, shape = self._rays(points, 3)
        d = torch.tensor(_PROBE, device=p.device).expand(p.shape[0], 3)
        cnt = self.count_intersections(torch.cat([p, d], -1))
        return (cnt % 2 == 1).to(torch.float32).reshape(shape)

    def compute_signed_distance(self, points):
        """(ref: RaycastingScene::ComputeSignedDistance): negative inside."""
        dist = self.compute_distance(points)
        occ = self.compute_occupancy(points)
        return torch.where(occ > 0.5, -dist, dist)


def create_rays_pinhole(intrinsic, extrinsic, width_px: int, height_px: int, device=None):
    """(H, W, 6) world-space rays through each pixel centre, with
    camera-frame direction z = 1, so t_hit is depth
    (ref: RaycastingScene::CreateRaysPinhole). `device` defaults to that of
    `extrinsic` when it is a tensor, else to the card."""
    dev = extrinsic.device if device is None and isinstance(extrinsic, torch.Tensor) \
        else default_device(device)
    K = (intrinsic.intrinsic_matrix_on(dev) if hasattr(intrinsic, "intrinsic_matrix_on")
         else torch.as_tensor(intrinsic, dtype=torch.float32, device=dev))
    E = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
    Tcw = torch.linalg.inv(E)  # camera -> world
    v, u = torch.meshgrid(torch.arange(height_px, dtype=torch.float32, device=dev) + 0.5,
                          torch.arange(width_px, dtype=torch.float32, device=dev) + 0.5,
                          indexing="ij")
    x = (u - K[0, 2]) / K[0, 0]
    y = (v - K[1, 2]) / K[1, 1]
    dirs_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    dirs = dirs_cam @ Tcw[:3, :3].T
    origin = Tcw[:3, 3].expand(dirs.shape)
    return torch.cat([origin, dirs], -1).reshape(height_px, width_px, 6)
