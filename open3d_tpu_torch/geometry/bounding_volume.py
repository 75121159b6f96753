"""Axis-aligned and oriented bounding boxes (port of
open3d_tpu/geometry/bounding_volume.py).

Boxes are small frozen records of tensors; membership is a vectorised
mask over fixed-capacity point arrays. The minimal OBB takes the convex
hull on the host (scipy's Qhull, as the reference does), then scores the
frame of every hull face in one batch and keeps the smallest volume.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from open3d_tpu_torch.core.platform import default_device


def _corner_selector(dev) -> torch.Tensor:
    """(8, 3): corner c's bit a is its +axis-a side."""
    return torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                        dtype=torch.float32, device=dev)


def _right_handed(R: torch.Tensor) -> torch.Tensor:
    """Flip the first column of a frame whose determinant is negative."""
    flip = torch.ones(3, dtype=R.dtype, device=R.device)
    flip[0] = -1.0
    return torch.where(torch.linalg.det(R) < 0, R * flip, R)


@dataclasses.dataclass(frozen=True)
class AxisAlignedBoundingBox:
    min_bound: torch.Tensor  # (3,) float32
    max_bound: torch.Tensor  # (3,) float32

    @staticmethod
    def create_from_points(points: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> "AxisAlignedBoundingBox":
        p = points.to(torch.float32)
        if mask is not None:
            lo = torch.where(mask[:, None], p, float("inf")).amin(0)
            hi = torch.where(mask[:, None], p, float("-inf")).amax(0)
        else:
            lo, hi = p.amin(0), p.amax(0)
        return AxisAlignedBoundingBox(min_bound=lo, max_bound=hi)

    def get_center(self) -> torch.Tensor:
        return 0.5 * (self.min_bound + self.max_bound)

    def get_extent(self) -> torch.Tensor:
        return self.max_bound - self.min_bound

    def get_half_extent(self) -> torch.Tensor:
        return 0.5 * self.get_extent()

    def get_max_extent(self) -> torch.Tensor:
        return self.get_extent().amax()

    def volume(self) -> torch.Tensor:
        return torch.prod(torch.clamp(self.get_extent(), min=0.0))

    def get_box_points(self) -> torch.Tensor:
        """(8, 3) corners."""
        lo, hi = self.min_bound, self.max_bound
        return lo + _corner_selector(lo.device) * (hi - lo)

    def contains(self, points: torch.Tensor) -> torch.Tensor:
        return torch.all((points >= self.min_bound) & (points <= self.max_bound), dim=-1)

    def get_point_indices_within_bounding_box(
        self, points: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Boolean membership mask (the fixed-capacity form of an index list)."""
        inside = self.contains(points)
        return inside if mask is None else inside & mask

    def scale(self, s: float, center: Optional[torch.Tensor] = None):
        c = self.get_center() if center is None else center
        return AxisAlignedBoundingBox(min_bound=c + s * (self.min_bound - c),
                                      max_bound=c + s * (self.max_bound - c))

    def translate(self, t: torch.Tensor, relative: bool = True):
        t = torch.as_tensor(t, dtype=torch.float32, device=self.min_bound.device)
        if relative:
            return AxisAlignedBoundingBox(self.min_bound + t, self.max_bound + t)
        shift = t - self.get_center()
        return AxisAlignedBoundingBox(self.min_bound + shift, self.max_bound + shift)

    def get_oriented_bounding_box(self) -> "OrientedBoundingBox":
        return OrientedBoundingBox(
            center=self.get_center(),
            rotation=torch.eye(3, dtype=torch.float32, device=self.min_bound.device),
            extent=self.get_extent(),
        )


@dataclasses.dataclass(frozen=True)
class OrientedBoundingBox:
    center: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (3, 3), columns = box axes
    extent: torch.Tensor  # (3,) full edge lengths

    @staticmethod
    def create_from_axis_aligned_bounding_box(aabb: AxisAlignedBoundingBox):
        return aabb.get_oriented_bounding_box()

    @staticmethod
    def create_from_points(points: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> "OrientedBoundingBox":
        """PCA box: the mean and the covariance's eigenbasis, then the tight
        extents along those axes."""
        p = points.to(torch.float32)
        if mask is None:
            mask = torch.ones(p.shape[:1], dtype=torch.bool, device=p.device)
        w = mask.to(torch.float32)
        n = torch.clamp(w.sum(), min=1.0)
        mu = (p * w[:, None]).sum(0) / n
        d = torch.where(mask[:, None], p - mu, 0.0)
        cov = d.T @ d / n
        _, evecs = torch.linalg.eigh(cov)  # columns by ascending eigenvalue
        R = _right_handed(evecs)
        q = d @ R  # coordinates in the box frame
        lo = torch.where(mask[:, None], q, float("inf")).amin(0)
        hi = torch.where(mask[:, None], q, float("-inf")).amax(0)
        center = mu + R @ ((lo + hi) * 0.5)
        return OrientedBoundingBox(center=center, rotation=R, extent=hi - lo)

    @staticmethod
    def create_minimal(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       device=None) -> "OrientedBoundingBox":
        """Approximate minimal-volume OBB (Open3D's ComputeMinimumOBBApprox,
        a sweep of hull-face frames): the convex hull on the host, then the
        frame of every hull face (its normal n, the first edge projected off
        n, and n x that edge) scored in one batch; the smallest volume wins.
        The box lives on `points`' device when it is a tensor, else on
        `device` (default: the card)."""
        from open3d_tpu_torch.ops.segmentation import compute_convex_hull  # imports this module

        if isinstance(points, torch.Tensor) and device is None:
            dev = points.device
        else:
            dev = default_device(device)
        pts_np = points.cpu().numpy() if isinstance(points, torch.Tensor) else points
        msk_np = None if mask is None else (
            mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask, bool))
        hv_np, ht_np, _ = compute_convex_hull(np.asarray(pts_np, np.float32), msk_np)
        hv = torch.as_tensor(hv_np, dtype=torch.float32, device=dev)  # (V, 3) hull vertices
        tri = torch.as_tensor(ht_np, dtype=torch.int64, device=dev)  # (F, 3)

        a, b, c = hv[tri[:, 0]], hv[tri[:, 1]], hv[tri[:, 2]]
        n = torch.linalg.cross(b - a, c - a, dim=-1)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        e = b - a
        u = e - n * (e * n).sum(-1, keepdim=True)
        u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
        v = torch.linalg.cross(n, u, dim=-1)
        R = torch.stack([u, v, n], dim=-1)  # (F, 3, 3) candidate frames

        q = torch.einsum("vk,fkj->fvj", hv, R)  # (F, V, 3) hull vertices in each frame
        vol = torch.prod(q.amax(1) - q.amin(1), dim=-1)
        Rb = _right_handed(R[torch.argmin(vol)])
        qb = hv @ Rb
        lob, hib = qb.amin(0), qb.amax(0)
        return OrientedBoundingBox(center=Rb @ ((lob + hib) * 0.5), rotation=Rb,
                                   extent=hib - lob)

    def volume(self) -> torch.Tensor:
        return torch.prod(torch.clamp(self.extent, min=0.0))

    def get_box_points(self) -> torch.Tensor:
        local = (_corner_selector(self.center.device) - 0.5) * self.extent
        return self.center + local @ self.rotation.T

    def contains(self, points: torch.Tensor) -> torch.Tensor:
        q = (points - self.center) @ self.rotation  # box frame
        return torch.all(torch.abs(q) <= 0.5 * self.extent + 1e-7, dim=-1)

    def get_point_indices_within_bounding_box(
        self, points: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        inside = self.contains(points)
        return inside if mask is None else inside & mask

    def get_axis_aligned_bounding_box(self) -> AxisAlignedBoundingBox:
        return AxisAlignedBoundingBox.create_from_points(self.get_box_points())

    def rotate(self, R: torch.Tensor, center: Optional[torch.Tensor] = None):
        R = torch.as_tensor(R, dtype=torch.float32, device=self.center.device)
        c = self.center if center is None else torch.as_tensor(
            center, dtype=torch.float32, device=self.center.device)
        return OrientedBoundingBox(center=c + R @ (self.center - c), rotation=R @ self.rotation,
                                   extent=self.extent)

    def translate(self, t: torch.Tensor, relative: bool = True):
        t = torch.as_tensor(t, dtype=torch.float32, device=self.center.device)
        return OrientedBoundingBox(center=self.center + t if relative else t,
                                   rotation=self.rotation, extent=self.extent)

    def transform(self, T: torch.Tensor):
        T = torch.as_tensor(T, dtype=torch.float32, device=self.center.device)
        R, t = T[:3, :3], T[:3, 3]
        return OrientedBoundingBox(center=R @ self.center + t, rotation=R @ self.rotation,
                                   extent=self.extent)
