"""LineSet: fixed-capacity point positions and line index pairs (port of
open3d_tpu/geometry/lineset.py).

Like PointCloud, invalid point rows are parked at FAR_COORD under a mask
and invalid lines carry a False line mask, so every operation keeps its
shapes. Per-point and per-line attributes are dicts of (N, ...) and
(L, ...) tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from open3d_tpu_torch.core.masking import FAR_COORD, pad_axis0
from open3d_tpu_torch.core.platform import default_device


def _on(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), dtype=dtype,
                           device=dev)


@dataclasses.dataclass(frozen=True)
class LineSet:
    points: torch.Tensor  # (N, 3) float32; invalid rows at FAR_COORD
    point_mask: torch.Tensor  # (N,) bool
    lines: torch.Tensor  # (L, 2) int32
    line_mask: torch.Tensor  # (L,) bool
    point_attrs: Dict[str, torch.Tensor]
    line_attrs: Dict[str, torch.Tensor]  # e.g. "colors" (L, 3)

    @staticmethod
    def create(
        points,
        lines,
        point_mask=None,
        line_mask=None,
        point_attrs: Optional[Dict] = None,
        line_attrs: Optional[Dict] = None,
        point_capacity: Optional[int] = None,
        line_capacity: Optional[int] = None,
        device=None,
    ) -> "LineSet":
        """Build from host or device arrays, padded to the capacities.
        `device` defaults to that of `points` when it is a tensor, else to
        the card."""
        if device is None and isinstance(points, torch.Tensor):
            dev = points.device
        else:
            dev = default_device(device)
        points = _on(points, torch.float32, dev)
        lines = _on(lines, torch.int32, dev)
        n, l = points.shape[0], lines.shape[0]
        pc = int(point_capacity or n)
        lc = int(line_capacity or l)
        pm = (torch.ones(n, dtype=torch.bool, device=dev) if point_mask is None
              else _on(point_mask, torch.bool, dev))
        lm = (torch.ones(l, dtype=torch.bool, device=dev) if line_mask is None
              else _on(line_mask, torch.bool, dev))
        points = pad_axis0(torch.where(pm[:, None], points, FAR_COORD), pc, FAR_COORD)
        lines = pad_axis0(torch.where(lm[:, None], lines, 0), lc, 0)
        pa = {k: pad_axis0(_on(v, torch.float32, dev), pc, 0)
              for k, v in (point_attrs or {}).items()}
        la = {k: pad_axis0(_on(v, torch.float32, dev), lc, 0)
              for k, v in (line_attrs or {}).items()}
        return LineSet(points=points, point_mask=pad_axis0(pm, pc, False), lines=lines,
                       line_mask=pad_axis0(lm, lc, False), point_attrs=pa, line_attrs=la)

    # ---- queries ------------------------------------------------------

    def num_points(self) -> torch.Tensor:
        return self.point_mask.to(torch.int32).sum()

    def num_lines(self) -> torch.Tensor:
        return self.line_mask.to(torch.int32).sum()

    def get_min_bound(self) -> torch.Tensor:
        return torch.where(self.point_mask[:, None], self.points, float("inf")).amin(0)

    def get_max_bound(self) -> torch.Tensor:
        return torch.where(self.point_mask[:, None], self.points, float("-inf")).amax(0)

    def line_lengths(self) -> torch.Tensor:
        a = self.points[self.lines[:, 0].long()]
        b = self.points[self.lines[:, 1].long()]
        return torch.where(self.line_mask, torch.linalg.norm(b - a, dim=-1), 0.0)

    # ---- transforms ---------------------------------------------------

    def _valid(self, p: torch.Tensor) -> "LineSet":
        return dataclasses.replace(self, points=torch.where(self.point_mask[:, None], p, FAR_COORD))

    def _center(self, center) -> torch.Tensor:
        if center is None:
            return 0.5 * (self.get_min_bound() + self.get_max_bound())
        return _on(center, torch.float32, self.points.device)

    def transform(self, T: torch.Tensor) -> "LineSet":
        T = _on(T, torch.float32, self.points.device)
        return self._valid(self.points @ T[:3, :3].T + T[:3, 3])

    def translate(self, t, relative: bool = True) -> "LineSet":
        t = _on(t, torch.float32, self.points.device)
        if not relative:
            t = t - self._center(None)
        return self._valid(self.points + t)

    def scale(self, s: float, center=None) -> "LineSet":
        c = self._center(center)
        return self._valid(c + s * (self.points - c))

    def rotate(self, R: torch.Tensor, center=None) -> "LineSet":
        c = self._center(center)
        return self._valid(c + (self.points - c) @ _on(R, torch.float32, self.points.device).T)

    # ---- converters ---------------------------------------------------

    @staticmethod
    def from_bounding_box(box) -> "LineSet":
        """The 12-edge wireframe of an AABB or OBB; corner c's bit a is its
        +axis-a side, and each edge joins c to c | (1 << a)."""
        corners = box.get_box_points()  # (8, 3)
        edges = [(c, c | (1 << a)) for c in range(8) for a in range(3) if not c >> a & 1]
        return LineSet.create(corners, torch.tensor(edges, dtype=torch.int32,
                                                    device=corners.device))

    @staticmethod
    def create_camera_visualization(intrinsic, extrinsic: torch.Tensor,
                                    scale: float = 0.1) -> "LineSet":
        """Frustum wireframe: the camera centre and the four image corners
        at depth `scale`, in world coordinates (extrinsic: world to camera)."""
        W, H = intrinsic.width, intrinsic.height
        dev = extrinsic.device
        corners_px = torch.tensor([[0.0, 0.0], [W, 0.0], [W, H], [0.0, H]],
                                  dtype=torch.float32, device=dev)
        x = (corners_px[:, 0] - intrinsic.cx) / intrinsic.fx
        y = (corners_px[:, 1] - intrinsic.cy) / intrinsic.fy
        frustum_cam = torch.cat([torch.zeros((1, 3), device=dev),
                                 torch.stack([x, y, torch.ones(4, device=dev)], dim=-1) * scale])
        R = extrinsic[:3, :3]
        t = extrinsic[:3, 3]
        pts = (frustum_cam - t) @ R  # camera -> world: R^T (p - t)
        lines = torch.tensor([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]],
                             dtype=torch.int32, device=dev)
        return LineSet.create(pts, lines)

    def to_numpy(self):
        pm = self.point_mask.cpu().numpy()
        lm = self.line_mask.cpu().numpy()
        return self.points.cpu().numpy()[pm], self.lines.cpu().numpy()[lm]
