"""PointCloud: a fixed-capacity, masked point cloud (port of
open3d_tpu/geometry/pointcloud.py: the container, its transforms, bounds
and selection).

`positions (N, 3) f32`, `mask (N,) bool` and an `attrs` dict of (N, ...)
tensors ("normals", "colors", ...). N is the capacity; invalid rows are
parked at FAR_COORD. Methods return new clouds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.masking import FAR_COORD, masked_max, masked_mean, masked_min, pad_axis0
from open3d_tpu_torch.core.platform import default_device


@dataclasses.dataclass(frozen=True)
class PointCloud:
    positions: torch.Tensor  # (N, 3) float32; invalid rows at FAR_COORD
    mask: torch.Tensor  # (N,) bool
    attrs: Dict[str, torch.Tensor]  # each (N, ...): "normals", "colors", ...

    @staticmethod
    def create(positions, capacity: Optional[int] = None, mask=None, device=None,
               **attrs) -> "PointCloud":
        """Build from host or device arrays, padded to `capacity`. `device`
        defaults to that of `positions` when it is a tensor, else to the card."""
        if device is None and isinstance(positions, torch.Tensor):
            dev = positions.device
        else:
            dev = default_device(device)

        def arr(x, dtype=None):
            t = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=dev)
            if dtype is not None:
                t = t.to(dtype)
            elif t.dtype == torch.float64:
                t = t.to(torch.float32)
            return t

        positions = arr(positions, torch.float32)
        n = positions.shape[0]
        capacity = int(capacity) if capacity is not None else n
        mask = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else arr(mask, torch.bool)
        positions = pad_axis0(torch.where(mask[:, None], positions, FAR_COORD), capacity, FAR_COORD)
        mask = pad_axis0(mask, capacity, False)
        a = {k: pad_axis0(arr(v), capacity, 0) for k, v in attrs.items() if v is not None}
        return PointCloud(positions=positions, mask=mask, attrs=a)

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (an int32 tensor on the cloud's device)."""
        return torch.sum(self.mask.to(torch.int32))

    @property
    def normals(self) -> Optional[torch.Tensor]:
        return self.attrs.get("normals")

    @property
    def colors(self) -> Optional[torch.Tensor]:
        return self.attrs.get("colors")

    def has(self, key: str) -> bool:
        return key in self.attrs

    def with_attrs(self, **attrs) -> "PointCloud":
        new = dict(self.attrs)
        for k, v in attrs.items():
            if v is None:
                new.pop(k, None)
            else:
                new[k] = v
        return dataclasses.replace(self, attrs=new)

    def valid_positions(self, fill=FAR_COORD) -> torch.Tensor:
        return torch.where(self.mask[:, None], self.positions, fill)

    # ---- geometry transforms ----

    def _vec(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.positions.device)

    def _valid(self, pos: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask[:, None], pos, FAR_COORD)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        attrs = dict(self.attrs)
        if "normals" in attrs:
            attrs["normals"] = lie.rotate_vectors(T, attrs["normals"])
        return dataclasses.replace(self, positions=self._valid(lie.transform_points(T, self.positions)),
                                   attrs=attrs)

    def translate(self, t, relative: bool = True) -> "PointCloud":
        t = self._vec(t)
        pos = self.positions + t if relative else self.positions - self.get_center() + t
        return dataclasses.replace(self, positions=self._valid(pos))

    def rotate(self, R: torch.Tensor, center) -> "PointCloud":
        center = self._vec(center)
        Rt = torch.swapaxes(R, -1, -2)
        attrs = dict(self.attrs)
        if "normals" in attrs:
            attrs["normals"] = attrs["normals"] @ Rt
        return dataclasses.replace(self, positions=self._valid((self.positions - center) @ Rt + center),
                                   attrs=attrs)

    def scale(self, s: float, center) -> "PointCloud":
        center = self._vec(center)
        return dataclasses.replace(self, positions=self._valid((self.positions - center) * s + center))

    # ---- bounds ----

    def get_min_bound(self) -> torch.Tensor:
        return masked_min(self.positions, self.mask, axis=0)

    def get_max_bound(self) -> torch.Tensor:
        return masked_max(self.positions, self.mask, axis=0)

    def get_center(self) -> torch.Tensor:
        return masked_mean(self.positions, self.mask, axis=0)

    # ---- selection ----

    def select_by_mask(self, keep: torch.Tensor) -> "PointCloud":
        """AND a boolean (N,) predicate into the validity mask."""
        mask = self.mask & keep
        return dataclasses.replace(self, mask=mask,
                                   positions=torch.where(mask[:, None], self.positions, FAR_COORD))

    def crop(self, min_bound, max_bound) -> "PointCloud":
        inside = torch.all((self.positions >= self._vec(min_bound))
                           & (self.positions <= self._vec(max_bound)), dim=-1)
        return self.select_by_mask(inside)

    def to_numpy(self) -> dict:
        """The valid rows as host numpy arrays."""
        mask = self.mask.cpu().numpy()
        out = {"positions": self.positions.cpu().numpy()[mask]}
        for k, v in self.attrs.items():
            out[k] = v.cpu().numpy()[mask]
        return out
