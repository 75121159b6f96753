"""Pinhole camera models (port of open3d_tpu/geometry/camera.py).

Intrinsics are host metadata (Python floats and ints); the 3x3 matrix is
made on demand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from open3d_tpu_torch.core.platform import default_device


@dataclasses.dataclass(frozen=True)
class PinholeCameraIntrinsic:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def intrinsic_matrix(self) -> torch.Tensor:
        """The 3x3 matrix on the card (`core.platform.default_device`), read
        as an attribute, as the reference's callers read it."""
        return self.intrinsic_matrix_on(None)

    def intrinsic_matrix_on(self, device) -> torch.Tensor:
        """The 3x3 matrix on `device` (the card when None)."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
            device=default_device(device),
        )

    def scaled(self, factor: float) -> "PinholeCameraIntrinsic":
        """Intrinsics for an image resized by `factor` (e.g. 0.5 per pyramid level)."""
        return PinholeCameraIntrinsic(
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
        )

    @staticmethod
    def prime_sense_default() -> "PinholeCameraIntrinsic":
        """PrimeSense preset: 640x480, fx=fy=525, cx=319.5, cy=239.5."""
        return PinholeCameraIntrinsic(640, 480, 525.0, 525.0, 319.5, 239.5)

    @staticmethod
    def from_matrix(width: int, height: int, K) -> "PinholeCameraIntrinsic":
        """From a 3x3 matrix (a tensor on any device, or an array)."""
        K = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
        return PinholeCameraIntrinsic(width, height, float(K[0, 0]), float(K[1, 1]),
                                      float(K[0, 2]), float(K[1, 2]))


@dataclasses.dataclass
class PinholeCameraParameters:
    """Intrinsic + world-to-camera extrinsic."""

    intrinsic: PinholeCameraIntrinsic
    extrinsic: torch.Tensor  # (4, 4) world -> camera


@dataclasses.dataclass
class PinholeCameraTrajectory:
    parameters: list[PinholeCameraParameters]
