"""Robust M-estimator kernels for registration and odometry (port of
open3d_tpu/pipelines/robust_kernels.py).

Each kernel is an IRLS weight function w(r) = (1/r) drho/dr applied
elementwise, chosen by `kind` when the estimator is built (Open3D's
RobustKernel.h: L2, L1, Huber, Cauchy, Geman-McClure, Tukey and Barron's
generalized loss).
"""

from __future__ import annotations

import dataclasses

import torch

L2 = "l2"
L1 = "l1"
HUBER = "huber"
CAUCHY = "cauchy"
GM = "gm"  # Geman-McClure
TUKEY = "tukey"
GENERALIZED = "generalized"


@dataclasses.dataclass(frozen=True)
class RobustKernel:
    """Kernel spec: scaling_parameter is the scale k; shape_parameter is the
    alpha of the generalized loss (read by GENERALIZED only)."""

    kind: str = L2
    scaling_parameter: float = 1.0
    shape_parameter: float = 1.0

    def weight(self, r: torch.Tensor) -> torch.Tensor:
        """IRLS weight w(r), as Open3D's RobustKernelImpl.h defines it."""
        k = self.scaling_parameter
        if self.kind == L2:
            return torch.ones_like(r)
        if self.kind == L1:
            return 1.0 / torch.clamp(torch.abs(r), min=1e-12)
        if self.kind == HUBER:
            return k / torch.clamp(torch.abs(r), min=k)
        if self.kind == CAUCHY:
            return 1.0 / (1.0 + (r / k) ** 2)
        if self.kind == GM:
            return k / (k + r * r) ** 2
        if self.kind == TUKEY:
            u = 1.0 - torch.clamp(torch.abs(r) / k, max=1.0) ** 2
            return u * u
        if self.kind == GENERALIZED:
            a, c = self.shape_parameter, k
            r2c2 = (r / c) ** 2
            if abs(a - 2.0) < 1e-9:
                return torch.full_like(r, 1.0 / (c * c))
            if abs(a) < 1e-9:
                return 2.0 / (r * r + 2.0 * c * c)
            if a < -1e7:  # -inf: Welsch
                return torch.exp(-0.5 * r2c2) / (c * c)
            return (1.0 / (c * c)) * (r2c2 / abs(a - 2.0) + 1.0) ** (a / 2.0 - 1.0)
        raise ValueError(f"unknown robust kernel {self.kind!r}")

