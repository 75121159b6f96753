"""SO(3)/SE(3) Lie-group utilities (port of open3d_tpu/core/lie.py).

Conventions as in the JAX package:
- pose 6-vector xi = [omega (3), v (3)], rotation first;
- transforms are (..., 4, 4) row-major matrices acting on column vectors;
- every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    rows = [
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """(sin t / t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor guards at t ~ 0."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS**2))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3). Stable for theta in [0, pi], with the same
    branches as the JAX package (small angle, mid range, near pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_raw = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    small = cos_theta > 1.0 - 1e-7
    cos_mid = torch.clamp(torch.where(small, torch.zeros_like(cos_theta), cos_theta), -1.0, 1.0 - 1e-7)
    theta = torch.arccos(cos_mid)
    sin_theta = torch.sin(theta)
    scale_mid = theta / torch.clamp(sin_theta, min=_EPS)
    scale_small = 1.0 + (1.0 - cos_theta) / 3.0
    scale = torch.where(small, scale_small, scale_mid)
    w = w_raw * scale[..., None]
    # near pi: recover the axis from the symmetric part
    near_pi = theta > 3.0
    B = 0.5 * (R + R.transpose(-1, -2))
    denom = torch.clamp(1.0 - cos_theta, min=_EPS)
    outer = (B - cos_theta[..., None, None] * _eye3(R)) / denom[..., None, None]
    n2 = torch.clamp(
        torch.stack([outer[..., 0, 0], outer[..., 1, 1], outer[..., 2, 2]], dim=-1), min=0.0
    )
    n2 = torch.where(near_pi[..., None], n2, torch.ones_like(n2))
    k = torch.argmax(n2, dim=-1)
    row = torch.gather(outer, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    nk = torch.sqrt(torch.gather(n2, -1, k[..., None]))[..., 0]
    axis = row / torch.clamp(nk, min=_EPS)[..., None]
    s = torch.where(torch.sum(axis * w_raw, dim=-1) < 0.0, -1.0, 1.0)
    w_raw_safe = torch.where(near_pi[..., None], w_raw, torch.ones_like(w_raw))
    sin_norm = torch.clamp(torch.linalg.norm(w_raw_safe, dim=-1), 0.0, 1.0 - 1e-7)
    theta_pi = math.pi - torch.arcsin(sin_norm)
    w_pi = axis * (s * theta_pi)[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def rt_to_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4). Built by concatenation, not
    in-place writes, so that torch.func.vmap and jacfwd trace it."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [omega, v] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_terms(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    return rt_to_transform(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [omega, v]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    W = hat(w)
    W2 = W @ W
    coef = torch.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / torch.clamp(theta2, min=_EPS),
    )
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Fast inverse of a rigid transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_transform(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) rigid transform to (..., 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part (e.g. to normals)."""
    return vecs @ T[..., :3, :3].transpose(-1, -2)


def pose_distance(Ta: torch.Tensor, Tb: torch.Tensor):
    """(rot_angle_rad, trans_dist) between two transforms."""
    dT = invert_se3(Ta) @ Tb
    w = so3_log(dT[..., :3, :3])
    return torch.linalg.norm(w, dim=-1), torch.linalg.norm(dT[..., :3, 3], dim=-1)
