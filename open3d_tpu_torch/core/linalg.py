"""Small dense linear algebra (port of open3d_tpu/core/linalg.py).

Unrolled, batched and branch-free, as in the JAX package: the closed-form
symmetric 3x3 eigendecomposition and 3x3 solve, and the 6x6 Gauss-Newton
solve the tracking stage uses, all on the device with no host round trip.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigh3x3(A: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition, ascending eigenvalues.

    A: (..., 3, 3) symmetric (only the upper triangle is read). Returns
    (eigvals (..., 3) ascending, eigvecs (..., 3, 3) column-wise): the
    trigonometric eigenvalues (Smith 1961) and cross-product eigenvectors,
    accurate to ~1e-6 relative for well-scaled inputs."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    # scale for conditioning
    scale = torch.clamp(torch.stack([a00.abs(), a01.abs(), a02.abs(), a11.abs(), a12.abs(),
                                     a22.abs()], dim=-1).amax(-1), min=_EPS)
    a00, a01, a02 = a00 / scale, a01 / scale, a02 / scale
    a11, a12, a22 = a11 / scale, a12 / scale, a22 / scale

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.clamp(p, min=_EPS)

    # det(B / p) / 2
    c00, c01, c02 = b00 / p_safe, a01 / p_safe, a02 / p_safe
    c11, c12, c22 = b11 / p_safe, a12 / p_safe, b22 / p_safe
    det = (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)
           + c02 * (c01 * c12 - c11 * c02))
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e2 = q + 2.0 * p * torch.cos(phi)  # largest
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e1 = 3.0 * q - e0 - e2
    evals = torch.stack([e0, e1, e2], dim=-1)

    def eigvec(lam):
        # the rows of A - lam I; the longest cross product of two spans
        # the null space
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01v = torch.linalg.cross(r0, r1, dim=-1)
        c12v = torch.linalg.cross(r1, r2, dim=-1)
        c02v = torch.linalg.cross(r0, r2, dim=-1)
        n = torch.stack([(c * c).sum(-1) for c in (c01v, c12v, c02v)], dim=-1)
        best = torch.argmax(n, dim=-1)
        v = torch.where((best == 0)[..., None], c01v, torch.where((best == 1)[..., None], c12v, c02v))
        return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=_EPS))

    v0 = eigvec(e0)
    v2 = eigvec(e2)
    # v1 = v2 x v0 makes a right-handed orthonormal frame; v0 is then
    # orthogonalised against the other two for near-degenerate spectra
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    v1 = v1 / torch.sqrt(torch.clamp((v1 * v1).sum(-1, keepdim=True), min=_EPS))
    v0 = torch.linalg.cross(v1, v2, dim=-1)

    evecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    # degenerate (p ~ 0): A ~ q I, the identity basis
    iso = (p < 1e-10)[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(evecs.shape)
    return evals * scale[..., None], torch.where(iso, eye, evecs)


def solve3x3(A: torch.Tensor, b: torch.Tensor, damping: float = 1e-9) -> torch.Tensor:
    """Batched (..., 3, 3) @ x = (..., 3) through the adjugate (closed form,
    branch-free); a singular system gives 0."""
    A = A + damping * torch.eye(3, dtype=A.dtype, device=A.device)
    a, b_, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b_ * i
    co02 = b_ * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b_ * g - a * h
    co22 = a * e - b_ * d
    det = a * co00 + b_ * co10 + c * co20
    inv_det = 1.0 / torch.where(det.abs() < _EPS, float("inf"), det)
    x0 = (co00 * b[..., 0] + co01 * b[..., 1] + co02 * b[..., 2]) * inv_det
    x1 = (co10 * b[..., 0] + co11 * b[..., 1] + co12 * b[..., 2]) * inv_det
    x2 = (co20 * b[..., 0] + co21 * b[..., 1] + co22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def cholesky6x6(A: torch.Tensor) -> torch.Tensor:
    """Unrolled batched Cholesky for (..., 6, 6) SPD matrices."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = d
        for i in range(j + 1, 6):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(6)], dim=-1) for i in range(6)]
    return torch.stack(rows, dim=-2)


def solve_cholesky6x6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 6, 6) @ x = (..., 6) via unrolled Cholesky."""
    L = cholesky6x6(A)
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_gn_6x6(JtJ: torch.Tensor, Jtr: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """Solve the Gauss-Newton normal equations JtJ dx = -Jtr with relative
    Tikhonov damping (float32-safe)."""
    diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
    lam = damping * torch.clamp(torch.amax(diag, dim=-1), min=1.0)
    eye = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + lam[..., None, None] * eye
    return solve_cholesky6x6(A, -Jtr)
