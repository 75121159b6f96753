"""ICP registration (port of open3d_tpu/pipelines/registration.py).

Open3D's ICP, MultiScaleICP, EvaluateRegistration and GetInformationMatrix
with the point-to-point, point-to-plane, coloured, generalized and Doppler
estimations.

- Correspondences come from core/nns.py: the sorted-band 1-NN on clouds of
  8192 points or more (its window carries the target columns the
  estimation reads, so no per-correspondence gather follows), else the
  exact brute-force 1-NN or the hash grid.
- The Gauss-Newton normal equations are (6, N) @ (N, 6) and (6, N) @ (N,)
  products, solved by the unrolled 6x6 Cholesky of core/linalg.py.
- The loop runs `max_iteration` iterations with an on-device `converged`
  flag that freezes the pose, fitness, rmse and iteration count once the
  relative changes fall under the criteria: the JAX package's while_loop
  result, with no host read of its own. (The hash grid's probe reads its
  progress once a round, and the generalized estimation's batched
  `torch.linalg.eigh` checks its result on the host.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from open3d_tpu_torch.core import lie, linalg, nns, nns_grid
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.ops import pointcloud as pc_ops
from open3d_tpu_torch.pipelines.robust_kernels import RobustKernel

# ---------------------------------------------------------------------------
# Results / criteria
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    """A registration's pose and scores; a num_iterations left out is 0 on
    the card (default_device)."""

    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # () inliers / valid source points
    inlier_rmse: torch.Tensor  # ()
    num_iterations: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((), dtype=torch.int32, device=default_device())
    )


@dataclasses.dataclass(frozen=True)
class ICPConvergenceCriteria:
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6
    max_iteration: int = 30


# ---------------------------------------------------------------------------
# Transformation estimation
# ---------------------------------------------------------------------------


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the triple product."""
    return torch.sum(M[..., :, 0] * torch.linalg.cross(M[..., :, 1], M[..., :, 2], dim=-1), dim=-1)


def _weighted_umeyama(p, q, w, with_scaling: bool = False):
    """Best-fit R (and s) minimising sum w |s R p + t - q|^2, batched over
    leading dimensions: p, q (..., N, 3), w (..., N) -> (..., 4, 4).

    The SVD of W = sum w (q - qm)(p - pm)^T comes from the closed-form
    eigendecomposition of W^T W; the smallest singular direction of U is
    rebuilt as the right-handed completion of the other two, so a planar
    (rank-2) W still gives a rotation."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
    pm = (p * w[..., None]).sum(-2) / wsum
    qm = (q * w[..., None]).sum(-2) / wsum
    pc = (p - pm[..., None, :]) * w[..., None]
    qc = q - qm[..., None, :]
    W = qc.transpose(-1, -2) @ pc  # R acts as q ~ R p; W = U S V^T
    s2, V = linalg.eigh3x3(W.transpose(-1, -2) @ W)  # ascending
    s = torch.sqrt(torch.clamp(s2, min=1e-20))
    U = (W @ V) / torch.clamp(s[..., None, :], min=1e-10)

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

    u2 = unit(U[..., :, 2])
    u1 = unit(U[..., :, 1] - torch.sum(U[..., :, 1] * u2, dim=-1, keepdim=True) * u2)
    u0 = torch.linalg.cross(u1, u2, dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)  # det(U) = +1
    d = torch.sign(_det3(U) * _det3(V))
    d = torch.where(d == 0, 1.0, d)
    D = torch.stack([d, torch.ones_like(d), torch.ones_like(d)], dim=-1)  # flip the smallest
    R = (U * D[..., None, :]) @ V.transpose(-1, -2)
    if with_scaling:
        var = torch.sum(w[..., None] * (p - pm[..., None, :]) ** 2, dim=(-2, -1))
        scale = torch.sum(s * D, dim=-1) / torch.clamp(var, min=1e-12)
        R = R * scale[..., None, None]
    t = qm - (R @ pm[..., None])[..., 0]
    return lie.rt_to_transform(R, t)


@dataclasses.dataclass(frozen=True)
class TransformationEstimationPointToPoint:
    with_scaling: bool = False

    def corr_extras(self, tgt):
        """Extra target columns for the banded 1-NN (none)."""
        return None

    def compute(self, src_pos, src_attrs, tgt, corr_idx, valid, T=None,
                corr_rows=None):
        if corr_rows is not None:
            q = corr_rows[:, :3]
        else:
            q = tgt.positions[torch.clamp(corr_idx, min=0).to(torch.int64)]
        return _weighted_umeyama(src_pos, q, valid.to(torch.float32), self.with_scaling)


def _solve_from_jacobian(J, r, w):
    """Gauss-Newton step from per-correspondence rows: JtJ and Jtr as two
    products, then exp of the solved twist."""
    Jw = J * w[:, None]
    xi = linalg.solve_gn_6x6(Jw.T @ J, Jw.T @ r)
    return lie.se3_exp(xi)


def _rows(tgt, corr_idx, *names):
    idx = torch.clamp(corr_idx, min=0).to(torch.int64)
    return [tgt.positions[idx]] + [tgt.attrs[n][idx] for n in names]


@dataclasses.dataclass(frozen=True)
class TransformationEstimationPointToPlane:
    kernel: RobustKernel = RobustKernel()

    def corr_extras(self, tgt):
        return tgt.attrs["normals"]

    def compute(self, src_pos, src_attrs, tgt, corr_idx, valid, T=None,
                corr_rows=None):
        if corr_rows is not None:
            q, n = corr_rows[:, :3], corr_rows[:, 3:6]
        else:
            q, n = _rows(tgt, corr_idx, "normals")
        r = torch.sum((src_pos - q) * n, dim=-1)
        J = torch.cat([torch.linalg.cross(src_pos, n, dim=-1), n], dim=-1)  # (N, 6)
        w = valid.to(torch.float32) * self.kernel.weight(r)
        return _solve_from_jacobian(J, r, w)


@dataclasses.dataclass(frozen=True)
class TransformationEstimationForColoredICP:
    """Joint geometric and photometric residual (Park, Zhou, Koltun, ICCV
    2017). The target carries normals, colors (their mean is the intensity)
    and color_gradients."""

    lambda_geometric: float = 0.968
    kernel: RobustKernel = RobustKernel()

    def corr_extras(self, tgt):
        return torch.cat([tgt.attrs["normals"], _intensity(tgt.attrs["colors"])[:, None],
                          tgt.attrs["color_gradients"]], dim=1)

    def compute(self, src_pos, src_attrs, tgt, corr_idx, valid, T=None,
                corr_rows=None):
        if corr_rows is not None:
            q, n = corr_rows[:, :3], corr_rows[:, 3:6]
            c_q, g = corr_rows[:, 6], corr_rows[:, 7:10]
        else:
            idx = torch.clamp(corr_idx, min=0).to(torch.int64)
            q, n, g = _rows(tgt, corr_idx, "normals", "color_gradients")
            c_q = _intensity(tgt.attrs["colors"])[idx]
        c_p = _intensity(src_attrs["colors"])
        sqrt_lg = self.lambda_geometric ** 0.5
        sqrt_lp = (1.0 - self.lambda_geometric) ** 0.5

        d = src_pos - q
        r_g = torch.sum(d * n, dim=-1)
        J_g = torch.cat([torch.linalg.cross(src_pos, n, dim=-1), n], dim=-1)
        # photometric: the virtual intensity on the target's tangent plane
        gm = g - n * torch.sum(g * n, dim=-1, keepdim=True)  # (I - n n^T) g
        r_p = c_q + torch.sum(gm * d, dim=-1) - c_p
        J_p = torch.cat([torch.linalg.cross(src_pos, gm, dim=-1), gm], dim=-1)

        w = valid.to(torch.float32) * self.kernel.weight(torch.sqrt(r_g * r_g + r_p * r_p + 1e-12))
        J = torch.cat([sqrt_lg * J_g, sqrt_lp * J_p], dim=0)
        r = torch.cat([sqrt_lg * r_g, sqrt_lp * r_p], dim=0)
        return _solve_from_jacobian(J, r, torch.cat([w, w], dim=0))


@dataclasses.dataclass(frozen=True)
class TransformationEstimationForGeneralizedICP:
    """Plane-to-plane generalized ICP (Segal, Haehnel, Thrun, RSS 2009).

    Each covariance is regularised to R diag(eps, 1, 1) R^T in its own
    eigenbasis; the Gauss-Newton step minimises sum r^T (C_q + C_p)^-1 r,
    r = p - q, over the 6-dof increment. Both clouds carry a "covariances"
    (N, 3, 3) attribute (ops.pointcloud.estimate_covariances)."""

    epsilon: float = 1e-3
    kernel: RobustKernel = RobustKernel()

    def _regularize(self, cov):
        # V diag V^T does not depend on the eigenvectors' signs
        _, evecs = torch.linalg.eigh(cov)  # ascending
        d = torch.ones(cov.shape[:-1], dtype=cov.dtype, device=cov.device)
        d[..., 0] = self.epsilon
        return torch.einsum("...ij,...j,...kj->...ik", evecs, d, evecs)

    def corr_extras(self, tgt):
        return tgt.attrs["covariances"].reshape(-1, 9)

    def compute(self, src_pos, src_attrs, tgt, corr_idx, valid, T=None,
                corr_rows=None):
        if corr_rows is not None:
            q = corr_rows[:, :3]
            cov_q = corr_rows[:, 3:12].reshape(-1, 3, 3)
        else:
            q, cov_q = _rows(tgt, corr_idx, "covariances")
        c_p = self._regularize(src_attrs["covariances"])
        # the source positions are already moved by T, so their covariances
        # turn with it: M = C_q + R C_p R^T
        if T is not None:
            R = T[:3, :3]
            c_p = torch.einsum("ij,njk,lk->nil", R, c_p, R)
        c_q = self._regularize(cov_q)
        eye = torch.eye(3, dtype=src_pos.dtype, device=src_pos.device)
        m, _ = torch.linalg.inv_ex(c_q + c_p + 1e-6 * eye)  # (N, 3, 3)
        r = src_pos - q
        # J (N, 3, 6) = d r / d xi for xi = (omega, t): [-[p]x | I]
        J = torch.cat([-lie.hat(src_pos), eye.expand(src_pos.shape[0], 3, 3)], dim=-1)
        w = (valid.to(torch.float32) * self.kernel.weight(torch.linalg.norm(r, dim=-1)))[:, None, None]
        mw = m * w
        JtMJ = torch.einsum("nai,nab,nbj->ij", J, mw, J)
        JtMr = torch.einsum("nai,nab,nb->i", J, mw, r)
        return lie.se3_exp(linalg.solve_gn_6x6(JtMJ, JtMr))


@dataclasses.dataclass(frozen=True)
class TransformationEstimationForDopplerICP:
    """Doppler-aided point-to-plane ICP (Hexsel, Vhavle, Vassilieva, RSS
    2022). The source carries "dopplers" (N,) m/s and "directions" (N, 3)
    unit sensor-to-point rays; `period` is the scan period (s). With
    (omega, v) = se3_log(T) of the current pose, the Doppler residual is
    r_d = doppler - d . (omega x p + v) / period (Open3D's sign convention,
    with per-point positions in place of its vehicle-to-sensor lever arm)."""

    period: float = 0.1
    lambda_doppler: float = 0.01
    kernel: RobustKernel = RobustKernel()

    def corr_extras(self, tgt):
        return tgt.attrs["normals"]

    def compute(self, src_pos, src_attrs, tgt, corr_idx, valid, T=None,
                corr_rows=None):
        if corr_rows is not None:
            q, n = corr_rows[:, :3], corr_rows[:, 3:6]
        else:
            q, n = _rows(tgt, corr_idx, "normals")
        r_g = torch.sum((src_pos - q) * n, dim=-1)
        J_g = torch.cat([torch.linalg.cross(src_pos, n, dim=-1), n], dim=-1)

        d = src_attrs["directions"]
        dop = src_attrs["dopplers"]
        # d(r_d)/d(xi) = -[p x d, d] / period
        J_d = -torch.cat([torch.linalg.cross(src_pos, d, dim=-1), d], dim=-1) / self.period
        if T is not None:
            xi = lie.se3_log(T)
            v_pt = torch.linalg.cross(xi[:3].expand(src_pos.shape), src_pos, dim=-1) + xi[3:]
            r_d = dop - torch.sum(d * v_pt, dim=-1) / self.period
        else:
            r_d = dop
        sqrt_lg = (1.0 - self.lambda_doppler) ** 0.5
        sqrt_ld = self.lambda_doppler ** 0.5
        valid_f = valid.to(torch.float32)
        J = torch.cat([sqrt_lg * J_g, sqrt_ld * J_d], dim=0)
        r = torch.cat([sqrt_lg * r_g, sqrt_ld * r_d], dim=0)
        return _solve_from_jacobian(J, r, torch.cat([valid_f * self.kernel.weight(r_g), valid_f]))


def _intensity(colors: torch.Tensor) -> torch.Tensor:
    if colors.ndim == 2 and colors.shape[-1] == 3:
        return colors.mean(-1)
    return colors.reshape(colors.shape[0])


# ---------------------------------------------------------------------------
# Correspondences / evaluation
# ---------------------------------------------------------------------------


def _grid_nns_threshold() -> int:
    """Target size from which "auto" takes the hash grid over brute force
    (the JAX package's value off the TPU; "auto" takes the banded 1-NN for
    every estimation here first, so only "grid" reaches the grid)."""
    return 32768


def _make_corr_grid(tgt: PointCloud, dmax: float, nns_backend: str = "auto"):
    """Spatial-hash index over the target for radius-dmax correspondence
    search, or None where brute force serves: "exact" always brute force,
    "grid" always the grid (whose max_per_cell cap can drop true
    neighbours), "auto" the grid from _grid_nns_threshold() points."""
    if nns_backend == "exact":
        return None
    if nns_backend == "auto" and tgt.positions.shape[0] < _grid_nns_threshold():
        return None
    return nns_grid.build_grid(tgt.positions, float(dmax), mask=tgt.mask)


def _correspondences(src_pos, src_mask, tgt: PointCloud, dmax: float, grid=None,
                     max_per_cell: int = 32):
    if grid is not None:
        idx, d2, _ = nns_grid.query_grid(grid, src_pos, dmax, 1, max_per_cell=max_per_cell)
        idx, d2 = idx[:, 0], d2[:, 0]
        valid = src_mask & (idx >= 0)
        return torch.where(valid, idx, -1), d2, valid
    idx, d2 = nns.one_nn_search(src_pos, tgt.positions, target_mask=tgt.mask)
    valid = src_mask & (idx >= 0) & (d2 <= dmax * dmax)
    return torch.where(valid, idx, -1), d2, valid


def _fitness_rmse(src_mask, d2, valid):
    n_src = torch.clamp(src_mask.to(torch.float32).sum(), min=1.0)
    n_in = valid.to(torch.float32).sum()
    rmse = torch.sqrt(torch.where(valid, d2, 0.0).sum() / torch.clamp(n_in, min=1.0))
    return n_in / n_src, rmse


def _eye4(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=like.device)


def evaluate_registration(
    source: PointCloud,
    target: PointCloud,
    max_correspondence_distance: float,
    transformation: Optional[torch.Tensor] = None,
) -> RegistrationResult:
    T = _eye4(source.positions) if transformation is None else transformation
    pos = lie.transform_points(T, source.positions)
    _, d2, valid = _correspondences(pos, source.mask, target, max_correspondence_distance)
    fitness, rmse = _fitness_rmse(source.mask, d2, valid)
    return RegistrationResult(transformation=T, fitness=fitness, inlier_rmse=rmse,
                              num_iterations=torch.zeros((), dtype=torch.int32, device=T.device))


def get_information_matrix(
    source: PointCloud,
    target: PointCloud,
    max_correspondence_distance: float,
    transformation: torch.Tensor,
) -> torch.Tensor:
    """6x6 information matrix sum_i G_i^T G_i over the correspondences,
    G_i = [-skew(q_i) | I] at the corresponding target points q."""
    pos = lie.transform_points(transformation, source.positions)
    idx, _, valid = _correspondences(pos, source.mask, target, max_correspondence_distance)
    q = target.positions[torch.clamp(idx, min=0).to(torch.int64)]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    G = torch.cat([-lie.hat(q), eye], dim=-1)  # (N, 3, 6)
    Gw = G * valid.to(torch.float32)[:, None, None]
    return torch.einsum("nij,nik->jk", Gw, G)


# ---------------------------------------------------------------------------
# ICP entry points
# ---------------------------------------------------------------------------


def icp(
    source: PointCloud,
    target: PointCloud,
    max_correspondence_distance: float,
    init: Optional[torch.Tensor] = None,
    estimation=None,
    criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
    nns_backend: str = "auto",
    nns_max_per_cell: int = 32,
    nns_band_window: int = 2048,
) -> RegistrationResult:
    """Single-scale ICP: `criteria.max_iteration` iterations, later ones
    frozen once converged; the loop reads nothing back itself.

    nns_backend: "auto" takes the sorted-band 1-NN on targets of 8192
    points or more (exact while no candidate window exceeds
    `nns_band_window`), "banded" forces it, "exact" forces the brute-force
    1-NN, "grid" the hash grid (whose nns_max_per_cell cap can drop true
    neighbours)."""
    estimation = estimation or TransformationEstimationPointToPlane()
    T0 = _eye4(source.positions) if init is None else init.to(torch.float32)

    src_pos0 = source.positions
    src_mask = source.mask
    src_attrs = source.attrs

    dmax = max_correspondence_distance
    banded = None
    if nns_backend in ("auto", "banded") and hasattr(estimation, "corr_extras"):
        if nns_backend == "banded" or target.positions.shape[0] >= 8192:
            banded = nns.banded_build(target.positions, target.mask, estimation.corr_extras(target),
                                      window=nns_band_window)
            # the queries must be coherent along the band axis: the source
            # is sorted once (every reduction downstream ignores the order)
            qkey = torch.where(src_mask, nns.banded_query_key(banded, src_pos0), 3e38)
            qperm = torch.argsort(qkey, stable=True)
            src_pos0 = src_pos0[qperm]
            src_mask = src_mask[qperm]
            src_attrs = {k: v[qperm] for k, v in src_attrs.items()}
    grid = None if banded is not None else _make_corr_grid(target, dmax, nns_backend)

    def correspond(pos):
        if banded is not None:
            idx, d2, sel, _ = nns.banded_one_nn(banded, pos, dmax, qmask=src_mask)
            return idx, d2, src_mask & (idx >= 0), sel
        idx, d2, valid = _correspondences(pos, src_mask, target, dmax, grid,
                                          max_per_cell=nns_max_per_cell)
        return idx, d2, valid, None

    zero = torch.zeros((), dtype=torch.float32, device=T0.device)
    T, fitness, rmse = T0, zero, zero
    it = torch.zeros((), dtype=torch.int32, device=T0.device)
    converged = torch.zeros((), dtype=torch.bool, device=T0.device)
    for i in range(criteria.max_iteration):
        pos = torch.where(src_mask[:, None], lie.transform_points(T, src_pos0), src_pos0)
        idx, d2, valid, sel = correspond(pos)
        new_f, new_r = _fitness_rmse(src_mask, d2, valid)
        T_new = estimation.compute(pos, src_attrs, target, idx, valid, T, corr_rows=sel) @ T
        conv = ((torch.abs(fitness - new_f) < criteria.relative_fitness)
                & (torch.abs(rmse - new_r) < criteria.relative_rmse)) if i > 0 else converged
        # a converged loop has stopped: its state no longer changes
        T = torch.where(converged, T, T_new)
        fitness = torch.where(converged, fitness, new_f)
        rmse = torch.where(converged, rmse, new_r)
        it = torch.where(converged, it, it + 1)
        converged = converged | conv
    # the final metrics at the final pose
    _, d2, valid, _ = correspond(lie.transform_points(T, src_pos0))
    fitness, rmse = _fitness_rmse(src_mask, d2, valid)
    return RegistrationResult(transformation=T, fitness=fitness, inlier_rmse=rmse, num_iterations=it)


def multi_scale_icp(
    source: PointCloud,
    target: PointCloud,
    voxel_sizes: Sequence[float],
    criteria_list: Sequence[ICPConvergenceCriteria],
    max_correspondence_distances: Sequence[float],
    init: Optional[torch.Tensor] = None,
    estimation=None,
    nns_backend: str = "auto",
    nns_max_per_cell: int = 32,
    nns_band_window: int = 2048,
) -> RegistrationResult:
    """Coarse-to-fine ICP: at each scale both clouds are voxel-down-sampled
    (voxel_size <= 0: the full cloud) and `icp` runs from the previous
    scale's pose."""
    if not len(voxel_sizes) == len(criteria_list) == len(max_correspondence_distances):
        raise ValueError("voxel_sizes, criteria_list and max_correspondence_distances differ in length")
    estimation = estimation or TransformationEstimationPointToPlane()
    T = _eye4(source.positions) if init is None else init.to(torch.float32)
    result = None
    for vs, crit, dmax in zip(voxel_sizes, criteria_list, max_correspondence_distances):
        if vs > 0:
            src = pc_ops.voxel_down_sample(source, vs)
            tgt = pc_ops.voxel_down_sample(target, vs)
            if "normals" in target.attrs and "normals" not in tgt.attrs:
                tgt = pc_ops.estimate_normals(tgt, max_nn=30)
        else:
            src, tgt = source, target
        if isinstance(estimation, TransformationEstimationForColoredICP) and (
            "color_gradients" not in tgt.attrs
        ):
            tgt = pc_ops.estimate_color_gradients(tgt, max_nn=30, radius=3.0 * max(vs, 1e-3))
        result = icp(src, tgt, dmax, T, estimation, crit, nns_backend=nns_backend,
                     nns_max_per_cell=nns_max_per_cell, nns_band_window=nns_band_window)
        T = result.transformation
    return result
