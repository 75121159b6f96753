"""Dense RGB-D odometry (port of open3d_tpu/pipelines/odometry.py): the
point-to-plane, intensity and hybrid (depth + intensity) methods, and the
odometry information matrix.

Each pyramid level runs a Gauss-Newton loop over all pixels: per-pixel
Jacobian rows, one (6, HW) @ (HW, 6) product, a 6x6 solve on the device.
The JAX package keeps the convergence test on the device inside
lax.while_loop; here the loop is a Python loop that reads the RMSE once per
iteration (one host sync, the site `odometry.rmse` of utils/timer.py's
`host_read`), with the same convergence rule, so the iterates are the same.
Each pass of the loop counts one in `odometry.gn_iterations`; the pyramid
builds, each level and the final metrics are the spans `odometry.pyramid`,
`odometry.level` (attribute `level`) and `odometry.final`.

Point-to-plane runs its iteration through `ops/kernels/point_to_plane.py`:
on CUDA tensors two kernel launches an iteration and one for the final
metrics, on CPU tensors the same steps in plain PyTorch. Intensity and
hybrid run the eager loop `_gn_level`.

JtJ is a float32 matmul: it assumes torch.backends.cuda.matmul.allow_tf32
is False (PyTorch's default), as TF32 keeps only about three digits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from open3d_tpu_torch.core import lie, linalg
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.ops.kernels import point_to_plane as p2p
from open3d_tpu_torch.ops.kernels.point_to_plane import huber_weight as _huber_weight
from open3d_tpu_torch.ops.kernels.point_to_plane import nearest_sample as _nearest_sample
from open3d_tpu_torch.ops.kernels.point_to_plane import project as _project
from open3d_tpu_torch.utils.timer import count, host_read, span

POINT_TO_PLANE = "point_to_plane"
INTENSITY = "intensity"
HYBRID = "hybrid"


@dataclasses.dataclass(frozen=True)
class OdometryConvergenceCriteria:
    max_iteration: int = 10
    relative_rmse: float = 1e-6
    relative_fitness: float = 1e-6


@dataclasses.dataclass(frozen=True)
class OdometryLossParams:
    depth_outlier_trunc: float = 0.07
    depth_huber_delta: float = 0.05
    intensity_huber_delta: float = 0.1


@dataclasses.dataclass(frozen=True)
class OdometryResult:
    """transformation maps source-frame points into the target frame."""

    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # () f32
    inlier_rmse: torch.Tensor  # () f32


class _LevelData:
    """Per-pyramid-level maps, flattened to (HW, ...) rows. Target maps that
    one warp samples together are packed on the channel axis, so each
    association is one row gather: vertex + normal for point-to-plane,
    depth + intensity for the bilinear warp, vertex + gradient validity for
    the nearest-pixel lookup."""

    def __init__(self, src_vtx, src_inten, tgt_vtx, tgt_nrm, tgt_inten, intr):
        self.intr = intr
        self.src_pts = src_vtx.reshape(-1, 3)
        self.src_valid = self.src_pts[:, 2] > 0
        self.src_inten = None if src_inten is None else src_inten.reshape(-1)
        self.tgt_depth = tgt_vtx[..., 2]
        self.tgt_inten = tgt_inten
        # gradient stencils that touch invalid (depth 0) pixels are garbage:
        # the eroded validity map rejects them at association time
        self.tgt_grad_valid = im.erode_mask(self.tgt_depth > 0.0, 1)
        self.tgt_vtx_nrm = torch.cat([tgt_vtx, tgt_nrm], dim=-1)
        self.tgt_vtx_gv = torch.cat(
            [tgt_vtx, self.tgt_grad_valid[..., None].to(torch.float32)], dim=-1
        )
        if tgt_inten is not None:
            self.tgt_depth_inten = torch.stack([self.tgt_depth, tgt_inten], dim=-1)


def _intensity_rows(ld: _LevelData, P, u, v, base_valid, loss):
    uv = torch.stack([u, v], dim=-1)
    it, gx, gy = im.bilinear_sample_with_grad(ld.tgt_inten, uv)
    z = torch.clamp(P[:, 2], min=1e-6)
    # dI/dP = gx * du/dP + gy * dv/dP
    fgx = gx * ld.intr.fx / z
    fgy = gy * ld.intr.fy / z
    G = torch.stack([fgx, fgy, -(fgx * P[:, 0] + fgy * P[:, 1]) / z], dim=-1)
    r = it - ld.src_inten
    w = base_valid.to(torch.float32) * _huber_weight(r, loss.intensity_huber_delta)
    J = torch.cat([torch.linalg.cross(P, G, dim=-1), G], dim=-1)
    return J, r, w


def _rows_intensity(ld: _LevelData, T, loss: OdometryLossParams):
    P = lie.transform_points(T, ld.src_pts)
    u, v, inb = _project(P, ld.intr)
    vg = _nearest_sample(ld.tgt_vtx_gv, u, v)  # vertex (3) + gradient validity
    dt, gv = vg[:, 2], vg[:, 3] > 0.5
    valid = ld.src_valid & inb & (dt > 0) & (torch.abs(dt - P[:, 2]) < loss.depth_outlier_trunc)
    valid = valid & gv
    J, r, w = _intensity_rows(ld, P, u, v, valid, loss)
    return J, r, w, valid


def _rows_hybrid(ld: _LevelData, T, loss: OdometryLossParams):
    """Depth and intensity residuals, weighted 0.5 each, from one packed
    four-corner bilinear gather of depth + intensity."""
    P = lie.transform_points(T, ld.src_pts)
    u, v, inb = _project(P, ld.intr)
    uv = torch.stack([u, v], dim=-1)
    di, gx2, gy2 = im.bilinear_sample_with_grad(ld.tgt_depth_inten, uv)
    dt, it = di[:, 0], di[:, 1]
    dgx, igx = gx2[:, 0], gx2[:, 1]
    dgy, igy = gy2[:, 0], gy2[:, 1]
    vg = _nearest_sample(ld.tgt_vtx_gv, u, v)
    gv = vg[:, 3] > 0.5
    valid = ld.src_valid & inb & (dt > 0) & (torch.abs(dt - P[:, 2]) < loss.depth_outlier_trunc)
    valid = valid & gv

    z = torch.clamp(P[:, 2], min=1e-6)
    # intensity term (shares the packed bilinear sample)
    fgx = igx * ld.intr.fx / z
    fgy = igy * ld.intr.fy / z
    Gi = torch.stack([fgx, fgy, -(fgx * P[:, 0] + fgy * P[:, 1]) / z], dim=-1)
    ri = it - ld.src_inten
    wi = valid.to(torch.float32) * _huber_weight(ri, loss.intensity_huber_delta)
    Ji = torch.cat([torch.linalg.cross(P, Gi, dim=-1), Gi], dim=-1)

    # depth term: r_d = D_t(u(P), v(P)) - P_z
    fgx = dgx * ld.intr.fx / z
    fgy = dgy * ld.intr.fy / z
    Gd = torch.stack([fgx, fgy, -(fgx * P[:, 0] + fgy * P[:, 1]) / z - 1.0], dim=-1)
    rd = dt - P[:, 2]
    wd = valid.to(torch.float32) * _huber_weight(rd, loss.depth_huber_delta)
    Jd = torch.cat([torch.linalg.cross(P, Gd, dim=-1), Gd], dim=-1)

    sqrt_l = math.sqrt(0.5)
    J = torch.cat([sqrt_l * Ji, sqrt_l * Jd], dim=0)
    r = torch.cat([sqrt_l * ri, sqrt_l * rd], dim=0)
    w = torch.cat([wi, wd], dim=0)
    return J, r, w, valid


_ROWS = {INTENSITY: _rows_intensity, HYBRID: _rows_hybrid}
_METHODS = (POINT_TO_PLANE, INTENSITY, HYBRID)


def _p2p_level(ld: _LevelData, loss: OdometryLossParams) -> p2p.Level:
    return p2p.Level(ld.src_pts, ld.src_valid, ld.tgt_vtx_nrm, ld.intr,
                     loss.depth_outlier_trunc, loss.depth_huber_delta)


def _gn_level(ld: _LevelData, T, rows, criteria: OdometryConvergenceCriteria, loss):
    prev_rmse = None
    for it in range(criteria.max_iteration):
        count("odometry.gn_iterations")
        J, r, w, valid = rows(ld, T, loss)
        Jw = J * w[:, None]
        JtJ = Jw.T @ J
        Jtr = Jw.T @ r
        xi = linalg.solve_gn_6x6(JtJ, Jtr)
        T = lie.se3_exp(xi) @ T
        n_in = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
        rmse = torch.sqrt(torch.sum(torch.where(w > 0, r * r, 0.0)) / n_in)
        # the host reads the RMSE: the loop's one sync per iteration
        rmse_h = host_read("odometry.rmse", rmse)
        if it > 0 and abs(prev_rmse - rmse_h) < criteria.relative_rmse:
            break
        prev_rmse = rmse_h
    return T


def _gn_level_point_to_plane(ld: _LevelData, T, criteria: OdometryConvergenceCriteria, loss):
    """`_gn_level` for point-to-plane: each pass is one `p2p.iterate`, which
    updates T in place (the two kernels on a card, plain PyTorch on the
    CPU); the same read of the RMSE and the same convergence rule."""
    lv = _p2p_level(ld, loss)
    prev_rmse = None
    for it in range(criteria.max_iteration):
        count("odometry.gn_iterations")
        rmse_h = host_read("odometry.rmse", p2p.iterate(lv, T))
        if it > 0 and abs(prev_rmse - rmse_h) < criteria.relative_rmse:
            break
        prev_rmse = rmse_h
    return T


def rgbd_odometry_multi_scale(
    source: RGBDImage,
    target: RGBDImage,
    intrinsic: PinholeCameraIntrinsic,
    init: Optional[torch.Tensor] = None,
    method: str = HYBRID,
    criteria: Sequence[OdometryConvergenceCriteria] = (
        OdometryConvergenceCriteria(10),
        OdometryConvergenceCriteria(5),
        OdometryConvergenceCriteria(3),
    ),
    loss: OdometryLossParams = OdometryLossParams(),
    bilateral_filter: bool = True,
    target_normals: Optional[torch.Tensor] = None,
) -> OdometryResult:
    """Coarse-to-fine dense odometry. Depths are metric float32 with 0 as
    invalid; INTENSITY and HYBRID also read the colour (or intensity) images.
    Returns T with target_point ~= T @ source_point."""
    if method not in _METHODS:
        raise ValueError(f"unknown odometry method {method!r}; expected one of {sorted(_METHODS)}")
    n_levels = len(criteria)
    dev = source.depth.device
    use_intensity = method in (INTENSITY, HYBRID)
    with span("odometry.pyramid"):
        src_depth_pyr = im.build_depth_pyramid(source.depth, n_levels)
        tgt_depth_pyr = im.build_depth_pyramid(target.depth, n_levels)
        tgt_nrm_pyr = (
            im.build_normal_pyramid(target_normals, n_levels)
            if target_normals is not None else None
        )
        src_int_pyr = im.build_intensity_pyramid(source.color, n_levels) if use_intensity else None
        tgt_int_pyr = im.build_intensity_pyramid(target.color, n_levels) if use_intensity else None
    # the function's own T: point-to-plane updates it in place
    T = (
        torch.eye(4, dtype=torch.float32, device=dev)
        if init is None
        else init.to(dtype=torch.float32, device=dev, copy=True)
    )

    for lvl in reversed(range(n_levels)):
        with span("odometry.level", level=lvl):
            intr_l = intrinsic.scaled(0.5**lvl)
            sd, td = src_depth_pyr[lvl], tgt_depth_pyr[lvl]
            if bilateral_filter:
                td = im.filter_bilateral_depth(td)
                sd = im.filter_bilateral_depth(sd)
            src_vtx = im.create_vertex_map(sd, intr_l)
            tgt_vtx = im.create_vertex_map(td, intr_l)
            tgt_nrm = (tgt_nrm_pyr[lvl] if tgt_nrm_pyr is not None
                       else im.create_normal_map(tgt_vtx))
            ld = _LevelData(
                src_vtx, src_int_pyr[lvl] if use_intensity else None, tgt_vtx, tgt_nrm,
                tgt_int_pyr[lvl] if use_intensity else None, intr_l,
            )
            crit = criteria[n_levels - 1 - lvl]
            if method == POINT_TO_PLANE:
                T = _gn_level_point_to_plane(ld, T, crit, loss)
            else:
                T = _gn_level(ld, T, _ROWS[method], crit, loss)

    # final metrics at the finest level
    with span("odometry.final"):
        tgt_vtx0 = im.create_vertex_map(tgt_depth_pyr[0], intrinsic)
        ld = _LevelData(
            im.create_vertex_map(src_depth_pyr[0], intrinsic),
            src_int_pyr[0] if use_intensity else None,
            tgt_vtx0,
            tgt_nrm_pyr[0] if tgt_nrm_pyr is not None else im.create_normal_map(tgt_vtx0),
            tgt_int_pyr[0] if use_intensity else None,
            intrinsic,
        )
        if method == POINT_TO_PLANE:
            sum_r2, n_in = p2p.residual_sums(_p2p_level(ld, loss), T)
        else:
            _, r, w, valid = _ROWS[method](ld, T, loss)
            sum_r2 = torch.sum(torch.where(w > 0, r * r, 0.0))
            n_in = torch.sum(valid.to(torch.float32))
        n_src = torch.clamp(torch.sum(ld.src_valid.to(torch.float32)), min=1.0)
        rmse = torch.sqrt(sum_r2 / torch.clamp(n_in, min=1.0))
    return OdometryResult(transformation=T, fitness=n_in / n_src, inlier_rmse=rmse)


def compute_odometry_information_matrix(
    source_depth: torch.Tensor,
    target_depth: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    transformation: torch.Tensor,
    dist_threshold: float = 0.07,
) -> torch.Tensor:
    """6x6 information matrix over projectively associated vertex pairs: the
    sum of G^T G with G = [-skew(q) | I] on the target-frame points q."""
    src_vtx = im.create_vertex_map(source_depth, intrinsic).reshape(-1, 3)
    tgt_vtx = im.create_vertex_map(target_depth, intrinsic)
    T = transformation.to(dtype=torch.float32, device=src_vtx.device)
    P = lie.transform_points(T, src_vtx)
    u, v, inb = _project(P, intrinsic)
    q = _nearest_sample(tgt_vtx, u, v)
    valid = (src_vtx[:, 2] > 0) & inb & (q[:, 2] > 0)
    valid = valid & (torch.sum((P - q) ** 2, dim=-1) < dist_threshold * dist_threshold)
    w = valid.to(torch.float32)[:, None, None]
    skew = lie.hat(q)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(skew.shape)
    G = torch.cat([-skew, eye], dim=-1)  # (N, 3, 6)
    return torch.einsum("nij,nik->jk", G * w, G)
