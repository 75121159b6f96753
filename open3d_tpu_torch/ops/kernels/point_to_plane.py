"""The point-to-plane Gauss-Newton iteration of the dense odometry
(`pipelines/odometry.py`) as two kernels: the rows and their sums, then the
solve and the update of the pose.

`iterate` and `residual_sums` launch the CUDA kernels in
`csrc/point_to_plane.cu` for a `Level` of CUDA tensors, on the current
stream, and run `iterate_plain` and `residual_sums_plain`, the same steps
in plain PyTorch, for CPU tensors. Nothing falls back: a CUDA tensor either
launches the kernels or raises. The plain pieces the odometry's other
methods share (`project`, `nearest_sample`, `huber_weight`) live here too.

Replaces: open3d_tpu_torch/pipelines/odometry.py's point-to-plane
iteration (`_rows_point_to_plane`, `Jw.T @ J`, `Jw.T @ r`,
core/linalg.py:solve_gn_6x6, core/lie.py:se3_exp, the RMSE), the twin of
open3d_tpu/pipelines/odometry.py's (which XLA fuses in its while_loop; no
Pallas kernel). On the card that iteration was ~300 eager operations,
each a launch (185 of them the unrolled Cholesky): here it is two.
Bound: the sums read each source point (12 B), its validity (1 B) and the
gathered target row of vertex and normal (24 B): ~11 MB at 640x480, ~3.3
us at 3.35 TB/s, ~4.4 us over the three levels. The solve is one CTA that
sums ~300 rows of partial sums and runs a serial 6x6 solve: a few us of
latency.
Function: with P = T p for the valid source points p, (u, v) = their
projection, (q, n) = the target vertex and normal at the nearest pixel,
r = (P - q) . n and J = [P x n, n], a pixel is valid where p, q and the
projection are, |n|^2 > 0.5 and |r| < trunc, with weight w = delta /
max(|r|, delta). Then xi = solve_gn_6x6(sum w J^T J, sum w J^T r), T <-
se3_exp(xi) T, and RMSE = sqrt(sum r^2 / max(n_valid, 1)) at the pose T had
on entry.
Rounding: a pixel's operations follow `rows_plain` in its order, with one
rounding for the projection's multiply-add (`fma`) and none fused
elsewhere, except three orders that differ: P = ((R0 p0 + R1 p1) + R2 p2)
+ t in the kernel, where `pts @ R.T + t` leaves the order to cuBLAS; the
sums, a float32 sum a thread over its pixels and then fixed-order trees
(warp, CTA, then the CTAs in double), where cuBLAS's sgemm and PyTorch's
reductions pick their own; and the solve, the exponential and the product
exp(xi) T, in double and rounded to float32 once, where the plain ones run
in float32. So the pose agrees with `iterate_plain`'s at float32 rounding,
not bit for bit; the valid count is exact wherever P rounds alike.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.core import lie, linalg
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels._plain import fma

DAMPING = 1e-6  # solve_gn_6x6's relative Tikhonov damping
ROW = 32  # float32 words of a CTA's row of partial sums (28 sums and the count)
SUM_R2 = 27  # the word of the sum of r^2 (after J^T W J's 21 and J^T W r's 6)
COUNT = 28  # the word of the count (an int32)


def huber_weight(r, delta):
    return delta / torch.clamp(torch.abs(r), min=delta)


def project(P, intr):
    """Pixel coordinates of camera-frame points. The multiply-add rounds
    once (`fma`), as XLA fuses it in the JAX package's jitted loop: at T = I
    every sample lands on a pixel border, where the bilinear gradient jumps,
    so the last bit of u and v picks the cell that the Jacobian comes from."""
    z = P[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = fma(P[..., 0] / zs, intr.fx, intr.cx)
    v = fma(P[..., 1] / zs, intr.fy, intr.cy)
    inb = (z > 1e-4) & (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1)
    return u, v, inb


def nearest_sample(img, u, v):
    """Nearest-pixel sample of an (H, W) or (H, W, C) image."""
    H, W = img.shape[0], img.shape[1]
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    lin = vi * W + ui
    if img.ndim == 3:
        return img.reshape(H * W, -1)[lin]
    return img.reshape(H * W)[lin]


def rows_plain(src_pts, src_valid, tgt_vtx_nrm, T, intr, trunc: float, delta: float):
    """The point-to-plane rows: (J (N, 6), r (N,), w (N,), valid (N,))."""
    P = lie.transform_points(T, src_pts)
    u, v, inb = project(P, intr)
    qn = nearest_sample(tgt_vtx_nrm, u, v)
    q, n = qn[:, :3], qn[:, 3:]
    valid = src_valid & inb & (q[:, 2] > 0) & (torch.sum(n * n, dim=-1) > 0.5)
    r = torch.sum((P - q) * n, dim=-1)
    valid = valid & (torch.abs(r) < trunc)
    w = valid.to(torch.float32) * huber_weight(r, delta)
    J = torch.cat([torch.linalg.cross(P, n, dim=-1), n], dim=-1)
    return J, r, w, valid


class Level:
    """One pyramid level's inputs to the iteration, checked once: the source
    points (N, 3) float32 and their validity (N,) bool, the packed target
    vertex + normal map (H, W, 6) float32, all contiguous on one device (CPU
    or a CUDA card), the level's intrinsic, the outlier cut `trunc` and the
    Huber `delta`. On a card it also holds the kernels' buffers: a row of
    partial sums a CTA and the RMSE."""

    def __init__(self, src_pts, src_valid, tgt_vtx_nrm, intr, trunc: float, delta: float):
        dev = src_pts.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"point_to_plane.Level: unsupported device {dev}")
        _check("src_pts", src_pts, torch.float32, dev)
        if src_pts.ndim != 2 or src_pts.shape[1] != 3:
            raise ValueError(f"src_pts: expected (N, 3), got shape {tuple(src_pts.shape)}")
        _check("src_valid", src_valid, torch.bool, dev, (src_pts.shape[0],))
        _check("tgt_vtx_nrm", tgt_vtx_nrm, torch.float32, dev)
        if tgt_vtx_nrm.ndim != 3 or tgt_vtx_nrm.shape[2] != 6:
            raise ValueError(f"tgt_vtx_nrm: expected (H, W, 6), got shape "
                             f"{tuple(tgt_vtx_nrm.shape)}")
        self.device = dev
        self.src_pts, self.src_valid, self.tgt_vtx_nrm = src_pts, src_valid, tgt_vtx_nrm
        self.intr, self.trunc, self.delta = intr, trunc, delta
        if dev.type == "cuda":
            from open3d_tpu_torch.ops.kernels import _build

            lib = _build.load()
            self.n_blocks = lib.o3dt_p2p_blocks(src_pts.shape[0])
            self.partials = torch.empty((self.n_blocks, ROW), dtype=torch.float32, device=dev)
            self.rmse = torch.empty((), dtype=torch.float32, device=dev)
            H, W = tgt_vtx_nrm.shape[:2]
            self._sums_args = (
                src_pts.data_ptr(), src_valid.data_ptr(), tgt_vtx_nrm.data_ptr())
            self._sums_scalars = (
                self.partials.data_ptr(), src_pts.shape[0], H, W, intr.fx, intr.fy, intr.cx,
                intr.cy, float(intr.width - 1), float(intr.height - 1), trunc, delta)

    def check_pose(self, T: torch.Tensor) -> None:
        _check("T", T, torch.float32, self.device, (4, 4))


def _residual(r, w, valid):
    """(sum of r^2 over w > 0, the valid count as float32)."""
    return torch.sum(torch.where(w > 0, r * r, 0.0)), torch.sum(valid.to(torch.float32))


def iterate_plain(lv: Level, T: torch.Tensor) -> torch.Tensor:
    """One iteration in plain PyTorch on any device: T (4, 4) <- exp(xi) T in
    place, xi the damped Gauss-Newton step of the rows at T; returns the
    RMSE (0-d) at the pose T had on entry."""
    J, r, w, valid = rows_plain(lv.src_pts, lv.src_valid, lv.tgt_vtx_nrm, T, lv.intr, lv.trunc,
                                lv.delta)
    Jw = J * w[:, None]
    xi = linalg.solve_gn_6x6(Jw.T @ J, Jw.T @ r, DAMPING)
    T.copy_(lie.se3_exp(xi) @ T)
    sum_r2, n_valid = _residual(r, w, valid)
    return torch.sqrt(sum_r2 / torch.clamp(n_valid, min=1.0))


def residual_sums_plain(lv: Level, T):
    """(sum of r^2 over w > 0, valid count as float32) at pose T."""
    _, r, w, valid = rows_plain(lv.src_pts, lv.src_valid, lv.tgt_vtx_nrm, T, lv.intr, lv.trunc,
                                lv.delta)
    return _residual(r, w, valid)


def _launch_sums(lv: Level, T: torch.Tensor, lib, stream) -> None:
    """The sums kernel: lv.partials <- each CTA's sums of the rows at T."""
    from open3d_tpu_torch.ops.kernels import _build

    _build.check(lib.o3dt_p2p_sums(*lv._sums_args, T.data_ptr(), *lv._sums_scalars, stream))


def _launch_solve(lv: Level, T: torch.Tensor, lib, stream) -> None:
    """The solve kernel: T <- exp(xi) T and lv.rmse from lv.partials."""
    from open3d_tpu_torch.ops.kernels import _build

    _build.check(lib.o3dt_p2p_solve(lv.partials.data_ptr(), lv.n_blocks, T.data_ptr(),
                                    lv.rmse.data_ptr(), DAMPING, stream))


def iterate(lv: Level, T: torch.Tensor) -> torch.Tensor:
    """One Gauss-Newton iteration: T (4, 4) float32, on the level's device,
    <- exp(xi) T in place; returns the RMSE (0-d float32) of the rows at the
    pose T had on entry. On a card: the sums kernel, then the solve kernel
    (two launches, counted in `iterate.launches`); the RMSE is the level's
    buffer, which the next call overwrites. On the CPU: iterate_plain."""
    lv.check_pose(T)
    if lv.device.type == "cpu":
        return iterate_plain(lv, T)
    from open3d_tpu_torch.ops.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(lv.device).cuda_stream
    _launch_sums(lv, T, lib, stream)
    _launch_solve(lv, T, lib, stream)
    iterate.launches += 2
    return lv.rmse


def residual_sums(lv: Level, T: torch.Tensor):
    """(sum of r^2 over w > 0, the valid count as float32), both 0-d, at
    pose T: the odometry's final metrics. On a card: the sums kernel (one
    launch, counted in `residual_sums.launches`), its CTAs' two words summed
    by PyTorch; on the CPU: residual_sums_plain."""
    lv.check_pose(T)
    if lv.device.type == "cpu":
        return residual_sums_plain(lv, T)
    from open3d_tpu_torch.ops.kernels import _build

    _launch_sums(lv, T, _build.load(), torch.cuda.current_stream(lv.device).cuda_stream)
    residual_sums.launches += 1
    sum_r2 = torch.sum(lv.partials[:, SUM_R2], dtype=torch.float64).to(torch.float32)
    n_valid = torch.sum(lv.partials.view(torch.int32)[:, COUNT]).to(torch.float32)
    return sum_r2, n_valid


iterate.launches = 0
residual_sums.launches = 0
