"""The point-to-plane Gauss-Newton iteration of the dense odometry
(`pipelines/odometry.py`) as two kernels: the rows and their sums, then the
solve and the update of the pose; and a third that builds a pyramid
level's inputs to them.

`iterate` and `residual_sums` launch the CUDA kernels in
`csrc/point_to_plane.cu` for a `Level` of CUDA tensors, on the current
stream, and run `iterate_plain` and `residual_sums_plain`, the same steps
in plain PyTorch, for CPU tensors; `maps` launches the maps kernel for CUDA
depths and runs `maps_plain` for CPU ones. Nothing falls back: a CUDA
tensor either launches the kernels or raises. The plain pieces the
odometry's other methods share (`project`, `nearest_sample`,
`huber_weight`) live here too.

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

The maps. Replaces: the point-to-plane level of
open3d_tpu_torch/pipelines/odometry.py, `create_vertex_map` of the source
and the target, `create_normal_map` of the target (geometry/image.py) and
`_LevelData`'s packing, whose `erode_mask` and gradient-validity rows only
the intensity and hybrid rows read: ~165 eager operations a level on the
card, ~660 a track frame (three levels and the final metrics), against one
launch. Bound: a pixel reads its two depths (8 B; the target's right and
down neighbours come from L1 and L2) and writes 37 B (the source point,
its validity, the target's row of six floats): at 640x480 2.5 MB in and
11.4 MB out, ~4 us at 3.35 TB/s, irrelevant next to the ~660 launches it
replaces. With a given normal map it reads 12 B a pixel more.
Function: `maps_plain`: src_pts = create_vertex_map(src).reshape(-1, 3),
src_valid = its z > 0, tgt_vtx_nrm = cat(create_vertex_map(tgt), the given
normals or create_normal_map of that vertex map).
Rounding: the kernel repeats the card's eager operations in their order,
so on the same card its outputs are bit-equal to `maps_plain`'s. The
vertex maps are a subtract, a multiply by the float32 reciprocal of fx (fy)
(PyTorch's CUDA division by a Python scalar) and a multiply by the depth,
nothing fused; the normal takes `linalg.cross`'s compiled order (one fused
multiply-add a component), the squared norm and the orientation's dot
product the order of PyTorch's reduction over three elements ((e0 + e2) +
e1), then sqrtf and an IEEE division. On the CPU, where PyTorch divides
by the scalar, `maps_plain` is the eager composition itself.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.core import lie, linalg
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.ops.kernels import _build
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
            self.n_blocks = _build.load().o3dt_p2p_blocks(src_pts.shape[0])
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


def _launch_sums(lv: Level, T: torch.Tensor) -> None:
    """The sums kernel: lv.partials <- each CTA's sums of the rows at T."""
    _build.launch("o3dt_p2p_sums", lv.device, *lv._sums_args, T.data_ptr(), *lv._sums_scalars)


def _launch_solve(lv: Level, T: torch.Tensor) -> None:
    """The solve kernel: T <- exp(xi) T and lv.rmse from lv.partials."""
    _build.launch("o3dt_p2p_solve", lv.device, lv.partials.data_ptr(), lv.n_blocks, T.data_ptr(),
                  lv.rmse.data_ptr(), DAMPING)


def iterate(lv: Level, T: torch.Tensor) -> torch.Tensor:
    """One Gauss-Newton iteration: T (4, 4) float32, on the level's device,
    <- exp(xi) T in place; returns the RMSE (0-d float32) of the rows at the
    pose T had on entry. On a card: the sums kernel, then the solve kernel;
    the RMSE is the level's buffer, which the next call overwrites. On the
    CPU: iterate_plain."""
    lv.check_pose(T)
    if lv.device.type == "cpu":
        return iterate_plain(lv, T)
    _launch_sums(lv, T)
    _launch_solve(lv, T)
    return lv.rmse


def maps_plain(src_depth, tgt_depth, intr, tgt_normals=None):
    """A level's inputs in plain PyTorch on any device: (src_pts (HW, 3),
    src_valid (HW,), tgt_vtx_nrm (H', W', 6)) of the (H, W) source and (H',
    W') target depths, the target's normals given (H', W', 3) or computed."""
    src_pts = im.create_vertex_map(src_depth, intr).reshape(-1, 3)
    tgt_vtx = im.create_vertex_map(tgt_depth, intr)
    nrm = im.create_normal_map(tgt_vtx) if tgt_normals is None else tgt_normals
    return src_pts, src_pts[:, 2] > 0, torch.cat([tgt_vtx, nrm], dim=-1)


def maps(src_depth: torch.Tensor, tgt_depth: torch.Tensor, intr, tgt_normals=None):
    """A level's inputs to the iteration, as `maps_plain` returns them, from
    non-empty 2-D float32 contiguous source and target depths on one device
    (a SLAM step's first model depth may differ in shape from the frame's)
    and the level's intrinsic; `tgt_normals`, float32 contiguous and of the
    target's shape with 3 channels, takes the place of the target's computed
    normals. On a card: one launch of the maps kernel into fresh tensors; on
    the CPU: maps_plain."""
    dev = src_depth.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"point_to_plane.maps: unsupported device {dev}")
    for name, depth in (("src_depth", src_depth), ("tgt_depth", tgt_depth)):
        _check(name, depth, torch.float32, dev)
        if depth.ndim != 2 or depth.numel() == 0:
            raise ValueError(f"{name}: expected a non-empty (H, W) image, got shape "
                             f"{tuple(depth.shape)}")
    Hs, Ws = src_depth.shape
    H, W = tgt_depth.shape
    if tgt_normals is not None:
        _check("tgt_normals", tgt_normals, torch.float32, dev, (H, W, 3))
    if dev.type == "cpu":
        return maps_plain(src_depth, tgt_depth, intr, tgt_normals)
    src_pts = torch.empty((Hs * Ws, 3), dtype=torch.float32, device=dev)
    src_valid = torch.empty((Hs * Ws,), dtype=torch.bool, device=dev)
    tgt_vtx_nrm = torch.empty((H, W, 6), dtype=torch.float32, device=dev)
    _build.launch("o3dt_p2p_maps", dev, src_depth.data_ptr(), tgt_depth.data_ptr(),
                  None if tgt_normals is None else tgt_normals.data_ptr(), src_pts.data_ptr(),
                  src_valid.data_ptr(), tgt_vtx_nrm.data_ptr(), Hs, Ws, H, W, intr.fx, intr.fy,
                  intr.cx, intr.cy)
    return src_pts, src_valid, tgt_vtx_nrm


def residual_sums(lv: Level, T: torch.Tensor):
    """(sum of r^2 over w > 0, the valid count as float32), both 0-d, at
    pose T: the odometry's final metrics. On a card: the sums kernel, its
    CTAs' two words summed by PyTorch; on the CPU: residual_sums_plain."""
    lv.check_pose(T)
    if lv.device.type == "cpu":
        return residual_sums_plain(lv, T)
    _launch_sums(lv, T)
    sum_r2 = torch.sum(lv.partials[:, SUM_R2], dtype=torch.float64).to(torch.float32)
    n_valid = torch.sum(lv.partials.view(torch.int32)[:, COUNT]).to(torch.float32)
    return sum_r2, n_valid
