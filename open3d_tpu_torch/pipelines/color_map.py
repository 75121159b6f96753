"""Colour-map optimisation: sharpen a mesh's vertex colours by refining the
camera poses (port of open3d_tpu/pipelines/color_map.py; Zhou and Koltun,
SIGGRAPH 2014).

Rigid mode: per camera, Gauss-Newton on the pose over
sum_v (I_c(proj(T_c, x_v)) - proxy_v)^2, proxy_v the mean intensity of
vertex v over the cameras that see it; visibility is a projected-depth
test with an image-border margin and a depth-discontinuity mask.
Non-rigid mode adds a per-camera image-space warp lattice, optimised by
normalised gradient steps.

Every camera-vmap of the JAX package is a leading camera axis here: the
image filters run on (H, W, N) stacks (geometry.image's filters act on the
first two axes), and the bilinear sampling of all cameras is one batched
gather (`_sample`, geometry.image.bilinear_sample's arithmetic with a
camera offset). The 6x6 solves are one batched solve. The warp lattice's
gradient is one autograd call on the sum of the per-camera losses (the
cameras share no parameter); the lattice gather's backward is the
deterministic scatter-add of core.masking. The loops are fixed counts with
no host read.

No module here holds a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.masking import _scatter_apply, _scatter_plan
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic


@dataclasses.dataclass(frozen=True)
class RigidOptimizerOption:
    """Open3D's RigidOptimizerOption knobs and defaults."""

    maximum_iteration: int = 100
    maximum_allowable_depth: float = 2.5
    depth_threshold_for_visibility_check: float = 0.03
    depth_threshold_for_discontinuity_check: float = 0.1
    half_dilation_kernel_size_for_discontinuity_map: int = 3
    image_boundary_margin: int = 10
    invisible_vertex_color_knn: int = 3


@dataclasses.dataclass(frozen=True)
class NonRigidOptimizerOption(RigidOptimizerOption):
    """Adds the warp lattice's height and its anchor weight."""

    number_of_vertical_anchors: int = 16
    non_rigid_anchor_point_weight: float = 0.316


class _Prepared(NamedTuple):
    gray: torch.Tensor  # (N, H, W)
    dx: torch.Tensor
    dy: torch.Tensor
    depth: torch.Tensor
    mask: torch.Tensor  # (N, H, W) bool: valid and away from a depth discontinuity


def _per_camera(fn, stack: torch.Tensor):
    """Apply an (H, W[, C]) image filter to an (N, H, W) stack at once, as an
    (H, W, N) image."""
    out = fn(stack.permute(1, 2, 0))
    if isinstance(out, tuple):
        return tuple(o.permute(2, 0, 1) for o in out)
    return out.permute(2, 0, 1)


def _prepare_images(colors, depths, opt: RigidOptimizerOption) -> _Prepared:
    """Grey images, their Sobel gradients, and the depth masks."""
    gray = im.rgb_to_gray(colors) if colors.ndim == 4 else colors
    dx, dy = _per_camera(im.filter_sobel, gray)
    valid = (depths > 0) & (depths < opt.maximum_allowable_depth)
    # a large local depth jump drops a dilated rim around it
    ddx, ddy = _per_camera(im.filter_sobel, depths)
    thr = opt.depth_threshold_for_discontinuity_check
    disc = (torch.abs(ddx) > thr) | (torch.abs(ddy) > thr)
    r = opt.half_dilation_kernel_size_for_discontinuity_map
    if r > 0:
        disc = ~_per_camera(lambda m: im.erode_mask(m, r), ~disc)
    return _Prepared(gray=gray, dx=dx, dy=dy, depth=depths, mask=valid & ~disc)


def _project(vertices, extrinsic, intrinsic: PinholeCameraIntrinsic):
    """Camera coordinates and pixel (u, v) of every vertex; `extrinsic` is
    (4, 4) or (N, 4, 4), giving (V, ...) or (N, V, ...)."""
    g = vertices @ extrinsic[..., :3, :3].transpose(-1, -2) + extrinsic[..., None, :3, 3]
    z = g[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = g[..., 0] / zs * intrinsic.fx + intrinsic.cx
    v = g[..., 1] / zs * intrinsic.fy + intrinsic.cy
    return g, u, v, z


def _sample(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (N, H, W[, C]) images at (N, V) pixel coordinates,
    each camera in its own image: geometry.image.bilinear_sample's
    arithmetic; out-of-bounds samples are 0."""
    N, H, W = imgs.shape[:3]
    multi = imgs.ndim == 4
    flat = imgs.reshape((N * H * W,) + tuple(imgs.shape[3:]))
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    if multi:
        du, dv = du[..., None], dv[..., None]
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    base = (torch.arange(N, device=u.device) * (H * W))[:, None]

    def gather(vi, ui):
        return flat[base + torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]

    top = gather(v0i, u0i) * (1 - du) + gather(v0i, u0i + 1) * du
    bot = gather(v0i + 1, u0i) * (1 - du) + gather(v0i + 1, u0i + 1) * du
    out = top * (1 - dv) + bot * dv
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    if multi:
        inb = inb[..., None]
    return torch.where(inb, out, 0.0)


def _visibility(vertices, prep: _Prepared, extrinsics, intrinsic, opt):
    """(V, N) bool: vertex v is visible in camera c (its projected depth
    agrees with the image's)."""
    _, u, v, z = _project(vertices, extrinsics, intrinsic)
    m = int(opt.image_boundary_margin)
    inb = (z > 1e-4) & (u >= m) & (u < intrinsic.width - m) & (v >= m) & (
        v < intrinsic.height - m)
    d_img = _sample(prep.depth, u, v)
    msk = _sample(prep.mask.to(torch.float32), u, v)
    ok = (inb & (d_img > 0) & (torch.abs(d_img - z) < opt.depth_threshold_for_visibility_check)
          & (msk > 0.999))
    return ok.T


def _weighted_mean(samples, vis):
    """Mean over the cameras (axis 0) of (N, V[, C]) samples where `vis`
    (V, N) holds."""
    w = vis.T.to(torch.float32)
    if samples.ndim == 3:
        w = w[..., None]
    return (samples * w).sum(0) / torch.clamp(w.sum(0), min=1e-6)


def _proxy_intensity(vertices, prep, extrinsics, intrinsic, vis):
    _, u, v, _ = _project(vertices, extrinsics, intrinsic)
    return _weighted_mean(_sample(prep.gray, u, v), vis)


def run_rigid_optimizer(
    vertices: torch.Tensor,  # (V, 3) mesh vertices (world)
    colors: torch.Tensor,  # (N, H, W, 3) or (N, H, W) grey
    depths: torch.Tensor,  # (N, H, W) metric
    extrinsics: torch.Tensor,  # (N, 4, 4) world -> camera
    intrinsic: PinholeCameraIntrinsic,
    option: RigidOptimizerOption = RigidOptimizerOption(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (vertex_colors (V, 3), extrinsics (N, 4, 4), residual
    history (maximum_iteration,)): `maximum_iteration` Gauss-Newton steps,
    every camera at once."""
    prep = _prepare_images(colors, depths, option)
    vis = _visibility(vertices, prep, extrinsics, intrinsic, option)
    w = vis.T.to(torch.float32)  # (N, V)
    fx, fy = intrinsic.fx, intrinsic.fy
    stack = torch.stack([prep.gray, prep.dx, prep.dy], dim=-1)  # sampled together
    eye6 = torch.eye(6, dtype=torch.float32, device=vertices.device)

    extr = extrinsics
    hist = torch.zeros(option.maximum_iteration, dtype=torch.float32, device=vertices.device)
    for i in range(option.maximum_iteration):
        proxy = _proxy_intensity(vertices, prep, extr, intrinsic, vis)
        g, u, v, z = _project(vertices, extr, intrinsic)
        s = _sample(stack, u, v)
        gray_s, dx_s, dy_s = s[..., 0], s[..., 1], s[..., 2]
        invz = 1.0 / torch.clamp(z, min=1e-6)
        v0 = dx_s * fx * invz
        v1 = dy_s * fy * invz
        v2 = -(v0 * g[..., 0] + v1 * g[..., 1]) * invz
        # the Jacobian with respect to [omega, t]
        J = torch.stack([-g[..., 2] * v1 + g[..., 1] * v2, g[..., 2] * v0 - g[..., 0] * v2,
                         -g[..., 1] * v0 + g[..., 0] * v1, v0, v1, v2], dim=-1)  # (N, V, 6)
        r = gray_s - proxy
        Jw = J * w[..., None]
        JtJ = Jw.transpose(1, 2) @ J
        Jtr = (Jw * r[..., None]).sum(1)
        dx6 = torch.linalg.solve(JtJ + 1e-6 * eye6, -Jtr)
        extr = lie.se3_exp(dx6) @ extr
        hist[i] = (w * r * r).sum()

    return _final_vertex_colors(vertices, colors, extr, intrinsic, vis), extr, hist


def _colors3(colors):
    return colors[..., None].expand(colors.shape + (3,)) if colors.ndim == 3 else colors


def _final_vertex_colors(vertices, colors, extrinsics, intrinsic, vis):
    _, u, v, _ = _project(vertices, extrinsics, intrinsic)
    return _weighted_mean(_sample(_colors3(colors), u, v), vis)


class _LatticeGather(torch.autograd.Function):
    """sum_c w_c field[idx_c] over the four lattice corners, with the
    backward one deterministic scatter-add by a precomputed plan."""

    @staticmethod
    def forward(ctx, field_flat, idx, wts, plan_order, plan_lengths):
        ctx.save_for_backward(wts, plan_order, plan_lengths)
        return (field_flat[idx] * wts[..., None]).sum(0)

    @staticmethod
    def backward(ctx, grad):
        wts, order, lengths = ctx.saved_tensors
        vals = (wts[..., None] * grad[None]).reshape(-1, grad.shape[-1])
        return _scatter_apply(vals, (order, lengths)), None, None, None, None


def run_non_rigid_optimizer(
    vertices: torch.Tensor,
    colors: torch.Tensor,
    depths: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    option: NonRigidOptimizerOption = NonRigidOptimizerOption(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rigid poses first (half the iterations), then a per-camera image-space
    warp lattice (number_of_vertical_anchors tall) that absorbs residual
    lens or rolling-shutter error: 30 normalised gradient steps on the same
    residual plus an anchor term keeping the warp near zero.

    Returns (vertex_colors, extrinsics, warp_fields (N, A, A2, 2))."""
    half = dataclasses.replace(option, maximum_iteration=max(option.maximum_iteration // 2, 1))
    _, extr, _ = run_rigid_optimizer(vertices, colors, depths, extrinsics, intrinsic, half)
    prep = _prepare_images(colors, depths, option)
    vis = _visibility(vertices, prep, extr, intrinsic, option)
    proxy = _proxy_intensity(vertices, prep, extr, intrinsic, vis)
    dev = vertices.device

    H, W = intrinsic.height, intrinsic.width
    A = int(option.number_of_vertical_anchors)
    A2 = max(int(round(A * W / H)), 2)
    sy = (A - 1) / H
    sx = (A2 - 1) / W
    N = extr.shape[0]
    lam = option.non_rigid_anchor_point_weight

    # the poses stay fixed, so each vertex's lattice cell and weights do too
    _, u, v, _ = _project(vertices, extr, intrinsic)
    gx = torch.clamp(u * sx, 0.0, A2 - 1.001)
    gy = torch.clamp(v * sy, 0.0, A - 1.001)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fxr = gx - x0
    fyr = gy - y0
    cell = (torch.arange(N, device=dev)[:, None] * A + y0.to(torch.int64)) * A2 + x0.to(torch.int64)
    idx = torch.stack([cell, cell + 1, cell + A2, cell + A2 + 1])  # (4, N, V)
    wts = torch.stack([(1 - fxr) * (1 - fyr), fxr * (1 - fyr), (1 - fxr) * fyr, fxr * fyr])
    plan = _scatter_plan(idx, N * A * A2)
    vis_w = vis.T.to(torch.float32)

    def warp_uv(field):
        d = _LatticeGather.apply(field.reshape(N * A * A2, 2), idx, wts, *plan)  # (N, V, 2)
        return u + d[..., 0], v + d[..., 1]

    warp = torch.zeros((N, A, A2, 2), dtype=torch.float32, device=dev)
    for _ in range(30):
        f = warp.detach().requires_grad_(True)
        uw, vw = warp_uv(f)
        r = (_sample(prep.gray, uw, vw) - proxy) * vis_w
        loss = (r * r).sum() + lam * (f * f).sum()
        (gr,) = torch.autograd.grad(loss, f)
        norm = torch.linalg.vector_norm(gr.reshape(N, -1), dim=1)[:, None, None, None]
        warp = warp - 0.5 * gr / (norm + 1e-6) * 0.5

    with torch.no_grad():
        uw, vw = warp_uv(warp)
        vertex_colors = _weighted_mean(_sample(_colors3(colors), uw, vw), vis)
    return vertex_colors, extr, warp
