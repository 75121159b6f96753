"""Synthetic RGB-D scenes with exact ground truth (port of
open3d_tpu/data/synthetic.py).

A living-room-scale signed-distance scene, depth rendered by sphere
tracing with a few Newton steps, a smooth pseudo-texture for colour, and
an orbit trajectory. Normals are central differences of the SDF, as in the
JAX package. Frames are made on the device they are asked for.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.pointcloud import PointCloud


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def sd_sphere(p, center, radius):
    return torch.linalg.norm(p - _vec(center, p), dim=-1) - radius


def sd_box(p, center, half_extents):
    q = torch.abs(p - _vec(center, p)) - _vec(half_extents, p)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.amax(-1), max=0.0)
    return outside + inside


def sd_cylinder_y(p, center, radius, half_height):
    """Vertical (y-axis) capped cylinder."""
    dx = p[..., 0] - center[0]
    dz = p[..., 2] - center[2]
    d_xz = torch.sqrt(dx * dx + dz * dz) - radius
    d_y = torch.abs(p[..., 1] - center[1]) - half_height
    outside = torch.linalg.norm(torch.clamp(torch.stack([d_xz, d_y], -1), min=0.0), dim=-1)
    inside = torch.clamp(torch.maximum(d_xz, d_y), max=0.0)
    return outside + inside


def sd_room(p, half_extents):
    """Hollow box (inward-facing walls) centred at the origin."""
    return -sd_box(p, (0.0, 0.0, 0.0), half_extents)


def default_scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """5x3x5 m room with a sphere, a box 'table', a cylinder 'column' and a
    second box; y points down, the floor is at y = +1.5."""
    d = sd_room(p, (2.5, 1.5, 2.5))
    d = torch.minimum(d, sd_sphere(p, (0.8, 0.9, 0.4), 0.5))
    d = torch.minimum(d, sd_box(p, (-0.9, 1.1, -0.6), (0.5, 0.4, 0.35)))
    d = torch.minimum(d, sd_cylinder_y(p, (-0.2, 0.5, 1.2), 0.3, 1.0))
    d = torch.minimum(d, sd_box(p, (1.6, 1.25, -1.4), (0.35, 0.25, 0.6)))
    return d


def scene_color(p: torch.Tensor) -> torch.Tensor:
    """Deterministic smooth pseudo-texture in [0, 1]^3."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * torch.sin(3.1 * x + 1.7 * z) + 0.15 * torch.sin(9.0 * x + 5.0 * y)
    g = 0.5 + 0.35 * torch.sin(2.3 * y + 0.9 * x + 2.0) + 0.15 * torch.sin(8.0 * z + 6.0 * x)
    b = 0.5 + 0.35 * torch.sin(2.9 * z + 1.3 * y + 4.0) + 0.15 * torch.sin(7.0 * y + 5.5 * z)
    return torch.clamp(torch.stack([0.25 + 0.5 * r, 0.25 + 0.5 * g, 0.25 + 0.5 * b], -1), 0.0, 1.0)


def sdf_normal(sdf: Callable, p: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Central-difference SDF gradient, normalised."""
    offs = torch.eye(3, dtype=torch.float32, device=p.device) * eps
    g = torch.stack([(sdf(p + offs[i]) - sdf(p - offs[i])) / (2 * eps) for i in range(3)], dim=-1)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)


def _render_rays(sdf, origins, dirs, n_steps: int):
    t = torch.full(origins.shape[:-1], 0.05, dtype=torch.float32, device=origins.device)
    for _ in range(n_steps):
        t = t + sdf(origins + t[..., None] * dirs)
    # Newton refinement along the ray (sphere tracing converges only
    # linearly near the surface)
    for _ in range(3):
        p = origins + t[..., None] * dirs
        g = sdf_normal(sdf, p)
        dd = torch.sum(g * dirs, dim=-1)
        denom = torch.where(torch.abs(dd) < 0.1, torch.sign(dd) * 0.1 + (dd == 0), dd)
        t = t + torch.clamp(sdf(p) / denom, -0.05, 0.05)
    return t


def render_depth(
    sdf: Callable,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_max: float = 8.0,
    n_steps: int = 96,
    with_color: bool = True,
):
    """(depth (H, W) f32, colour (H, W, 3) f32 or None) seen from a
    world -> camera extrinsic, on the extrinsic's device. Pixels that escape
    the scene get depth 0."""
    dev = extrinsic.device
    H, W = intrinsic.height, intrinsic.width
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    rays_cam = torch.stack(
        [(u - intrinsic.cx) / intrinsic.fx, (v - intrinsic.cy) / intrinsic.fy, torch.ones_like(u)],
        dim=-1,
    )
    E = extrinsic.to(torch.float32)
    R = E[:3, :3]
    cam_center = -R.T @ E[:3, 3]
    dirs_w = rays_cam @ R
    dir_norm = torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    dirs_n = dirs_w / dir_norm
    origins = cam_center.expand(dirs_n.shape)
    ray_t = _render_rays(sdf, origins, dirs_n, n_steps)
    p_hit = origins + ray_t[..., None] * dirs_n
    hit = (torch.abs(sdf(p_hit)) < 2e-3) & (ray_t > 0.0)
    z = ray_t / dir_norm[..., 0]
    depth = torch.where(hit & (z < depth_max) & (z > 0.05), z, 0.0)
    if not with_color:
        return depth, None
    color = torch.where(hit[..., None], scene_color(p_hit), 0.0)
    return depth, color


def sample_surface(
    sdf: Callable,
    key: torch.Generator,
    n_points: int,
    bound: float = 2.4,
    n_newton: int = 30,
    capacity: Optional[int] = None,
    with_normals: bool = True,
    with_colors: bool = False,
) -> PointCloud:
    """Points on the SDF's zero level set: uniform points of the cube
    [-bound, bound]^3, drawn from the generator `key` on its own device,
    projected along the gradient (p <- p - 0.9 sdf(p) n(p), `n_newton`
    times); the points that end within 1e-3 of the surface are valid. The
    draws are not JAX's: the points differ from the JAX package's, their
    distribution does not."""
    p = torch.rand((n_points, 3), generator=key, device=key.device, dtype=torch.float32)
    p = p * (2.0 * bound) - bound
    for _ in range(n_newton):
        p = p - (sdf(p) * 0.9)[..., None] * sdf_normal(sdf, p)
    ok = torch.abs(sdf(p)) < 1e-3
    attrs = {}
    if with_normals:
        attrs["normals"] = sdf_normal(sdf, p)
    if with_colors:
        attrs["colors"] = scene_color(p)
    return PointCloud.create(p, capacity=capacity or n_points, mask=ok, **attrs)


def look_at(eye, target, up=(0.0, -1.0, 0.0), device=None) -> torch.Tensor:
    """World -> camera extrinsic with +z forward, y down."""
    dev = default_device(device) if not isinstance(eye, torch.Tensor) else eye.device
    eye = torch.as_tensor(eye, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    up = torch.as_tensor(up, dtype=torch.float32, device=dev)
    fwd = target - eye
    fwd = fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-9)
    right = torch.linalg.cross(up, fwd, dim=-1)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-9)
    down = torch.linalg.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=0)
    T = torch.eye(4, dtype=torch.float32, device=dev)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T


def orbit_trajectory(
    n_frames: int, radius: float = 1.4, height: float = 0.2, span: float = 1.2, device=None
) -> torch.Tensor:
    """Smooth orbit inside the default room, looking at the scene centre.
    Returns (n_frames, 4, 4) world -> camera extrinsics."""
    dev = default_device(device)
    s = torch.linspace(0.0, span, n_frames, dtype=torch.float32, device=dev)
    eyes = torch.stack(
        [radius * torch.cos(s), height + 0.15 * torch.sin(2.0 * s), radius * torch.sin(s)], -1
    )
    targets = torch.stack([0.2 * torch.sin(s), 0.8 + 0.0 * s, 0.2 * torch.cos(s)], -1)
    return torch.stack([look_at(eyes[i], targets[i]) for i in range(n_frames)])


def render_sequence(
    n_frames: int,
    intrinsic: Optional[PinholeCameraIntrinsic] = None,
    sdf: Callable = default_scene_sdf,
    depth_noise: float = 0.0,
    key: Optional[torch.Generator] = None,
    device=None,
    **traj_kwargs,
):
    """Render an RGB-D sequence with ground-truth world -> camera poses.
    Returns (depths (F, H, W), colors (F, H, W, 3), extrinsics (F, 4, 4),
    intrinsic), all on `device` (default: the card).

    With `depth_noise` > 0 and a generator `key` (on `device`), each frame's
    valid depth becomes d + depth_noise * d * n, n a standard normal drawn
    from `key` (one (H, W) draw a frame, in frame order), and invalid depth
    stays 0, as in the reference. The draws are not JAX's: a test that
    compares bits draws the normals from the same generator itself."""
    dev = default_device(device)
    if intrinsic is None:
        intrinsic = PinholeCameraIntrinsic(160, 120, 131.25, 131.25, 79.5, 59.5)
    extr = orbit_trajectory(n_frames, device=dev, **traj_kwargs)
    depths, colors = [], []
    for i in range(n_frames):
        d, c = render_depth(sdf, intrinsic, extr[i])
        if depth_noise > 0.0 and key is not None:
            noise = depth_noise * d * torch.randn(d.shape, generator=key, device=d.device,
                                                  dtype=d.dtype)
            d = torch.where(d > 0, d + noise, torch.zeros_like(d))
        depths.append(d)
        colors.append(c)
    return torch.stack(depths), torch.stack(colors), extr, intrinsic
