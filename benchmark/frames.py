"""The frozen scene, camera path and renderer that make every cell's frames.

A copy of `open3d_tpu_torch/data/synthetic.py` as of commit
c976156: `sd_sphere`, `sd_box`, `sd_cylinder_y`, `sd_room` and
`default_scene_sdf` (lines 23-67), `scene_color` (:70-77), `sdf_normal`
(:80-84), the sphere trace with its Newton steps `_render_rays` (:87-100),
`render_depth`'s pixel rays and hit test (:103-136) and `look_at`
(:172-187), frozen here so that a change to the program cannot change the
inputs. Two things differ, and neither changes a rendered pixel's
arithmetic:

- the orbit takes a start angle, a height phase and a fixed angle a
  frame, where `orbit_trajectory` spreads a span over the
  frames; `look_at` is applied to all eyes at once;
- `render` traces every ray of every frame in one batch, where
  `render_sequence` loops over the frames.

The scene is a 5 x 3 x 5 m room (y down, the floor at y = +1.5) with a
sphere, a table, a column and a second box.
"""

from __future__ import annotations

import torch


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
    dx = p[..., 0] - center[0]
    dz = p[..., 2] - center[2]
    d_xz = torch.sqrt(dx * dx + dz * dz) - radius
    d_y = torch.abs(p[..., 1] - center[1]) - half_height
    outside = torch.linalg.norm(torch.clamp(torch.stack([d_xz, d_y], -1), min=0.0), dim=-1)
    inside = torch.clamp(torch.maximum(d_xz, d_y), max=0.0)
    return outside + inside


def sd_room(p, half_extents):
    return -sd_box(p, (0.0, 0.0, 0.0), half_extents)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    d = sd_room(p, (2.5, 1.5, 2.5))
    d = torch.minimum(d, sd_sphere(p, (0.8, 0.9, 0.4), 0.5))
    d = torch.minimum(d, sd_box(p, (-0.9, 1.1, -0.6), (0.5, 0.4, 0.35)))
    d = torch.minimum(d, sd_cylinder_y(p, (-0.2, 0.5, 1.2), 0.3, 1.0))
    d = torch.minimum(d, sd_box(p, (1.6, 1.25, -1.4), (0.35, 0.25, 0.6)))
    return d


def scene_color(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * torch.sin(3.1 * x + 1.7 * z) + 0.15 * torch.sin(9.0 * x + 5.0 * y)
    g = 0.5 + 0.35 * torch.sin(2.3 * y + 0.9 * x + 2.0) + 0.15 * torch.sin(8.0 * z + 6.0 * x)
    b = 0.5 + 0.35 * torch.sin(2.9 * z + 1.3 * y + 4.0) + 0.15 * torch.sin(7.0 * y + 5.5 * z)
    return torch.clamp(torch.stack([0.25 + 0.5 * r, 0.25 + 0.5 * g, 0.25 + 0.5 * b], -1), 0.0, 1.0)


def sdf_normal(sdf, p: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    offs = torch.eye(3, dtype=torch.float32, device=p.device) * eps
    g = torch.stack([(sdf(p + offs[i]) - sdf(p - offs[i])) / (2 * eps) for i in range(3)], dim=-1)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)


def _render_rays(sdf, origins, dirs, n_steps: int):
    t = torch.full(origins.shape[:-1], 0.05, dtype=torch.float32, device=origins.device)
    for _ in range(n_steps):
        t = t + sdf(origins + t[..., None] * dirs)
    for _ in range(3):
        p = origins + t[..., None] * dirs
        g = sdf_normal(sdf, p)
        dd = torch.sum(g * dirs, dim=-1)
        denom = torch.where(torch.abs(dd) < 0.1, torch.sign(dd) * 0.1 + (dd == 0), dd)
        t = t + torch.clamp(sdf(p) / denom, -0.05, 0.05)
    return t


def look_at(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) world -> camera extrinsics, +z forward, y down."""
    up = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32, device=eye.device).expand_as(eye)
    fwd = target - eye
    fwd = fwd / torch.clamp(torch.linalg.norm(fwd, dim=-1, keepdim=True), min=1e-9)
    right = torch.linalg.cross(up, fwd, dim=-1)
    right = right / torch.clamp(torch.linalg.norm(right, dim=-1, keepdim=True), min=1e-9)
    down = torch.linalg.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=-2)
    T = torch.eye(4, dtype=torch.float32, device=eye.device).repeat(eye.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = -(R @ eye[..., None])[..., 0]
    return T


def orbit(n_frames: int, rad_per_frame: float, start: float, phase: float, radius: float,
          height: float, device) -> torch.Tensor:
    """(n_frames, 4, 4) world -> camera extrinsics of the room's orbit:
    eye (r cos s, h + 0.15 sin(2 s + phase), r sin s), looking at
    (0.2 sin s, 0.8, 0.2 cos s), s = start + i rad_per_frame."""
    s = start + rad_per_frame * torch.arange(n_frames, dtype=torch.float64, device=device)
    s = s.to(torch.float32)
    eyes = torch.stack(
        [radius * torch.cos(s), height + 0.15 * torch.sin(2.0 * s + phase), radius * torch.sin(s)],
        -1)
    targets = torch.stack([0.2 * torch.sin(s), 0.8 + 0.0 * s, 0.2 * torch.cos(s)], -1)
    return look_at(eyes, targets)


def render(extrinsics: torch.Tensor, width: int, height: int, fx: float, fy: float, cx: float,
           cy: float, depth_min: float, depth_max: float, n_steps: int = 96):
    """Depth (F, H, W) and colour (F, H, W, 3) float32 seen from every
    extrinsic at once, on the extrinsics' device. A pixel whose ray escapes
    the scene, or whose depth lies outside [depth_min, depth_max], reads 0
    (a sensor's invalid pixel); its colour stays the surface's."""
    dev = extrinsics.device
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    rays_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    R = extrinsics[:, :3, :3]
    cam_center = -(R.transpose(1, 2) @ extrinsics[:, :3, 3:])[..., 0]  # (F, 3)
    dirs_w = torch.einsum("hwk,fkj->fhwj", rays_cam, R)
    dir_norm = torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    dirs_n = dirs_w / dir_norm
    origins = cam_center[:, None, None, :].expand(dirs_n.shape)
    ray_t = _render_rays(scene_sdf, origins, dirs_n, n_steps)
    p_hit = origins + ray_t[..., None] * dirs_n
    hit = (torch.abs(scene_sdf(p_hit)) < 2e-3) & (ray_t > 0.0)
    z = ray_t / dir_norm[..., 0]
    depth = torch.where(hit & (z >= depth_min) & (z <= depth_max), z, 0.0)
    color = torch.where(hit[..., None], scene_color(p_hit), 0.0)
    return depth, color


def ping_pong(i: int, n: int) -> int:
    """The frame that step i plays from n frames played forward, then
    backward, then forward again: 0 .. n-1, n-2 .. 1, 0, 1 ..."""
    if n == 1:
        return 0
    k = i % (2 * n - 2)
    return k if k < n else 2 * n - 2 - k
