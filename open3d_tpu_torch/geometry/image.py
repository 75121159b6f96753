"""Dense image ops (port of open3d_tpu/geometry/image.py).

Depth is (H, W) float32 metres with 0 marking invalid pixels; colour is
(H, W, 3) float32 in [0, 1]; intensity is (H, W) float32. Every filter is a
sum of shifted copies, in the JAX package's order, so results agree to
float32 rounding.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic


def clip_transform(depth_raw: torch.Tensor, depth_scale: float, depth_min: float, depth_max: float):
    """Raw depth -> metric float depth; out-of-range -> 0."""
    d = depth_raw.to(torch.float32) / depth_scale
    valid = (d > depth_min) & (d < depth_max)
    return torch.where(valid, d, 0.0)


def rgb_to_gray(color: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H, W) with the ITU-R BT.601 weights."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=color.dtype, device=color.device)
    return color @ w


def _shift2d(img: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """Shift an (H, W[, C]) image; vacated pixels get `fill`."""
    out = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
    H, W = img.shape[0], img.shape[1]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    valid = (yy >= dy) & (yy < H + dy) & (xx >= dx) & (xx < W + dx)
    if img.ndim == 3:
        valid = valid[..., None]
    return torch.where(valid, out, torch.as_tensor(fill, dtype=img.dtype, device=img.device))


def filter_gaussian(img: torch.Tensor, kernel_size: int = 3, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W[, C]) image, renormalised at the
    border by the same stencil over an all-ones image."""
    r = kernel_size // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / torch.sum(k)
    squeeze = img.ndim == 2
    data = img[..., None] if squeeze else img
    out = torch.zeros_like(data)
    for i, wy in enumerate(k):
        row = torch.zeros_like(data)
        for j, wx in enumerate(k):
            row = row + wx * _shift2d(data, i - r, j - r, fill=0.0)
        out = out + wy * row
    ones = torch.ones(data.shape[:2] + (1,), dtype=data.dtype, device=img.device)
    norm = torch.zeros_like(ones)
    for i, wy in enumerate(k):
        for j, wx in enumerate(k):
            norm = norm + wy * wx * _shift2d(ones, i - r, j - r, fill=0.0)
    out = out / torch.clamp(norm, min=1e-8)
    return out[..., 0] if squeeze else out


def pyrdown(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur and 2x decimation."""
    return filter_gaussian(img, kernel_size=5, sigma=1.0)[::2, ::2].contiguous()


def filter_bilateral_depth(depth, kernel_size: int = 5, sigma_space: float = 2.0, sigma_depth: float = 0.05):
    """Edge-preserving bilateral filter for depth; invalid (0) pixels neither
    contribute nor get filled."""
    r = kernel_size // 2
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = _shift2d(depth, dy, dx, fill=0.0)
            w_s = torch.exp(
                torch.tensor(-(dy * dy + dx * dx) * inv2ss, dtype=torch.float32, device=depth.device)
            )
            diff = nb - depth
            w = w_s * torch.exp(-(diff * diff) * inv2sd) * (nb > 0.0)
            num = num + w * nb
            den = den + w
    out = num / torch.clamp(den, min=1e-8)
    return torch.where(depth > 0.0, out, 0.0)


def filter_sobel(img: torch.Tensor):
    """(dx, dy) Sobel gradients of an (H, W) image, a correlation with the
    kernel / 8 (no flip); the border reads zeros."""
    kx = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            s = _shift2d(img, -(i - 1), -(j - 1), fill=0.0)  # img(y + i - 1, x + j - 1)
            dx = dx + (kx[i][j] / 8.0) * s
            dy = dy + (kx[j][i] / 8.0) * s
    return dx, dy


def erode_mask(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Binary erosion with a (2r+1)^2 square; the border counts as invalid."""
    out = mask
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            out = out & _shift2d(mask, dy, dx, fill=False)
    return out


def pyrdown_depth(depth: torch.Tensor, diff_threshold: float = 0.07) -> torch.Tensor:
    """Depth-aware pyrdown: smooth only over valid neighbours within
    `diff_threshold` of the centre, then 2x decimate."""
    r = 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=depth.device)
    k1 = torch.exp(-(x * x) / 2.0)
    k1 = k1 / torch.sum(k1)
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    for i in range(5):
        for j in range(5):
            nb = _shift2d(depth, i - r, j - r, fill=0.0)
            w = k1[i] * k1[j] * (nb > 0.0) * (torch.abs(nb - depth) < diff_threshold)
            num = num + w * nb
            den = den + w
    smoothed = torch.where(depth > 0.0, num / torch.clamp(den, min=1e-8), 0.0)
    return smoothed[::2, ::2].contiguous()


def colorize_depth(depth: torch.Tensor, depth_scale: float = 1.0, depth_min: float = 0.0,
                   depth_max: float = 3.0) -> torch.Tensor:
    """Depth -> (H, W, 3) false-colour RGB in [0, 1], for looking at."""
    d = torch.clamp((depth / depth_scale - depth_min) / max(depth_max - depth_min, 1e-6), 0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(2.0 * d - 1.5), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(2.0 * d - 1.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(2.0 * d - 0.5), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def linear_transform(img: torch.Tensor, scale: float = 1.0, offset: float = 0.0) -> torch.Tensor:
    """img * scale + offset."""
    return img * scale + offset


def dilate(img: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Grayscale dilation: the max over the kernel_size^2 window, per
    channel; the border takes the max over the pixels inside."""
    r = kernel_size // 2
    out = img
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            out = torch.maximum(out, _shift2d(img, dy, dx, fill=float("-inf")))
    return torch.where(torch.isfinite(out), out, img)


def create_vertex_map(depth: torch.Tensor, intrinsic: PinholeCameraIntrinsic) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame vertex map; invalid -> 0."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - intrinsic.cx) / intrinsic.fx * depth
    y = (v - intrinsic.cy) / intrinsic.fy * depth
    vm = torch.stack([x, y, depth], dim=-1)
    return torch.where((depth > 0.0)[..., None], vm, 0.0)


def create_normal_map(vertex_map: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) vertex map -> (H, W, 3) normals via forward differences and
    a cross product, oriented towards the camera; invalid -> 0."""
    vz = vertex_map[..., 2]
    right = _shift2d(vertex_map, 0, -1)
    down = _shift2d(vertex_map, -1, 0)
    valid = (vz > 0.0) & (right[..., 2] > 0.0) & (down[..., 2] > 0.0)
    dx = right - vertex_map
    dy = down - vertex_map
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * vertex_map, dim=-1, keepdim=True) > 0.0
    n = torch.where(flip, -n, n)
    return torch.where(valid[..., None], n, 0.0)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, valid_fill=0.0) -> torch.Tensor:
    """Bilinearly sample an (H, W[, C]) image at float pixel coordinates uv
    (..., 2) = (u = x, v = y). Out-of-bounds samples get `valid_fill`."""
    H, W = img.shape[0], img.shape[1]
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None] if img.ndim == 3 else u - u0
    dv = (v - v0)[..., None] if img.ndim == 3 else v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    def gather(vi, ui):
        return img[torch.clamp(vi, 0, H - 1), torch.clamp(ui, 0, W - 1)]

    g00 = gather(v0i, u0i)
    g01 = gather(v0i, u0i + 1)
    g10 = gather(v0i + 1, u0i)
    g11 = gather(v0i + 1, u0i + 1)
    top = g00 * (1 - du) + g01 * du
    bot = g10 * (1 - du) + g11 * du
    out = top * (1 - dv) + bot * dv
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    if img.ndim == 3:
        inb = inb[..., None]
    return torch.where(inb, out, torch.as_tensor(valid_fill, dtype=out.dtype, device=out.device))


def bilinear_sample_with_grad(img: torch.Tensor, uv: torch.Tensor):
    """(value, d/du, d/dv) of the bilinear interpolant of an (H, W) or
    (H, W, C) image at uv (..., 2): the exact partial derivatives, which
    Gauss-Newton on a bilinear residual needs. Channels share one set of
    four flat corner gathers. Out-of-bounds samples return 0 everywhere."""
    H, W = img.shape[0], img.shape[1]
    multi = img.ndim == 3
    flat = img.reshape(H * W, -1) if multi else img.reshape(H * W)
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    def gather(vi, ui):
        return flat[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]

    g00 = gather(v0i, u0i)
    g01 = gather(v0i, u0i + 1)
    g10 = gather(v0i + 1, u0i)
    g11 = gather(v0i + 1, u0i + 1)
    if multi:
        du = du[..., None]
        dv = dv[..., None]
    val = (g00 * (1 - du) + g01 * du) * (1 - dv) + (g10 * (1 - du) + g11 * du) * dv
    gu = (g01 - g00) * (1 - dv) + (g11 - g10) * dv
    gv = (g10 - g00) * (1 - du) + (g11 - g01) * du
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    if multi:
        inb = inb[..., None]
    return torch.where(inb, val, 0.0), torch.where(inb, gu, 0.0), torch.where(inb, gv, 0.0)


def build_intensity_pyramid(color: torch.Tensor, levels: int):
    gray = rgb_to_gray(color) if color.ndim == 3 else color
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(pyrdown(pyr[-1]))
    return pyr


def build_depth_pyramid(depth: torch.Tensor, levels: int, diff_threshold: float = 0.07):
    pyr = [depth]
    for _ in range(levels - 1):
        pyr.append(pyrdown_depth(pyr[-1], diff_threshold))
    return pyr


def build_normal_pyramid(normals: torch.Tensor, levels: int):
    """(H, W, 3) unit-normal pyramid: 2x2 mean + renormalise per level."""
    pyr = [normals]
    for _ in range(levels - 1):
        n = pyr[-1]
        H2, W2 = n.shape[0] // 2, n.shape[1] // 2
        m = n[: 2 * H2, : 2 * W2].reshape(H2, 2, W2, 2, 3).mean(dim=(1, 3))
        norm = torch.linalg.norm(m, dim=-1, keepdim=True)
        pyr.append(torch.where(norm > 0.3, m / torch.clamp(norm, min=1e-9), 0.0))
    return pyr
