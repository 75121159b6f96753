"""Frame-to-model tracking of the reference: coarse-to-fine point-to-plane
RGB-D odometry of an input depth frame against the model's raycast depth.

The semantics are those of Open3D's `RGBDOdometry` (point-to-plane) as the
port implements them, frozen from `open3d_tpu_torch` as of commit
c976156: `models/dense_slam.py:track_frame_to_model` (:112-138;
source = the input frame, target = the raycast, three levels of (6, 3, 1)
iterations), `pipelines/odometry.py` (`_project` :61-72,
`_nearest_sample` :75-83, `_rows_point_to_plane` :114-125, `_gn_level`
:183-198, `rgbd_odometry_multi_scale` :201-267: the level maps, the
Huber weights, the Gauss-Newton loop that stops when the RMSE moves by
less than 1e-6, fitness at the finest level) and `geometry/image.py`
(`_shift2d` :29-38, `filter_bilateral_depth` :70-89, `erode_mask`
:106-114, `pyrdown_depth` :117-133, `create_vertex_map` :164-172,
`create_normal_map` :175-189). The 6 x 6 solve is `torch.linalg.solve` and
the exponential map is written out here: neither is the program's.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import fma, rounder
from benchmark.reference.grid import Intr

CRITERIA = (6, 3, 1)
DEPTH_OUTLIER_TRUNC = 0.07
DEPTH_HUBER_DELTA = 0.05
RELATIVE_RMSE = 1e-6
PYR_DIFF = 0.07


def _shift2d(img, dy: int, dx: int, fill=0.0):
    out = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
    H, W = img.shape[0], img.shape[1]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    valid = (yy >= dy) & (yy < H + dy) & (xx >= dx) & (xx < W + dx)
    if img.ndim == 3:
        valid = valid[..., None]
    return torch.where(valid, out, torch.as_tensor(fill, dtype=img.dtype, device=img.device))


def bilateral(depth, r: int = 2, sigma_space: float = 2.0, sigma_depth: float = 0.05):
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = _shift2d(depth, dy, dx, fill=0.0)
            w_s = torch.exp(torch.tensor(-(dy * dy + dx * dx) * inv2ss, dtype=torch.float32,
                                         device=depth.device))
            diff = nb - depth
            w = w_s * torch.exp(-(diff * diff) * inv2sd) * (nb > 0.0)
            num = num + w * nb
            den = den + w
    return torch.where(depth > 0.0, num / torch.clamp(den, min=1e-8), 0.0)


def pyrdown_depth(depth, diff_threshold: float = PYR_DIFF):
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
    return torch.where(depth > 0.0, num / torch.clamp(den, min=1e-8), 0.0)[::2, ::2].contiguous()


def vertex_map(depth, intr: Intr):
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return torch.where((depth > 0.0)[..., None], torch.stack([x, y, depth], dim=-1), 0.0)


def normal_map(vm):
    right = _shift2d(vm, 0, -1)
    down = _shift2d(vm, -1, 0)
    valid = (vm[..., 2] > 0.0) & (right[..., 2] > 0.0) & (down[..., 2] > 0.0)
    n = torch.linalg.cross(right - vm, down - vm, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    n = torch.where(torch.sum(n * vm, dim=-1, keepdim=True) > 0.0, -n, n)
    return torch.where(valid[..., None], n, 0.0)


def se3_exp(xi):
    """(6,) [omega, v] -> (4, 4), Rodrigues with series near 0."""
    w, v = xi[:3], xi[3:]
    th2 = float(torch.sum(w * w))
    th = math.sqrt(th2)
    if th2 < 1e-8:
        a, b, c = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        a, b, c = math.sin(th) / th, (1.0 - math.cos(th)) / th2, (th - math.sin(th)) / (th2 * th)
    z = torch.zeros((), dtype=xi.dtype, device=xi.device)
    Wm = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                      torch.stack([-w[1], w[0], z])])
    W2 = Wm @ Wm
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = eye + a * Wm + b * W2
    T[:3, 3] = (eye + b * Wm + c * W2) @ v
    return T


def _project(P, intr: Intr):
    z = P[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = fma(P[..., 0] / zs, intr.fx, intr.cx)
    v = fma(P[..., 1] / zs, intr.fy, intr.cy)
    inb = (z > 1e-4) & (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1)
    return u, v, inb


def _nearest(img, u, v):
    H, W = img.shape[0], img.shape[1]
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    return img.reshape(H * W, -1)[vi * W + ui]


def _rows(src_pts, src_valid, tgt_vn, T, intr, q):
    P = src_pts @ T[:3, :3].T + T[:3, 3]
    u, v, inb = _project(P, intr)
    qn = _nearest(tgt_vn, u, v)
    qp, n = qn[:, :3], qn[:, 3:]
    valid = src_valid & inb & (qp[:, 2] > 0) & (torch.sum(n * n, dim=-1) > 0.5)
    r = q(torch.sum((P - qp) * n, dim=-1))
    valid = valid & (torch.abs(r) < DEPTH_OUTLIER_TRUNC)
    w = valid.to(torch.float32) * (DEPTH_HUBER_DELTA
                                   / torch.clamp(torch.abs(r), min=DEPTH_HUBER_DELTA))
    J = q(torch.cat([torch.linalg.cross(P, n, dim=-1), n], dim=-1))
    return J, r, w, valid


def track(input_depth, model_depth, intr: Intr, low: bool = False):
    """(T (4, 4) mapping input-frame points into the model frame, fitness)."""
    q = rounder(low)
    dev = input_depth.device
    src_pyr, tgt_pyr = [input_depth], [model_depth]
    for _ in range(len(CRITERIA) - 1):
        src_pyr.append(pyrdown_depth(src_pyr[-1]))
        tgt_pyr.append(pyrdown_depth(tgt_pyr[-1]))
    T = torch.eye(4, dtype=torch.float32, device=dev)
    n_levels = len(CRITERIA)
    for lvl in reversed(range(n_levels)):
        il = intr.scaled(0.5 ** lvl)
        sv = vertex_map(bilateral(src_pyr[lvl]), il).reshape(-1, 3)
        tv = vertex_map(bilateral(tgt_pyr[lvl]), il)
        tvn = torch.cat([tv, normal_map(tv)], dim=-1)
        s_valid = sv[:, 2] > 0
        prev = None
        for it in range(CRITERIA[n_levels - 1 - lvl]):
            J, r, w, valid = _rows(sv, s_valid, tvn, T, il, q)
            Jw = J * w[:, None]
            JtJ = q(Jw.T @ J)
            Jtr = q(Jw.T @ r)
            lam = 1e-6 * max(float(torch.diagonal(JtJ).max()), 1.0)
            xi = q(torch.linalg.solve(JtJ + lam * torch.eye(6, device=dev), -Jtr))
            T = se3_exp(xi) @ T
            n_in = max(float(valid.sum()), 1.0)
            rmse = math.sqrt(float(torch.sum(torch.where(w > 0, r * r, 0.0))) / n_in)
            if it > 0 and abs(prev - rmse) < RELATIVE_RMSE:
                break
            prev = rmse
    sv = vertex_map(src_pyr[0], intr).reshape(-1, 3)
    tv = vertex_map(tgt_pyr[0], intr)
    s_valid = sv[:, 2] > 0
    _, _, _, valid = _rows(sv, s_valid, torch.cat([tv, normal_map(tv)], dim=-1), T, intr, q)
    fitness = float(valid.sum()) / max(float(s_valid.sum()), 1.0)
    return T, fitness
