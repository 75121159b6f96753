"""Stage 1 of the offline reconstruction system in the reference: one
fragment's odometry edges, its pose graph, its 8^3-block grid and its
point cloud, in plain PyTorch.

Frozen from the port as of commit c976156:
- HYBRID odometry: `pipelines/odometry.py` (`_rows_hybrid` :142-178, the
  level data :86-111, `rgbd_odometry_multi_scale` :201-267 at its default
  (10, 5, 3) iterations), `compute_odometry_information_matrix`
  (:270-296), and `geometry/image.py`'s intensity pyramid (`rgb_to_gray`
  :23-26, `filter_gaussian` :41-62, `pyrdown` :65-67) and
  `bilinear_sample_with_grad` (:221-254); the solve and the exponential
  map are `track.py`'s, not the program's;
- the fragment's graph: `pipelines/reconstruction.py:_fragment_pose_graph`
  (:229-267): adjacent pairs, and keyframe pairs every
  `n_keyframes_per_n_frame` frames kept at fitness > 0.3;
- the optimisation: `pipelines/pose_graph.py:global_optimization`
  (:198-255), Levenberg-Marquardt with line-process weights on the loop
  closures and their pruning, here in float64 with Jacobians of this
  file's own residual (the program's are float32, from its own);
- the grid: `reconstruction.py:create_fragment_grid` and
  `integrate_fragment_frame` (:270-290), `voxel_block_grid.py`'s
  `_new_voxel_values` (:205-244) and `ops/kernels/tsdf.py:fuse_blocks_plain`
  (:46-91), the plain function the fuse kernel K3 is held bit-equal to;
- the cloud: `voxel_block_grid.py:extract_point_cloud` (:825-897).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import grid as rg
from benchmark.reference import rounder
from benchmark.reference import track as rt

CRITERIA = (10, 5, 3)
INTENSITY_HUBER_DELTA = 0.1
KEYFRAME_FITNESS = 0.3
TSDF_SCALE = rg.TSDF_SCALE


# --- HYBRID odometry ----------------------------------------------------------


def gray(color):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=color.dtype, device=color.device)
    return color @ w


def pyrdown(img):
    r = 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x * x) / 2.0)
    k = k / torch.sum(k)
    data = img[..., None]
    out = torch.zeros_like(data)
    for i, wy in enumerate(k):
        row = torch.zeros_like(data)
        for j, wx in enumerate(k):
            row = row + wx * rt._shift2d(data, i - r, j - r, fill=0.0)
        out = out + wy * row
    ones = torch.ones(data.shape[:2] + (1,), dtype=data.dtype, device=img.device)
    norm = torch.zeros_like(ones)
    for i, wy in enumerate(k):
        for j, wx in enumerate(k):
            norm = norm + wy * wx * rt._shift2d(ones, i - r, j - r, fill=0.0)
    return (out / torch.clamp(norm, min=1e-8))[..., 0][::2, ::2].contiguous()


def erode(mask):
    out = mask
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out & rt._shift2d(mask, dy, dx, fill=False)
    return out


def bilinear_grad(img, u, v):
    H, W = img.shape[0], img.shape[1]
    flat = img.reshape(H * W, -1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    def at(vi, ui):
        return flat[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]

    g00, g01 = at(v0i, u0i), at(v0i, u0i + 1)
    g10, g11 = at(v0i + 1, u0i), at(v0i + 1, u0i + 1)
    val = (g00 * (1 - du) + g01 * du) * (1 - dv) + (g10 * (1 - du) + g11 * du) * dv
    gu = (g01 - g00) * (1 - dv) + (g11 - g10) * dv
    gv = (g10 - g00) * (1 - du) + (g11 - g01) * du
    inb = ((u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1))[..., None]
    return torch.where(inb, val, 0.0), torch.where(inb, gu, 0.0), torch.where(inb, gv, 0.0)


class _Level:
    def __init__(self, src_depth, src_inten, tgt_depth, tgt_inten, intr):
        self.intr = intr
        self.src_pts = rt.vertex_map(src_depth, intr).reshape(-1, 3)
        self.src_valid = self.src_pts[:, 2] > 0
        self.src_inten = src_inten.reshape(-1)
        tv = rt.vertex_map(tgt_depth, intr)
        td = tv[..., 2]
        gv = erode(td > 0.0)
        self.tgt_vtx_gv = torch.cat([tv, gv[..., None].to(torch.float32)], dim=-1)
        self.tgt_depth_inten = torch.stack([td, tgt_inten], dim=-1)


def _rows_hybrid(ld: _Level, T, q):
    P = ld.src_pts @ T[:3, :3].T + T[:3, 3]
    u, v, inb = rt._project(P, ld.intr)
    di, gx2, gy2 = bilinear_grad(ld.tgt_depth_inten, u, v)
    dt, it = di[:, 0], di[:, 1]
    gv = rt._nearest(ld.tgt_vtx_gv, u, v)[:, 3] > 0.5
    valid = (ld.src_valid & inb & (dt > 0) & (torch.abs(dt - P[:, 2]) < rt.DEPTH_OUTLIER_TRUNC)
             & gv)
    z = torch.clamp(P[:, 2], min=1e-6)
    fx, fy = ld.intr.fx, ld.intr.fy
    fgx, fgy = gx2[:, 1] * fx / z, gy2[:, 1] * fy / z
    Gi = torch.stack([fgx, fgy, -(fgx * P[:, 0] + fgy * P[:, 1]) / z], dim=-1)
    ri = it - ld.src_inten
    wi = valid.to(torch.float32) * (INTENSITY_HUBER_DELTA
                                    / torch.clamp(torch.abs(ri), min=INTENSITY_HUBER_DELTA))
    Ji = torch.cat([torch.linalg.cross(P, Gi, dim=-1), Gi], dim=-1)
    fgx, fgy = gx2[:, 0] * fx / z, gy2[:, 0] * fy / z
    Gd = torch.stack([fgx, fgy, -(fgx * P[:, 0] + fgy * P[:, 1]) / z - 1.0], dim=-1)
    rd = dt - P[:, 2]
    wd = valid.to(torch.float32) * (rt.DEPTH_HUBER_DELTA
                                    / torch.clamp(torch.abs(rd), min=rt.DEPTH_HUBER_DELTA))
    Jd = torch.cat([torch.linalg.cross(P, Gd, dim=-1), Gd], dim=-1)
    s = math.sqrt(0.5)
    J = q(torch.cat([s * Ji, s * Jd], dim=0))
    r = q(torch.cat([s * ri, s * rd], dim=0))
    return J, r, torch.cat([wi, wd], dim=0), valid


def hybrid(src, tgt, intr: rg.Intr, low: bool = False):
    """HYBRID odometry of the RGB-D pair: (T mapping source points into the
    target frame, fitness). `src`, `tgt`: (depth, colour) on the device."""
    q = rounder(low)
    n = len(CRITERIA)
    sd, td = [src[0]], [tgt[0]]
    si, ti = [gray(src[1])], [gray(tgt[1])]
    for _ in range(n - 1):
        sd.append(rt.pyrdown_depth(sd[-1]))
        td.append(rt.pyrdown_depth(td[-1]))
        si.append(pyrdown(si[-1]))
        ti.append(pyrdown(ti[-1]))
    T = torch.eye(4, dtype=torch.float32, device=src[0].device)
    for lvl in reversed(range(n)):
        il = intr.scaled(0.5 ** lvl)
        ld = _Level(rt.bilateral(sd[lvl]), si[lvl], rt.bilateral(td[lvl]), ti[lvl], il)
        prev = None
        for it in range(CRITERIA[n - 1 - lvl]):
            J, r, w, valid = _rows_hybrid(ld, T, q)
            Jw = J * w[:, None]
            JtJ = q(Jw.T @ J)
            Jtr = q(Jw.T @ r)
            lam = 1e-6 * max(float(torch.diagonal(JtJ).max()), 1.0)
            xi = q(torch.linalg.solve(JtJ + lam * torch.eye(6, device=JtJ.device), -Jtr))
            T = rt.se3_exp(xi) @ T
            n_in = max(float(valid.sum()), 1.0)
            rmse = math.sqrt(float(torch.sum(torch.where(w > 0, r * r, 0.0))) / n_in)
            if it > 0 and abs(prev - rmse) < rt.RELATIVE_RMSE:
                break
            prev = rmse
    ld = _Level(sd[0], si[0], td[0], ti[0], intr)
    _, _, _, valid = _rows_hybrid(ld, T, q)
    return T, float(valid.sum()) / max(float(ld.src_valid.sum()), 1.0)


def information(src_depth, tgt_depth, intr: rg.Intr, T, dist: float = 0.07):
    sv = rt.vertex_map(src_depth, intr).reshape(-1, 3)
    tv = rt.vertex_map(tgt_depth, intr)
    P = sv @ T[:3, :3].T + T[:3, 3]
    u, v, inb = rt._project(P, intr)
    qp = rt._nearest(tv, u, v)
    valid = (sv[:, 2] > 0) & inb & (qp[:, 2] > 0) & (torch.sum((P - qp) ** 2, dim=-1) < dist ** 2)
    x, y, z = qp[:, 0], qp[:, 1], qp[:, 2]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    # G = [-skew(q) | I], rows of the 3 x 6 block
    G = torch.stack([torch.stack([zero, z, -y, one, zero, zero], -1),
                     torch.stack([-z, zero, x, zero, one, zero], -1),
                     torch.stack([y, -x, zero, zero, zero, one], -1)], dim=1)
    Gw = G * valid.to(torch.float32)[:, None, None]
    return torch.einsum("nij,nik->jk", Gw, G)


# --- the pose graph -------------------------------------------------------------


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp(xi):
    """(..., 6) -> (..., 4, 4), float64, with series near 0."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, -1)
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-10
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / torch.clamp(th2 * th,
                                                                                  min=1e-30))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    t = ((eye + b[..., None, None] * W + c[..., None, None] * W2) @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], -1)
    return torch.cat([top, bottom], -2)


def _log(T):
    """(..., 4, 4) -> (..., 6), float64, for rotations well under pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2, -1.0, 1.0)
    th = torch.acos(torch.clamp(cos, max=1 - 1e-15))
    th2 = th * th
    small = th2 < 1e-10
    k = torch.where(small, 0.5 + th2 / 12, th / (2 * torch.sin(torch.clamp(th, min=1e-15))))
    Wr = R - R.transpose(-1, -2)
    w = k[..., None] * torch.stack([Wr[..., 2, 1], Wr[..., 0, 2], Wr[..., 1, 0]], -1)
    W = _hat(w)
    coef = torch.where(small, 1.0 / 12 + th2 / 720,
                       (1 - th * torch.sin(th) / (2 * (1 - torch.cos(th))).clamp(min=1e-30))
                       / torch.clamp(th2, min=1e-30))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def _inv(T):
    R = T[..., :3, :3].transpose(-1, -2)
    t = -(R @ T[..., :3, 3:])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    return torch.cat([top, T[..., 3:, :]], -2)


def _residual(Ts, Tt, X):
    return _log(_inv(X) @ _inv(Ts) @ Tt)


def optimize(poses, edges, X, info, uncertain, max_corr: float, preference: float,
             prune: float = 0.25, low: bool = False, dtype=torch.float64):
    """The robust LM of `global_optimization` in float64: (optimised poses
    (F, 4, 4), the edges kept (E,) bool)."""
    q = rounder(low)
    dev = poses.device
    P = poses.to(dtype)
    X = X.to(dtype)
    Lam0 = info.to(dtype)
    F = P.shape[0]
    s, t = edges[:, 0].long(), edges[:, 1].long()
    unc = uncertain.bool()
    mu = preference * max_corr ** 2 * Lam0[:, 5, 5].mean()

    def pert(d, Ts, Tt, Xe):
        # a leading axis of one: forward AD gives the product of a 0-d
        # float32 tensor and a Python float a float64 tangent
        return _residual(_exp(d[None, :6]) @ Ts[None], _exp(d[None, 6:]) @ Tt[None], Xe[None])[0]

    jac = torch.func.vmap(torch.func.jacfwd(pert), in_dims=(None, 0, 0, 0))
    conf = torch.ones(len(s), dtype=dtype, device=dev)
    lam = 1e-4
    for _ in range(100):
        w = torch.where(unc, conf, 1.0)
        Lam = Lam0 * w[:, None, None]
        r = q(_residual(P[s], P[t], X))
        J = q(jac(torch.zeros(12, dtype=dtype, device=dev), P[s], P[t], X))
        Js, Jt = J[:, :, :6], J[:, :, 6:]
        H = torch.zeros((F * 6, F * 6), dtype=dtype, device=dev)
        b = torch.zeros(F * 6, dtype=dtype, device=dev)
        for A, ia in ((Js, s), (Jt, t)):
            AL = A.transpose(1, 2) @ Lam
            b.index_add_(0, (ia[:, None] * 6 + torch.arange(6, device=dev)).reshape(-1),
                         (AL @ r[..., None])[..., 0].reshape(-1))
            for Bm, ib in ((Js, s), (Jt, t)):
                blk = AL @ Bm
                rows = ia[:, None, None] * 6 + torch.arange(6, device=dev)[None, :, None]
                cols = ib[:, None, None] * 6 + torch.arange(6, device=dev)[None, None, :]
                H.index_put_((rows.expand(blk.shape).reshape(-1), cols.expand(blk.shape)
                              .reshape(-1)), blk.reshape(-1), accumulate=True)
        cost = float(torch.einsum("ea,eab,eb->", r, Lam, r))
        Hd = H + torch.diag(lam * torch.diagonal(H) + 1e-9)
        a = torch.arange(6, device=dev)
        Hd[a, a] += 1e12
        dx = q(torch.linalg.solve(Hd, -b).reshape(F, 6))
        newP = _exp(dx) @ P
        rn = _residual(newP[s], newP[t], X)
        new_cost = float(torch.einsum("ea,eab,eb->", rn, Lam, rn))
        improved = new_cost < cost
        if improved:
            P = newP
            lam = max(lam / 3.0, 1e-7)
            r = _residual(P[s], P[t], X)
            quad = torch.einsum("ei,eij,ej->e", r, Lam0, r)
            conf = torch.where(unc, (mu / (mu + quad)) ** 2, 1.0)
        else:
            lam = min(lam * 3.0, 1e4)
        if improved and abs(cost - new_cost) / max(cost, 1e-12) < 1e-6:
            break
    return P.float(), ~unc | (conf > prune)


# --- the fragment grid and its cloud --------------------------------------------


def _pack_rgb(c):
    r = torch.clamp(torch.round(c[..., 0] * 2047.0), 0, 2047).to(torch.int32)
    g = torch.clamp(torch.round(c[..., 1] * 2047.0), 0, 2047).to(torch.int32)
    b = torch.clamp(torch.round(c[..., 2] * 1023.0), 0, 1023).to(torch.int32)
    return (r << 21) | (g << 10) | b


def _local(Bn, dev):
    r = torch.arange(Bn, dtype=torch.int32, device=dev)
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def integrate8(g: rg.Grid, depth, color, intr: rg.Intr, extr, depth_max: float,
               capacity: int = 4096, weight_max: float = 10000.0, low: bool = False):
    """Touch, activate and fuse one frame into the fragment grid. Returns
    (grid, live rows of the work list)."""
    q = rounder(low)
    keys, _ = rg.touch(g, depth, intr, extr, depth_max, capacity)
    C = g.capacity
    table, slot, ok = rg.activate(g.table, keys)
    g = g._replace(table=table)
    rows = torch.where(ok, slot, C)
    Bn = g.block_resolution
    dev = depth.device
    coords = rg.unpack_coords(keys)
    origin = coords.to(torch.float32) * (g.voxel_size * Bn)
    pw = origin[:, None, :] + _local(Bn, dev).to(torch.float32) * g.voxel_size
    pc = pw @ extr[:3, :3].T + extr[:3, 3]
    xc, yc, z = pc[..., 0], pc[..., 1], pc[..., 2]
    u = xc / torch.clamp(z, min=1e-6) * intr.fx + intr.cx
    v = yc / torch.clamp(z, min=1e-6) * intr.fy + intr.cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    W = intr.width
    inb = (z > 1e-4) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < intr.height)
    lin = torch.where(inb, vi * W + torch.clamp(ui, 0, W - 1), 0)
    d = depth.reshape(-1)[lin] / 1.0
    sdf = q(d - z)
    keep = inb & (d > 0) & (d < depth_max) & (sdf >= -g.sdf_trunc)
    tsdf_new = q(torch.clamp(sdf / g.sdf_trunc, -1.0, 1.0))
    wn = (keep & ok[:, None]).to(torch.float32)
    cnew = _pack_rgb(color).reshape(-1)[lin]

    live = (rows >= 0) & (rows < C)
    r = torch.where(live, rows, C)
    old = g.tw[r]
    old_t = (old >> 16).to(torch.float32) * (1.0 / TSDF_SCALE)
    old_w = (old & 0xFFFF).to(torch.float32)
    w_sum = old_w + wn
    upd = wn > 0
    inv = 1.0 / torch.clamp(w_sum, min=1e-6)
    t2 = q(torch.where(upd, (old_t * old_w + tsdf_new * wn) * inv, old_t))
    tq = torch.round(torch.clamp(t2, -1.0, 1.0) * TSDF_SCALE).to(torch.int32)
    new_tw = (tq << 16) | torch.clamp(w_sum, max=weight_max).to(torch.int32)
    g.tw.index_copy_(0, r, torch.where(live[:, None], new_tw, old))
    oldc = g.color[r]
    out = 0
    for shift, bits in ((21, 11), (10, 11), (0, 10)):
        top = float((1 << bits) - 1)
        mask = (1 << bits) - 1
        o = ((oldc >> shift) & mask).to(torch.float32) * (1.0 / top)
        n = ((cnew >> shift) & mask).to(torch.float32) * (1.0 / top)
        c2 = q(torch.where(upd, (o * old_w + n * wn) * inv, o))
        out = out | (torch.clamp(c2 * top + 0.5, 0, top).to(torch.int32) << shift)
    g.color.index_copy_(0, r, torch.where(live[:, None], out, oldc))
    g.tw[C] = 0
    g.color[C] = 0
    return g, rows[live]


def extract_cloud(g: rg.Grid, capacity: int, weight_threshold: float):
    """(positions (N, 3), normals (N, 3), colours (N, 3) uint8 as a PLY
    holds them) of the grid's zero crossings, in the program's order."""
    Bn = g.block_resolution
    C = g.capacity
    dev = g.tw.device
    occ = rg.occupied(g.table)
    coords = rg.unpack_coords(g.table)
    local = _local(Bn, dev)
    own = torch.arange(C, device=dev)

    def unpack(w):
        return (w >> 16).to(torch.float32) * (1.0 / TSDF_SCALE), (w & 0xFFFF).to(torch.float32)

    def nb(axis):
        e = torch.zeros(3, dtype=torch.int32, device=dev)
        e[axis] = 1
        slot, found = rg._find(g.table, rg.pack_coords(coords + e))
        nb_rows = torch.where(found & occ, slot, C)
        nxt = local + e
        inside = nxt[:, axis] < Bn
        wrapped = torch.where(inside[:, None], nxt, nxt - e * Bn)
        flat = (wrapped[:, 0] + wrapped[:, 1] * Bn + wrapped[:, 2] * Bn * Bn).to(torch.int64)
        t_in, w_in = unpack(g.tw[own[:, None], flat[None, :]])
        t_out, w_out = unpack(g.tw[nb_rows[:, None], flat[None, :]])
        return (torch.where(inside[None, :], t_in, t_out),
                torch.where(inside[None, :], w_in, w_out))

    t0, w0 = unpack(g.tw[:C])
    txs, wxs = zip(*(nb(a) for a in range(3)))
    grad = torch.stack([txs[0] - t0, txs[1] - t0, txs[2] - t0], dim=-1)
    gnorm = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-9)
    base = occ[:, None] & (w0 >= weight_threshold)
    vpos = (coords.to(torch.float32) * (g.voxel_size * Bn))[:, None, :] \
        + local.to(torch.float32)[None, :, :] * g.voxel_size
    pts, masks = [], []
    for axis in range(3):
        tn, wn = txs[axis], wxs[axis]
        cross = base & (wn >= weight_threshold) & (t0 * tn < 0)
        den = t0 - tn
        frac = torch.clamp(t0 / torch.where(torch.abs(den) > 1e-9, den, 1e-9), 0.0, 1.0)
        e = torch.zeros(3, dtype=torch.float32, device=dev)
        e[axis] = g.voxel_size
        pts.append((vpos + frac[..., None] * e).reshape(-1, 3))
        masks.append(cross.reshape(-1))
    msk = torch.cat(masks)
    idx = torch.nonzero(msk).reshape(-1)[:capacity]
    c = g.color[:C]
    rgb = torch.stack([((c >> 21) & 0x7FF).to(torch.float32) / 2047.0,
                       ((c >> 10) & 0x7FF).to(torch.float32) / 2047.0,
                       (c & 0x3FF).to(torch.float32) / 1023.0], -1).reshape(-1, 3).repeat(3, 1)
    rgb = np.clip(rgb[idx].cpu().numpy().astype(np.float64) * 255.0, 0, 255).astype(np.uint8)
    return torch.cat(pts)[idx], gnorm.reshape(-1, 3).repeat(3, 1)[idx], rgb


# --- one fragment ---------------------------------------------------------------


def fragment(frames, intr: rg.Intr, cfg: dict, low: bool = False, poses=None, work=None):
    """The fragment of the frames `frames` ([(depth, colour)] on the device,
    depth already clipped as the program reads it): {"edges", "X", "info",
    "uncertain", "kept", "poses", "positions", "normals", "colors"}. With `poses`
    ((F, 4, 4) float32 numpy), the grid is integrated at those poses (the
    run's) instead of the optimised ones; `work`, if a list, receives the
    live rows of each frame's fuse."""
    n = len(frames)
    kf = cfg["n_keyframes_per_n_frame"]
    edges, Xs, infos, unc = [], [], [], []
    odom = [np.eye(4, dtype=np.float32)]
    for i in range(n - 1):
        pairs = [i + 1] + (list(range(i + 2, min(i + kf + 1, n))) if kf > 0 and i % kf == 0
                           else [])
        for j in pairs:
            T, fit = hybrid(frames[i], frames[j], intr, low)
            if j > i + 1 and fit <= KEYFRAME_FITNESS:
                continue
            Tn = T.cpu().numpy()
            edges.append((i, j))
            Xs.append(np.linalg.inv(Tn))
            infos.append(information(frames[i][0], frames[j][0], intr, T).cpu().numpy())
            unc.append(j > i + 1)
            if j == i + 1:
                odom.append(odom[-1] @ np.linalg.inv(Tn))
    dev = frames[0][0].device
    e = torch.as_tensor(np.asarray(edges, np.int64), device=dev)
    X = torch.as_tensor(np.stack(Xs), device=dev)
    info = torch.as_tensor(np.stack(infos), device=dev)
    u = torch.as_tensor(np.asarray(unc), device=dev)
    opt, kept = optimize(torch.as_tensor(np.stack(odom), device=dev), e, X, info, u,
                         cfg["voxel_size"] * 1.4, cfg["preference_loop_closure_odometry"],
                         low=low)
    at = opt.cpu().numpy() if poses is None else poses
    g = rg.create(min(cfg["block_count"], 8192), cfg["voxel_size"] * 2,
                  cfg["trunc_voxel_multiplier"] * cfg["voxel_size"], dev, block_resolution=8)
    for i, (depth, color) in enumerate(frames):
        extr = torch.as_tensor(np.linalg.inv(at[i]), dtype=torch.float32, device=dev)
        g, live = integrate8(g, depth, color, intr, extr, cfg["depth_max"], low=low)
        if work is not None:
            work.append(int(live.numel()))
    pos, nrm, rgb = extract_cloud(g, cfg["fragment_point_capacity"], 2.0)
    return {"edges": [tuple(x) for x in edges], "X": np.stack(Xs), "info": np.stack(infos),
            "uncertain": np.asarray(unc), "kept": kept.cpu().numpy(), "poses": opt.cpu().numpy(),
            "positions": pos.cpu().numpy(), "normals": nrm.cpu().numpy(), "colors": rgb}


def as_run(frag: dict) -> dict:
    """A fragment of this file in the form `read_run` gives a run's: the
    kept edges only."""
    edges = {e: (frag["X"][k], frag["info"][k], bool(frag["uncertain"][k]))
             for k, e in enumerate(frag["edges"]) if frag["kept"][k]}
    return {"poses": frag["poses"], "edges": edges, "positions": frag["positions"],
            "normals": frag["normals"], "colors": frag["colors"]}


def read_ply(path: str) -> dict:
    """The vertex properties of a binary little-endian PLY."""
    with open(path, "rb") as f:
        names, n = [], 0
        types = {"float": "<f4", "uchar": "u1", "int": "<i4", "double": "<f8"}
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, ty, name = line.split()
                names.append((name, types[ty]))
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(), dtype=np.dtype(names), count=n)
    return {k: data[k] for k, _ in names}


def read_graph(d: dict):
    """(poses (F, 4, 4), {(s, t): (X, info, uncertain)}) of a pose-graph
    JSON dict (matrices column-major)."""
    poses = np.stack([np.asarray(nd["pose"]).reshape(4, 4, order="F") for nd in d["nodes"]])
    edges = {(e["source_node_id"], e["target_node_id"]):
             (np.asarray(e["transformation"]).reshape(4, 4, order="F"),
              np.asarray(e["information"]).reshape(6, 6, order="F"), e["uncertain"])
             for e in d["edges"]}
    return poses.astype(np.float32), edges
