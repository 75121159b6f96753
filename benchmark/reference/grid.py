"""The TSDF voxel block grid of the reference: hash, touch, integrate and
raycast of 16^3 blocks, in plain PyTorch.

Frozen from the port as of commit c976156, each part from the
plain function that the port's kernels are held bit-equal to:

- the hash table: `open3d_tpu_torch/core/hashmap.py` (`pack_coords`,
  `unpack_coords`, `_hash`, `find`, `activate`, `unique_keys`,
  `occupied_mask`, lines 54-240): packed 21-bit coordinates, a murmur3
  hash, linear probing, the claim of a free slot by the lowest pending
  index each round;
- touch: `geometry/voxel_block_grid.py:compute_unique_block_coordinates`
  (:151-189);
- integrate: `voxel_block_grid.py:integrate` (:247-327) on the 16^3 path,
  with `ops/kernels/integrate2.py:prepare_frame` (:53-64) and
  `_integrate_plain` (:73-154): the frame quantised to d21 and rgb24, the
  running means of tsdf (s1.14) and colour (R11 G11 B10), the weight capped
  at `weight_max`;
- raycast: `ops/kernels/raycast.py:build_tile_lists` (:73-172) and
  `march_tiles_plain` (:184-332): front-to-back candidate lists of 16 x 16
  pixel tiles, six samples a block chord, the crossing interpolated
  between voxel centres. With `stats`, the march returns the work it
  needed, which `counts/k2.py` turns into bytes and operations.

The layout (a (C, 2) key table, (C + 1, 4096) int32 payload rows, row C a
dump row) is the program's, so that a run's grid can be compared word for
word.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference import fma, rounder

B = 16
B3 = B ** 3
TSDF_SCALE = 16383.0
D21 = float((1 << 21) - 1)
_COORD_BITS = 21
_COORD_OFF = 1 << (_COORD_BITS - 1)
_COORD_MASK = (1 << _COORD_BITS) - 1
_U32 = 0xFFFFFFFF


class Intr(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def scaled(self, f: float) -> "Intr":
        return Intr(int(round(self.width * f)), int(round(self.height * f)),
                    self.fx * f, self.fy * f, self.cx * f, self.cy * f)


class Grid(NamedTuple):
    table: torch.Tensor  # (C, 2) int32 packed keys
    tw: torch.Tensor  # (C + 1, B^3) int32: tsdf s1.14 << 16 | weight
    color: torch.Tensor  # (C + 1, B^3) int32: R11 | G11 | B10
    voxel_size: float
    sdf_trunc: float
    block_resolution: int = B

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def create(block_count: int, voxel_size: float, sdf_trunc: float, device,
           block_resolution: int = B) -> Grid:
    C = block_count
    n = block_resolution ** 3
    return Grid(torch.zeros((C, 2), dtype=torch.int32, device=device),
                torch.zeros((C + 1, n), dtype=torch.int32, device=device),
                torch.zeros((C + 1, n), dtype=torch.int32, device=device),
                float(voxel_size), float(sdf_trunc), block_resolution)


# --- the hash table ---------------------------------------------------------


def _u32(x):
    return x.to(torch.int64) & _U32


def _i32(x):
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _mul32(a, c: int):
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def is_valid(keys):
    return (keys[..., 1] & 1) == 1


def pack_coords(coords):
    c = torch.clamp(coords.to(torch.int64) + _COORD_OFF, 0, _COORD_MASK)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([_i32((x << 11) | (y >> 10)), _i32(((y & 0x3FF) << 22) | (z << 1) | 1)],
                       dim=-1)


def unpack_coords(keys):
    w0 = _u32(keys[..., 0])
    w1 = _u32(keys[..., 1])
    x = (w0 >> 11) & _COORD_MASK
    y = ((w0 & 0x7FF) << 10) | ((w1 >> 22) & 0x3FF)
    z = (w1 >> 1) & _COORD_MASK
    return (torch.stack([x, y, z], dim=-1) - _COORD_OFF).to(torch.int32)


def _home(keys, C: int):
    x = _u32(keys[..., 0]) ^ _mul32(_u32(keys[..., 1]), 0x9E3779B1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x % C


def _find(table, query, max_probes: int = 32):
    C = table.shape[0]
    h = _home(query, C)
    q0, q1 = query[..., 0], query[..., 1]
    valid_q = is_valid(query)
    slot = torch.full(q0.shape, -1, dtype=torch.int64, device=query.device)
    found = torch.zeros(q0.shape, dtype=torch.bool, device=query.device)
    dead = ~valid_q
    for p in range(max_probes):
        if bool((found | dead).all()):
            break
        s = (h + p) % C
        cur = table[s]
        hit = (cur[..., 0] == q0) & (cur[..., 1] == q1) & ~found & ~dead
        slot = torch.where(hit, s, slot)
        found = found | hit
        dead = dead | (cur[..., 1] == 0)
    return slot, found & valid_q


def activate(table, keys, max_probes: int = 32, max_rounds: int = 16):
    """Insert the unique valid keys not yet present. Returns (table, slot
    (N,) int64, ok (N,) bool)."""
    C = table.shape[0]
    N = keys.shape[0]
    dev = keys.device
    h = _home(keys, C)
    k0, k1 = keys[..., 0], keys[..., 1]
    ids = torch.arange(N, dtype=torch.int64, device=dev)
    big = N + 1
    slot, found0 = _find(table, keys, max_probes)
    done = found0 | ~is_valid(keys)
    p = torch.zeros(N, dtype=torch.int64, device=dev)
    ext = torch.cat([table, table.new_zeros((1, 2))])
    for _ in range(max_rounds):
        if bool(done.all()):
            break
        s = (h + p) % C
        cur = ext[s]
        hit = (cur[..., 0] == k0) & (cur[..., 1] == k1) & ~done
        slot = torch.where(hit, s, slot)
        done = done | hit
        free = ((cur[..., 1] & 1) == 0) & ~done
        claim = torch.full((C + 1,), big, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(free, s, C), torch.where(free, ids, big), "amin")
        win = free & (claim[s] == ids)
        dst = torch.where(win, s, C)
        ext.index_copy_(0, dst, torch.where(win[:, None], keys, 0))
        ext[C] = 0
        slot = torch.where(win, s, slot)
        done = done | win
        p = p + (~done & ((cur[..., 1] & 1) == 1) & ~hit).to(torch.int64)
    return ext[:C].contiguous(), slot, done & is_valid(keys)


def unique_keys(keys, capacity: int):
    """(unique (capacity, 2) int32 invalid-padded, count before the clamp)."""
    N = keys.shape[0]
    if N < capacity:
        keys = torch.cat([keys, keys.new_zeros((capacity - N, 2))])
    ok = is_valid(keys)
    w0 = torch.where(ok, keys[..., 0], 0x7FFFFFFF).to(torch.int64)
    w1 = torch.where(ok, keys[..., 1], 0x7FFFFFFE).to(torch.int64)
    k = (w0 << 32) + (w1 + (1 << 31))
    s, _ = torch.sort(k, stable=True)
    sval = (((s & _U32) - (1 << 31)) & 1) == 1
    first = torch.ones_like(sval)
    first[1:] = s[1:] != s[:-1]
    first = first & sval
    count = int(first.sum())
    _, order = torch.sort((~first).to(torch.int8), stable=True)
    out = s[order[:capacity]]
    out = torch.stack([(out >> 32).to(torch.int32), ((out & _U32) - (1 << 31)).to(torch.int32)],
                      dim=-1)
    live = torch.arange(capacity, device=keys.device) < count
    return torch.where(live[:, None], out, 0), count


def occupied(table):
    return (table[..., 1] & 1) == 1


# --- touch and integrate ----------------------------------------------------


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """World -> camera from frame -> world, computed as the program's step
    computes it (`core/lie.py:invert_se3`, :137-142), so that the two sides
    project with the same float32 extrinsic."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    tt = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, tt[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def touch(grid: Grid, depth, intr: Intr, extrinsic, depth_max: float, capacity: int,
          low: bool = False, stride: int = 4):
    """Packed keys of the blocks within sdf_trunc of the depth surface, from
    every `stride`-th pixel. Returns (keys (capacity, 2), count before the
    clamp)."""
    q = rounder(low)
    d = depth[::stride, ::stride]
    H, W = d.shape
    dev = depth.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) * stride)[None, :]
    v = (torch.arange(H, dtype=torch.float32, device=dev) * stride)[:, None]
    valid = (d > 0) & (d < depth_max)
    x = ((u - intr.cx) / intr.fx).expand(H, W)
    y = ((v - intr.cy) / intr.fy).expand(H, W)
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    R = extrinsic[:3, :3]
    cam_origin = -R.T @ extrinsic[:3, 3]
    bs = grid.voxel_size * grid.block_resolution
    n_steps = max(int(2.0 * grid.sdf_trunc / bs + 0.5) + 2, 2)
    zs = torch.linspace(-grid.sdf_trunc, grid.sdf_trunc, n_steps, dtype=torch.float32, device=dev)
    keys_all = []
    for i in range(n_steps):
        z = d + zs[i]
        p_world = q((ray * z[..., None]).reshape(-1, 3) @ R + cam_origin)
        keys = pack_coords(torch.floor(p_world / bs).to(torch.int32))
        ok = valid.reshape(-1) & (z > 0).reshape(-1)
        keys_all.append(torch.where(ok[:, None], keys, 0))
    return unique_keys(torch.cat(keys_all), capacity)


def integrate(grid: Grid, keys, depth, color, intr: Intr, extrinsic, depth_max: float,
              weight_max: float = 10000.0, low: bool = False):
    """Activate the touched 16^3 blocks and fuse the frame into their rows
    (the fused integrate K1's function).
    Returns (grid with the new table, live rows (L,) int64, blocks dropped:
    valid keys that found no slot)."""
    q = rounder(low)
    C = grid.capacity
    table, slot, ok = activate(grid.table, keys)
    dropped = int((is_valid(keys) & ~ok).sum())
    grid = grid._replace(table=table)
    live = torch.nonzero(ok).reshape(-1)
    rows = slot[live]
    coords = unpack_coords(keys[live])
    dev = depth.device
    H, W = depth.shape

    okd = (depth > 0) & torch.isfinite(depth)
    d21 = torch.where(okd, torch.floor(torch.clamp(depth, 0.0, depth_max) * (D21 / depth_max)),
                      0.0).to(torch.int32).reshape(-1)
    c8 = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)
    rgb24 = ((c8[..., 0] << 16) | (c8[..., 1] << 8) | c8[..., 2]).reshape(-1)

    E = extrinsic.to(torch.float32)
    R00, R01, R02, tX = E[0, 0], E[0, 1], E[0, 2], E[0, 3]
    R10, R11, R12, tY = E[1, 0], E[1, 1], E[1, 2], E[1, 3]
    R20, R21, R22, tZ = E[2, 0], E[2, 1], E[2, 2], E[2, 3]
    f = torch.arange(B3, device=dev)
    lx = (f & 15).to(torch.float32)[None, :]
    ly = ((f >> 4) & 15).to(torch.float32)[None, :]
    lz = (f >> 8).to(torch.float32)[None, :]
    vs = grid.voxel_size
    bs = vs * B
    M = coords.shape[0]
    pwx = fma(lx.expand(M, B3), vs, (coords[:, 0].to(torch.float32) * bs)[:, None])
    pwy = fma(ly.expand(M, B3), vs, (coords[:, 1].to(torch.float32) * bs)[:, None])
    pwz = fma(lz.expand(M, B3), vs, (coords[:, 2].to(torch.float32) * bs)[:, None])
    pcx = q(fma(R00, pwx, R01 * pwy) + R02 * pwz + tX)
    pcy = q(fma(R10, pwx, R11 * pwy) + R12 * pwz + tY)
    pcz = q(fma(R20, pwx, R21 * pwy) + R22 * pwz + tZ)
    zc = torch.clamp(pcz, min=1e-6)
    ui = torch.round(fma(pcx / zc, intr.fx, intr.cx)).to(torch.int64)
    vi = torch.round(fma(pcy / zc, intr.fy, intr.cy)).to(torch.int64)
    inb = (pcz > 1e-4) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    lin = torch.where(inb, vi * W + ui, 0)
    d = torch.where(inb, d21[lin], 0).to(torch.float32) * (depth_max / D21)
    sdf = q(d - pcz)
    keep = (d > 0) & (d < depth_max) & (sdf >= -grid.sdf_trunc)
    tsdf_new = q(torch.clamp(sdf * (1.0 / grid.sdf_trunc), -1.0, 1.0))
    w_n = keep.to(torch.float32)

    old = grid.tw[rows]
    old_t = (old >> 16).to(torch.float32) * (1.0 / TSDF_SCALE)
    old_w = (old & 0xFFFF).to(torch.float32)
    w_sum = old_w + w_n
    inv = 1.0 / torch.clamp(w_sum, min=1e-6)
    upd = w_n > 0
    t_new = torch.where(keep, tsdf_new, 0.0)
    t2 = q(torch.where(upd, fma(old_t, old_w, t_new * w_n) * inv, old_t))
    w2 = torch.clamp(w_sum, max=weight_max)
    tq = torch.round(torch.clamp(t2, -1.0, 1.0) * TSDF_SCALE).to(torch.int32)
    grid.tw.index_copy_(0, rows, (tq << 16) | w2.to(torch.int32))

    oldc = grid.color[rows]
    cq = torch.where(inb, rgb24[lin], 0)
    new_c = 0
    for shift, bits in ((21, 11), (10, 11), (0, 10)):
        top = float((1 << bits) - 1)
        co = ((oldc >> shift) & ((1 << bits) - 1)).to(torch.float32) * (1.0 / top)
        cn = ((cq >> {21: 16, 10: 8, 0: 0}[shift]) & 0xFF).to(torch.float32) * (1.0 / 255.0)
        cn = torch.where(keep, cn, 0.0)
        c2 = q(torch.where(upd, fma(co, old_w, cn * w_n) * inv, co))
        new_c = new_c | (torch.clamp(fma(c2, top, 0.5), 0, top).to(torch.int32) << shift)
    grid.color.index_copy_(0, rows, new_c)
    return grid, rows, dropped


# --- raycast ----------------------------------------------------------------


def _corner_offsets(device):
    return torch.tensor([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                        dtype=torch.float32, device=device)


def tile_lists(grid: Grid, intr: Intr, extrinsic, depth_min: float, depth_max: float,
               tile: int = 16, K: int = 24, G: int = 8, visible_capacity: int = 4096):
    """(rows (T K + G,) int64 with no block mapped to the dump row C, coords
    (T K + G, 3), nk (T,), n_extra): per-tile candidate blocks front to back,
    then the blocks that straddle the camera plane."""
    TH, TW = -(-intr.height // tile), -(-intr.width // tile)
    T = TH * TW
    bs = grid.voxel_size * B
    dev = grid.table.device
    R = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    corners = _corner_offsets(dev) * bs

    def project(coords):
        c = coords.to(torch.float32)[:, None, :].expand(-1, 8, 3)
        pc = fma(c, bs, corners) @ R.T + t
        z = pc[..., 2]
        zs = torch.clamp(z, min=1e-6)
        return z, pc[..., 0] / zs * intr.fx + intr.cx, pc[..., 1] / zs * intr.fy + intr.cy

    def on_image(u, v):
        return ((u.amax(-1) >= 0) & (u.amin(-1) < intr.width)
                & (v.amax(-1) >= 0) & (v.amin(-1) < intr.height))

    occ = occupied(grid.table)
    z_all, u_all, v_all = project(unpack_coords(grid.table))
    vis_all = occ & (z_all.amax(-1) > depth_min) & (z_all.amin(-1) < depth_max)
    vis_all = vis_all & (on_image(u_all, v_all) | ~(z_all > 1e-4).all(-1))
    A = visible_capacity
    _, order = torch.sort((~vis_all).to(torch.int8), stable=True)
    n_vis = int(vis_all.sum())
    idx = order[:A] if A <= order.numel() else torch.cat([order, order.new_full(
        (A - order.numel(),), order.numel() - 1)])
    slots = torch.where(torch.arange(A, device=dev) < min(n_vis, A), idx, -1)
    live = slots >= 0
    coords = unpack_coords(grid.table[torch.clamp(slots, min=0)])
    z, u, v = project(coords)
    front = (z > 1e-4).all(-1)
    z0 = z.amin(-1)
    z1 = z.amax(-1)
    vis = live & (z1 > depth_min) & (z0 < depth_max)
    tu0 = torch.clamp(torch.floor(u.amin(-1) / tile), 0, TW - 1).to(torch.int32)
    tu1 = torch.clamp(torch.floor(u.amax(-1) / tile), 0, TW - 1).to(torch.int32)
    tv0 = torch.clamp(torch.floor(v.amin(-1) / tile), 0, TH - 1).to(torch.int32)
    tv1 = torch.clamp(torch.floor(v.amax(-1) / tile), 0, TH - 1).to(torch.int32)
    ok = vis & on_image(u, v) & front
    extra = vis & ~front & (z1 > 0)
    t_iota = torch.arange(T, dtype=torch.int32, device=dev)
    tx = (t_iota % TW)[:, None]
    ty = (t_iota // TW)[:, None]
    inside = (ok[None, :] & (tx >= tu0[None, :]) & (tx <= tu1[None, :])
              & (ty >= tv0[None, :]) & (ty <= tv1[None, :]))
    score = torch.where(inside, -z0[None, :], torch.tensor(-3.4e38, device=dev))
    top_vals, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :K], top_idx[:, :K]
    validk = top_vals > -3.3e38
    nk = validk.to(torch.int64).sum(1)
    rows_tk = torch.where(validk, slots[top_idx], -1)
    _, eorder = torch.sort((~extra).to(torch.int8), stable=True)
    n_extra = min(int(extra.sum()), G)
    eidx = eorder[:G] if G <= eorder.numel() else torch.cat(
        [eorder, eorder.new_full((G - eorder.numel(),), eorder.numel() - 1)])
    erows = torch.where(torch.arange(G, device=dev) < n_extra, slots[eidx], -1)
    rows_all = torch.cat([rows_tk.reshape(-1), erows])
    coords_all = unpack_coords(grid.table[torch.clamp(rows_all, min=0)])
    C = grid.capacity
    return torch.where(rows_all >= 0, rows_all, C), coords_all, nk, n_extra


def march(grid: Grid, rows, coords, nk, n_extra: int, intr: Intr, extrinsic, depth_min: float,
          depth_max: float, tile: int = 16, K: int = 24, M: int = 6, low: bool = False,
          stats: Optional[dict] = None):
    """The (H, W) hit depth, 0 for a miss. With `stats`, also the work the
    march needs on these inputs: "sectors_sampled", the distinct 32-byte
    sectors its in-block samples read; "pairs_visited", the (tile, block)
    steps; "ray_blocks", the (ray, block) chords sampled; "crossings"."""
    q = rounder(low)
    dev = grid.tw.device
    H, W = intr.height, intr.width
    TH, TW = -(-H // tile), -(-W // tile)
    T = TH * TW
    NR = tile * tile
    vs = grid.voxel_size
    bs = vs * B
    inv_vs = 1.0 / vs
    R = extrinsic[:3, :3]
    origin = -R.T @ extrinsic[:3, 3]
    p = torch.cat([R.T.reshape(-1), origin])
    t_ids = torch.arange(T, device=dev)
    rid = torch.arange(NR, device=dev)
    uf = ((t_ids % TW) * tile)[:, None] + (rid % tile)[None, :]
    vf = ((t_ids // TW) * tile)[:, None] + (rid // tile)[None, :]
    x = (uf.to(torch.float32) - intr.cx) * (1.0 / intr.fx)
    y = (vf.to(torch.float32) - intr.cy) * (1.0 / intr.fy)
    dX = q(fma(p[0], x, p[1] * y) + p[2])
    dY = q(fma(p[3], x, p[4] * y) + p[5])
    dZ = q(fma(p[6], x, p[7] * y) + p[8])
    oX, oY, oZ = p[9], p[10], p[11]
    d2 = fma(dZ, dZ, fma(dX, dX, dY * dY))

    big = 1e9
    zhit = torch.full((T, NR), big, dtype=torch.float32, device=dev)
    pv = torch.ones((T, NR), dtype=torch.float32, device=dev)
    pz = torch.zeros((T, NR), dtype=torch.float32, device=dev)
    nk_tot = nk + n_extra
    k_max = int(nk_tot.max()) if T > 0 else 0
    TK = T * K
    mio = torch.arange(M, dtype=torch.float32, device=dev)
    sectors = []
    counts = torch.zeros(3, dtype=torch.int64, device=dev)

    def axis_rng(o, d, b):
        dd = torch.where(torch.abs(d) > 1e-9, d, 1e-9)
        t1 = fma(b, bs, -o) / dd
        t2 = (fma(b, bs, bs) - o) / dd
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    for k in range(k_max):
        going = (k < nk_tot) & ~(zhit < big).all(1)
        if not bool(going.any()):
            break
        idx = TK + k if k < n_extra else t_ids * K + (k - n_extra)
        idx = torch.clamp(torch.as_tensor(idx, device=dev).expand(T), max=rows.shape[0] - 1)
        row = rows[idx]
        c = coords[idx]
        bxi, byi, bzi = [(c[:, j] * B)[:, None] for j in range(3)]
        bx, by, bz = [c[:, j].to(torch.float32)[:, None].expand(T, NR) for j in range(3)]
        ax0, ax1 = axis_rng(oX, dX, bx)
        ay0, ay1 = axis_rng(oY, dY, by)
        az0, az1 = axis_rng(oZ, dZ, bz)
        t_in = torch.maximum(torch.maximum(ax0, ay0), torch.clamp(az0, min=depth_min))
        t_out = torch.minimum(torch.minimum(ax1, ay1), torch.clamp(az1, max=depth_max))
        step = (t_out - t_in) * (1.0 / M)
        has = (t_out > t_in) & going[:, None]
        zm = q(fma((mio + 0.5).expand(T, NR, M), step[..., None], t_in[..., None]))
        lx = torch.floor(fma(dX[..., None], zm, oX) * inv_vs).to(torch.int32) - bxi[..., None]
        ly = torch.floor(fma(dY[..., None], zm, oY) * inv_vs).to(torch.int32) - byi[..., None]
        lz = torch.floor(fma(dZ[..., None], zm, oZ) * inv_vs).to(torch.int32) - bzi[..., None]
        inb = (lx >= 0) & (lx < B) & (ly >= 0) & (ly < B) & (lz >= 0) & (lz < B)
        flat = (torch.clamp(lx, 0, B - 1) + torch.clamp(ly, 0, B - 1) * B
                + torch.clamp(lz, 0, B - 1) * (B * B)).to(torch.int64)
        blk = grid.tw[row]
        plane = torch.where((blk & 0xFFFF) > 0, (blk >> 16).to(torch.float32) * (1.0 / TSDF_SCALE),
                            2.0)
        vals = torch.gather(plane, 1, flat.reshape(T, -1)).reshape(T, NR, M)
        cxw = fma((bxi[..., None] + lx).to(torch.float32), vs, 0.5 * vs)
        cyw = fma((byi[..., None] + ly).to(torch.float32), vs, 0.5 * vs)
        czw = fma((bzi[..., None] + lz).to(torch.float32), vs, 0.5 * vs)
        num = fma(czw - oZ, dZ[..., None], fma(cxw - oX, dX[..., None], (cyw - oY) * dY[..., None]))
        zv = torch.where(inb, q(num / torch.clamp(d2, min=1e-12)[..., None]), zm)
        ok = has[..., None] & inb & (vals < 1.5)
        v_eff = torch.where(ok, vals, 1.0)
        contig = torch.abs(t_in - pz) <= torch.clamp(step, min=2.0 * vs)
        vprev0 = torch.where(contig, pv, 1.0)
        zprev0 = torch.where(contig, pz, t_in)
        vprev = torch.cat([vprev0[..., None], v_eff[..., : M - 1]], dim=-1)
        zprev = torch.cat([zprev0[..., None], zm[..., : M - 1]], dim=-1)
        zvprev = torch.cat([zprev0[..., None], zv[..., : M - 1]], dim=-1)
        cross = (vprev > 0) & (v_eff <= 0) & ok & (zm > zprev)
        zc = q(fma(vprev / torch.clamp(vprev - v_eff, min=1e-6), zv - zvprev, zvprev))
        zc = torch.minimum(torch.maximum(zc, torch.minimum(zprev, zm)), torch.maximum(zprev, zm))
        zhit = torch.minimum(zhit, torch.where(cross, zc, big).amin(-1))
        if stats is not None:
            counts += torch.stack([going.sum(), has.sum(), cross.sum()])
            read = has[..., None] & inb
            sec = row[:, None, None] * (B3 // 8) + flat // 8
            sectors.append(torch.unique(sec[read]))
        pv = torch.where(has, torch.where(ok[..., M - 1], vals[..., M - 1], 1.0), pv)
        pz = torch.where(has, torch.maximum(zm[..., M - 1], pz), pz)

    if stats is not None:
        secs = torch.cat(sectors) if sectors else torch.zeros(0, dtype=torch.int64, device=dev)
        stats["sectors_sampled"] = int(torch.unique(secs).numel())
        stats.update(zip(("pairs_visited", "ray_blocks", "crossings"), counts.tolist()))
        stats["list_entries"] = int(rows.numel())
        stats["tiles"] = T
    zhit = torch.where(zhit < big, zhit, 0.0)
    img = zhit.reshape(TH, TW, tile, tile).permute(0, 2, 1, 3).reshape(TH * tile, TW * tile)
    return img[:H, :W].contiguous()


def raycast(grid: Grid, intr: Intr, extrinsic, depth_min: float, depth_max: float,
            low: bool = False, stats: Optional[dict] = None):
    rows, coords, nk, n_extra = tile_lists(grid, intr, extrinsic, depth_min, depth_max)
    return march(grid, rows, coords, nk, n_extra, intr, extrinsic, depth_min, depth_max,
                 low=low, stats=stats)
