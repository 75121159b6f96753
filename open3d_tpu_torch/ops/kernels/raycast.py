"""Raycast of the sparse TSDF grid by per-tile block lists and a tile
march (port of open3d_tpu/ops/pallas/raycast.py).

Pass 1, `build_tile_lists`, is plain PyTorch (XLA in the JAX package): for
every 16x16-pixel tile, the payload rows of at most K blocks whose
projected bounding box covers it, front to back, plus a short global list
of "extras" that straddle the camera plane.

Pass 2, `march_tiles`, launches the CUDA kernel in `csrc/raycast.cu` for
CUDA tensors and runs `march_tiles_plain` for CPU tensors; a CUDA tensor
never falls back.

Replaces: open3d_tpu/ops/pallas/raycast.py:_march_kernel.
Bound: the larger of bytes and float32 operations. The march's function
reads only the payload words its samples touch before the tile's break:
the distinct 32-byte sectors of those samples (`stats["sectors_sampled"]`;
most are served by L1 and L2, as neighbouring rays and tiles share
voxels), the candidate entries walked, and 4 bytes a ray written. Its
operations are the ray directions, the chords of every (tile, block)
step, the samples of every ray that meets a block and the interpolation
of every crossing. chip_smoke.py counts both on the bench frame.

Design: one CTA marches one tile, one thread a ray, with no barrier per
block. The tile's candidate list is staged in shared memory once; each
thread walks it alone, issuing the loads of the next block its ray meets
before it consumes the current one, and loads only the words it samples.
The plain version's break ("every ray has a hit") falls after k*, the
largest first-hit candidate of the tile's rays: a ray reports its first
hit and walks on, keeping one speculative lowering of its hit past the
largest first hit reported so far (put back if it lies past k*); rays
that stop short of k* walk on to it after the one barrier. So the result
is the plain version's, bit for bit. Divisions by a per-ray value are
float64 products with its reciprocal, which round to the same float32.

Rounding: multiply-adds are fused (fmaf in the kernel, `_plain.fma` in the
plain version) exactly where XLA's CPU backend fuses them in the
interpreted JAX kernel, the reference of the CPU tests: the ray direction,
the chord bounds, the sample positions, the voxel centres and their ray
parameters, and the crossing interpolation. Nowhere else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core.masking import compact_indices
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels._plain import fma
from open3d_tpu_torch.utils.timer import host_read, span

_TSDF_SCALE = 16383.0
_SENTINEL = 2.0  # value of an unallocated voxel (tsdf is in [-1, 1])
_BIG = 1e9


class TileLists(NamedTuple):
    rows: torch.Tensor  # (T*K + G,) int32 payload rows; [T*K:] = extras; -1 = none
    coords: torch.Tensor  # (T*K + G, 3) int32 block coords (same order)
    nk: torch.Tensor  # (T,) int32 per-tile candidate count (<= K)
    n_extra: torch.Tensor  # (1,) int32 number of extras
    overflow: torch.Tensor  # () int32 candidates dropped by the caps (stat)


def _corner_offsets(device) -> torch.Tensor:
    return torch.tensor(
        [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
        dtype=torch.float32, device=device,
    )


def build_tile_lists(
    vbg,
    intrinsic,
    extrinsic: torch.Tensor,
    depth_min: float,
    depth_max: float,
    tile: int = 16,
    K: int = 24,
    G: int = 8,
    visible_capacity: int = 4096,
) -> TileLists:
    """Pass 1: per-tile depth-sorted candidate block lists.

    lax.top_k(score, K) becomes a stable descending sort, which breaks ties
    by the lower block index as top_k does: axis-aligned cameras give equal
    entry depths, and list order changes the march's carry and its break."""
    with span("raycast.tile_lists"):
        TH = -(-intrinsic.height // tile)
        TW = -(-intrinsic.width // tile)
        T = TH * TW
        bs = vbg.block_size
        dev = vbg.table.device
        E = extrinsic.to(device=dev, dtype=torch.float32)
        R = E[:3, :3]
        t = E[:3, 3]
        corners = _corner_offsets(dev) * bs  # (8, 3)

        def project(coords):
            c = coords.to(torch.float32)[:, None, :].expand(-1, 8, 3)
            pw = fma(c, bs, corners)
            pc = pw @ R.T + t  # (N, 8, 3)
            z = pc[..., 2]
            zs = torch.clamp(z, min=1e-6)
            u = pc[..., 0] / zs * intrinsic.fx + intrinsic.cx
            v = pc[..., 1] / zs * intrinsic.fy + intrinsic.cy
            return z, u, v

        def on_image(u, v):
            return (
                (u.amax(-1) >= 0) & (u.amin(-1) < intrinsic.width)
                & (v.amax(-1) >= 0) & (v.amin(-1) < intrinsic.height)
            )

        # visibility over all slots
        occ = hm.occupied_mask(vbg.table)
        z_all, u_all, v_all = project(hm.unpack_coords(vbg.table))
        vis_all = occ & (z_all.amax(-1) > depth_min) & (z_all.amin(-1) < depth_max)
        front_all = (z_all > 1e-4).all(-1)
        vis_all = vis_all & (on_image(u_all, v_all) | ~front_all)

        A = visible_capacity
        vidx, vcount = compact_indices(vis_all, A)
        vis_overflow = torch.clamp(vcount - A, min=0)
        slots = torch.where(torch.arange(A, device=dev) < torch.clamp(vcount, max=A), vidx, -1)
        live = slots >= 0
        coords = hm.unpack_coords(vbg.table[torch.clamp(slots, min=0).long()])
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
        extra_mask = vis & ~front & (z1 > 0)

        # dense (T, A) overlap: tile (ty, tx) intersects the block's bbox
        t_iota = torch.arange(T, dtype=torch.int32, device=dev)
        tx = (t_iota % TW)[:, None]
        ty = (t_iota // TW)[:, None]
        inside = (
            ok[None, :]
            & (tx >= tu0[None, :]) & (tx <= tu1[None, :])
            & (ty >= tv0[None, :]) & (ty <= tv1[None, :])
        )
        score = torch.where(inside, -z0[None, :], torch.tensor(-3.4e38, device=dev))
        top_vals, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
        top_vals, top_idx = top_vals[:, :K], top_idx[:, :K]
        validk = top_vals > -3.3e38
        nk = validk.to(torch.int32).sum(1).to(torch.int32)
        counts = inside.to(torch.int32).sum(1)
        overflow = torch.clamp(counts - K, min=0).sum() + vis_overflow
        rows_tk = torch.where(validk, slots[top_idx], -1).to(torch.int32)

        eidx, ecount = compact_indices(extra_mask, G)
        n_extra = torch.clamp(ecount, max=G).to(torch.int32)
        evalid = torch.arange(G, device=dev) < n_extra
        erows = torch.where(evalid, slots[torch.clamp(eidx, min=0).long()], -1).to(torch.int32)

        rows_all = torch.cat([rows_tk.reshape(-1), erows])
        coords_all = hm.unpack_coords(vbg.table[torch.clamp(rows_all, min=0).long()])
        return TileLists(
            rows=rows_all.contiguous(),
            coords=coords_all.to(torch.int32).contiguous(),
            nk=nk.contiguous(),
            n_extra=n_extra.reshape(1).contiguous(),
            overflow=overflow.to(torch.int32),
        )


def _march_params(extrinsic: torch.Tensor, device) -> torch.Tensor:
    """(12,) float32: R^T row-major (world direction per unit camera z),
    then the camera origin in the world."""
    E = extrinsic.to(device=device, dtype=torch.float32)
    R = E[:3, :3]
    origin = -R.T @ E[:3, 3]
    return torch.cat([R.T.reshape(-1), origin]).contiguous()


def march_tiles_plain(
    tw: torch.Tensor,
    rows: torch.Tensor,
    coords: torch.Tensor,
    nk: torch.Tensor,
    n_extra: torch.Tensor,
    intrinsic,
    extrinsic: torch.Tensor,
    voxel_size: float,
    depth_min: float,
    depth_max: float,
    tile: int = 16,
    K: int = 24,
    M: int = 6,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """The march kernel's function in plain PyTorch, vectorised over
    (T, 256) rays. Loops k up to max(nk + n_extra) with a per-tile
    "still marching" mask that reproduces the kernel's break (a tile stops
    once every one of its rays, in the image or not, has a hit).
    `rows` must already map "no block" to the dump row C.
    Returns the (H, W) hit depth, 0 for a miss. If `stats` is a dict, it
    receives the work the function needs on this data, which the kernel's
    bound counts: "rows_marched", the distinct payload rows that some ray
    samples; "sectors_sampled", the distinct 32-byte sectors (8 payload
    words) that the in-block samples of rays meeting a block read;
    "pairs_visited", the (tile, block) steps taken (each computes the
    chords of all the tile's rays); "ray_blocks", the (ray, block) chords
    that were sampled; "crossings", the samples that cross the surface
    (each interpolates a hit); "tile_steps", a (T,) tensor of the
    candidates each tile walks before its break."""
    dev = tw.device
    C1 = tw.shape[0]
    H, W = intrinsic.height, intrinsic.width
    TH, TW = -(-H // tile), -(-W // tile)
    T = TH * TW
    NR = tile * tile
    B = 16
    bs = voxel_size * B
    inv_vs = 1.0 / voxel_size
    tw2 = tw.view(C1, B * B * B)

    p = _march_params(extrinsic, dev)
    t_ids = torch.arange(T, device=dev)
    rid = torch.arange(NR, device=dev)
    uf = ((t_ids % TW) * tile)[:, None] + (rid % tile)[None, :]
    vf = ((t_ids // TW) * tile)[:, None] + (rid // tile)[None, :]
    x = (uf.to(torch.float32) - intrinsic.cx) * (1.0 / intrinsic.fx)
    y = (vf.to(torch.float32) - intrinsic.cy) * (1.0 / intrinsic.fy)
    dX = fma(p[0], x, p[1] * y) + p[2]
    dY = fma(p[3], x, p[4] * y) + p[5]
    dZ = fma(p[6], x, p[7] * y) + p[8]
    oX, oY, oZ = p[9], p[10], p[11]
    d2 = fma(dZ, dZ, fma(dX, dX, dY * dY))

    zhit = torch.full((T, NR), _BIG, dtype=torch.float32, device=dev)
    pv = torch.ones((T, NR), dtype=torch.float32, device=dev)
    pz = torch.zeros((T, NR), dtype=torch.float32, device=dev)
    nex = host_read("march_plain.n_extra", n_extra[0])
    nk_tot = nk.to(torch.int64) + nex
    k_max = host_read("march_plain.k_max", nk_tot.max()) if T > 0 else 0
    TK = T * K
    mio = torch.arange(M, dtype=torch.float32, device=dev)
    marched, sectors = [], []
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    tile_steps = torch.zeros(T, dtype=torch.int64, device=dev)

    def axis_rng(o, d, b):
        # b: (T, 1) block coordinate as float; the chord [b bs, b bs + bs]
        dd = torch.where(torch.abs(d) > 1e-9, d, 1e-9)
        t1 = fma(b, bs, -o) / dd
        t2 = (fma(b, bs, bs) - o) / dd
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    for k in range(k_max):
        going = (k < nk_tot) & ~(zhit < _BIG).all(1)  # (T,)
        if not host_read("march_plain.going", going.any()):
            break
        idx = TK + k if k < nex else t_ids * K + (k - nex)
        idx = torch.clamp(torch.as_tensor(idx, device=dev).expand(T), max=rows.shape[0] - 1)
        row = rows[idx].to(torch.int64)  # (T,)
        c = coords[idx]  # (T, 3)
        bxi, byi, bzi = [(c[:, j] * B)[:, None] for j in range(3)]
        bx, by, bz = [c[:, j].to(torch.float32)[:, None].expand(T, NR) for j in range(3)]
        ax0, ax1 = axis_rng(oX, dX, bx)
        ay0, ay1 = axis_rng(oY, dY, by)
        az0, az1 = axis_rng(oZ, dZ, bz)
        t_in = torch.maximum(torch.maximum(ax0, ay0), torch.clamp(az0, min=depth_min))
        t_out = torch.minimum(torch.minimum(ax1, ay1), torch.clamp(az1, max=depth_max))
        step = (t_out - t_in) * (1.0 / M)
        has = (t_out > t_in) & going[:, None]
        if stats is not None:
            marched.append(row[has.any(1)])

        shape = (T, NR, M)
        zm = fma((mio + 0.5).expand(shape), step[..., None], t_in[..., None])  # (T, NR, M)
        lx = torch.floor(fma(dX[..., None], zm, oX) * inv_vs).to(torch.int32) - bxi[..., None]
        ly = torch.floor(fma(dY[..., None], zm, oY) * inv_vs).to(torch.int32) - byi[..., None]
        lz = torch.floor(fma(dZ[..., None], zm, oZ) * inv_vs).to(torch.int32) - bzi[..., None]
        inb = (lx >= 0) & (lx < B) & (ly >= 0) & (ly < B) & (lz >= 0) & (lz < B)
        flat = (
            torch.clamp(lx, 0, B - 1) + torch.clamp(ly, 0, B - 1) * B
            + torch.clamp(lz, 0, B - 1) * (B * B)
        ).to(torch.int64)
        blk = tw2[row]  # (T, 4096)
        plane = torch.where(
            (blk & 0xFFFF) > 0, (blk >> 16).to(torch.float32) * (1.0 / _TSDF_SCALE), _SENTINEL
        )
        vals = torch.gather(plane, 1, flat.reshape(T, -1)).reshape(T, NR, M)

        cxw = fma((bxi[..., None] + lx).to(torch.float32), voxel_size, 0.5 * voxel_size)
        cyw = fma((byi[..., None] + ly).to(torch.float32), voxel_size, 0.5 * voxel_size)
        czw = fma((bzi[..., None] + lz).to(torch.float32), voxel_size, 0.5 * voxel_size)
        num = fma(czw - oZ, dZ[..., None], fma(cxw - oX, dX[..., None], (cyw - oY) * dY[..., None]))
        z_vox = num / torch.clamp(d2, min=1e-12)[..., None]
        zv = torch.where(inb, z_vox, zm)

        ok = has[..., None] & inb & (vals < 1.5)
        v_eff = torch.where(ok, vals, 1.0)
        contig = torch.abs(t_in - pz) <= torch.clamp(step, min=2.0 * voxel_size)
        vprev0 = torch.where(contig, pv, 1.0)
        zprev0 = torch.where(contig, pz, t_in)
        vprev = torch.cat([vprev0[..., None], v_eff[..., : M - 1]], dim=-1)
        zprev = torch.cat([zprev0[..., None], zm[..., : M - 1]], dim=-1)
        zvprev = torch.cat([zprev0[..., None], zv[..., : M - 1]], dim=-1)
        cross = (vprev > 0) & (v_eff <= 0) & ok & (zm > zprev)
        zc = fma(vprev / torch.clamp(vprev - v_eff, min=1e-6), zv - zvprev, zvprev)
        zc = torch.minimum(torch.maximum(zc, torch.minimum(zprev, zm)), torch.maximum(zprev, zm))
        cand = torch.where(cross, zc, _BIG)
        zhit = torch.minimum(zhit, cand.amin(-1))
        if stats is not None:
            counts += torch.stack([going.sum(), has.sum(), cross.sum()])
            tile_steps += going
            read = has[..., None] & inb
            sec = row[:, None, None] * (B * B * B // 8) + flat // 8
            sectors.append(torch.unique(sec[read]))
        pv = torch.where(has, torch.where(ok[..., M - 1], vals[..., M - 1], 1.0), pv)
        pz = torch.where(has, torch.maximum(zm[..., M - 1], pz), pz)

    if stats is not None:
        rows_m = torch.cat(marched) if marched else torch.zeros(0, dtype=torch.int64, device=dev)
        stats["rows_marched"] = int(torch.unique(rows_m).numel())
        secs = torch.cat(sectors) if sectors else torch.zeros(0, dtype=torch.int64, device=dev)
        stats["sectors_sampled"] = int(torch.unique(secs).numel())
        stats["tile_steps"] = tile_steps
        stats.update(zip(("pairs_visited", "ray_blocks", "crossings"), counts.tolist()))
    zhit = torch.where(zhit < _BIG, zhit, 0.0)
    img = zhit.reshape(TH, TW, tile, tile).permute(0, 2, 1, 3).reshape(TH * tile, TW * tile)
    return img[:H, :W].contiguous()


def march_tiles(
    vbg,
    lists: TileLists,
    intrinsic,
    extrinsic: torch.Tensor,
    depth_min: float,
    depth_max: float,
    tile: int = 16,
    K: int = 24,
    G: int = 8,
    M: int = 6,
) -> torch.Tensor:
    """Pass 2: march every tile; returns the (H, W) hit depth (0 = miss).
    CUDA tensors launch the kernel; CPU tensors run march_tiles_plain."""
    if vbg.block_resolution != 16 or tuple(vbg.tw.shape[1:]) != (32, 128):
        raise ValueError("the march assumes 16^3 blocks with a (C+1, 32, 128) payload")
    H, W = intrinsic.height, intrinsic.width
    TH, TW = -(-H // tile), -(-W // tile)
    T = TH * TW
    if tile != 16:
        raise ValueError("the march kernel uses 16x16-pixel tiles (256 rays a CTA)")
    if not 1 <= M <= 16:
        raise ValueError("M must be in [1, 16]")
    dev = vbg.tw.device
    C = vbg.capacity
    L = T * K + G
    _check("tw", vbg.tw, torch.int32, dev, (C + 1, 32, 128))
    _check("lists.rows", lists.rows, torch.int32, dev, (L,))
    _check("lists.coords", lists.coords, torch.int32, dev, (L, 3))
    _check("lists.nk", lists.nk, torch.int32, dev, (T,))
    _check("lists.n_extra", lists.n_extra, torch.int32, dev, (1,))
    rows = torch.where(lists.rows >= 0, lists.rows, C).to(torch.int32).contiguous()

    with span("k2.launch"):
        if dev.type == "cpu":
            return march_tiles_plain(
                vbg.tw, rows, lists.coords, lists.nk, lists.n_extra, intrinsic, extrinsic,
                vbg.voxel_size, depth_min, depth_max, tile=tile, K=K, M=M,
            )
        if dev.type != "cuda":
            raise ValueError(f"march_tiles: unsupported device {dev}")

        params = _march_params(extrinsic, dev)
        out = torch.empty((H, W), dtype=torch.float32, device=dev)
        vs = vbg.voxel_size
        _build.launch(
            "o3dt_march_tiles", dev,
            vbg.tw.data_ptr(), rows.data_ptr(), lists.coords.data_ptr(), lists.nk.data_ptr(),
            lists.n_extra.data_ptr(), params.data_ptr(), out.data_ptr(),
            T, TW, H, W, K, M,
            intrinsic.cx, intrinsic.cy, 1.0 / intrinsic.fx, 1.0 / intrinsic.fy,
            vs, vs * 16, 1.0 / vs, 0.5 * vs, 2.0 * vs, 1.0 / M, depth_min, depth_max,
        )
    return out


def occupancy(M: int = 6) -> dict:
    """The march kernel for M samples on the card: CTAs a multiprocessor,
    multiprocessors, threads a CTA, registers a thread."""
    return _build.occupancy("o3dt_march_occupancy", M)


def raycast_depth(
    vbg,
    intrinsic,
    extrinsic: torch.Tensor,
    depth_min: float = 0.1,
    depth_max: float = 3.0,
    tile: int = 16,
    K: int = 24,
    M: int = 6,
):
    """Full raycast -> (depth (H, W) f32 with 0 = miss, overflow stat)."""
    lists = build_tile_lists(vbg, intrinsic, extrinsic, depth_min, depth_max, tile=tile, K=K)
    depth = march_tiles(
        vbg, lists, intrinsic, extrinsic, depth_min, depth_max, tile=tile, K=K, M=M
    )
    return depth, lists.overflow
