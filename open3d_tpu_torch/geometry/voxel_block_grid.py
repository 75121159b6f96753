"""Sparse TSDF voxel block grid (port of the create / touch / integrate /
raycast / point-cloud extraction path of
open3d_tpu/geometry/voxel_block_grid.py; mesh extraction is not ported).

The layout is the JAX package's, bit for bit:
- `table` (C, 2) int32 packed block keys (core/hashmap.py); the slot index
  is the payload row;
- `tw` (C+1, 32, 128) int32, tsdf s1.14 in the high 16 bits | weight u16
  in the low 16; `color` (C+1, 32, 128) int32 R11|G11|B10 (None without
  colour). A (C+1, 4096) view is the same bytes. Row C is the dump row and
  stays zero.

`integrate` and `raycast` update and read the grid in place: the tensors
of a VoxelBlockGrid are mutated by `integrate`, where the JAX package
donated them and got new ones back.

Integrate takes one of three kernels, as the JAX package does on the TPU:
16^3 grids the fused integrate K1 (or the V1 integrate K4 when
O3DTPU_INTEGRATE_V1 is set), other resolutions per-voxel samples in plain
torch and the row fuse K3. Raycast takes the tile march K2 on 16^3 grids
and the sphere trace (plain torch) on the others; the colour, normal and
index/ratio maps on either path read the grid through a dense block index.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core.masking import FAR_COORD, _div, compact_indices
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.pointcloud import PointCloud

_TSDF_SCALE = 16383.0


def pack_tw(tsdf: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """tsdf f32 in [-1, 1] (stored s1.14) + weight (clipped u16) -> int32."""
    tq = torch.round(torch.clamp(tsdf, -1.0, 1.0) * _TSDF_SCALE).to(torch.int32)
    w = torch.clamp(weight, 0, 65535).to(torch.int32)
    return (tq << 16) | w


def unpack_tw(tw: torch.Tensor):
    """int32 -> (tsdf f32, weight f32)."""
    t = (tw >> 16).to(torch.float32) * (1.0 / _TSDF_SCALE)
    w = (tw & 0xFFFF).to(torch.float32)
    return t, w


def pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) floats in [0, 1] -> int32 {R:11|G:11|B:10}."""
    r = torch.clamp(torch.round(rgb[..., 0] * 2047.0), 0, 2047).to(torch.int32)
    g = torch.clamp(torch.round(rgb[..., 1] * 2047.0), 0, 2047).to(torch.int32)
    b = torch.clamp(torch.round(rgb[..., 2] * 1023.0), 0, 1023).to(torch.int32)
    return (r << 21) | (g << 10) | b


def unpack_rgb(c: torch.Tensor) -> torch.Tensor:
    """int32 -> (..., 3) floats in [0, 1]."""
    r = ((c >> 21) & 0x7FF).to(torch.float32) / 2047.0
    g = ((c >> 10) & 0x7FF).to(torch.float32) / 2047.0
    b = (c & 0x3FF).to(torch.float32) / 1023.0
    return torch.stack([r, g, b], dim=-1)


def payload_shape(B3: int):
    """(rows, lanes) of one block's payload: (32, 128) for 16^3."""
    if B3 % 128 == 0:
        return (B3 // 128, 128)
    return (1, B3)


@dataclasses.dataclass
class VoxelBlockGrid:
    table: torch.Tensor  # (C, 2) int32 packed block keys
    tw: torch.Tensor  # (C + 1, R, L) int32 {tsdf s1.14 | weight u16}; row C = dump
    color: Optional[torch.Tensor]  # (C + 1, R, L) int32 {R11|G11|B10} or None
    voxel_size: float
    block_resolution: int
    sdf_trunc: float

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.block_resolution

    @property
    def has_color(self) -> bool:
        return self.color is not None

    @property
    def device(self) -> torch.device:
        return self.tw.device

    @property
    def tw_flat(self) -> torch.Tensor:
        return self.tw.view(self.tw.shape[0], -1)

    @property
    def color_flat(self) -> Optional[torch.Tensor]:
        return None if self.color is None else self.color.view(self.color.shape[0], -1)

    def num_active_blocks(self) -> torch.Tensor:
        return hm.occupied_mask(self.table).to(torch.int32).sum()

    def tsdf_weight(self):
        return unpack_tw(self.tw_flat)

    def color_f32(self):
        return None if self.color is None else unpack_rgb(self.color_flat)


def create(
    voxel_size: float = 3.0 / 512,
    block_resolution: int = 16,
    block_count: int = 40960,
    sdf_trunc: Optional[float] = None,
    with_color: bool = True,
    device=None,
) -> VoxelBlockGrid:
    """An empty grid of `block_count` blocks on `device` (default: the card)."""
    dev = default_device(device)
    B3 = block_resolution**3
    C = block_count
    R, L = payload_shape(B3)
    return VoxelBlockGrid(
        table=hm.make_table(C, device=dev),
        tw=torch.zeros((C + 1, R, L), dtype=torch.int32, device=dev),
        color=torch.zeros((C + 1, R, L), dtype=torch.int32, device=dev) if with_color else None,
        voxel_size=float(voxel_size),
        block_resolution=int(block_resolution),
        sdf_trunc=float(sdf_trunc if sdf_trunc is not None else 4.0 * voxel_size),
    )


# ---------------------------------------------------------------------------
# Touch: which blocks does this depth frame intersect?
# ---------------------------------------------------------------------------


def compute_unique_block_coordinates(
    vbg: VoxelBlockGrid,
    depth: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_max: float = 3.0,
    stride: int = 4,
    frame_block_capacity: int = 2048,
):
    """Packed keys of every block within sdf_trunc of the depth surface, from
    a `stride`-downsampled depth image. Returns (keys (frame_block_capacity,
    2) int32 invalid-padded, count () int32 before the capacity clamp)."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    dev = depth.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) * stride)[None, :]
    v = (torch.arange(H, dtype=torch.float32, device=dev) * stride)[:, None]
    valid = (d > 0) & (d < depth_max)
    x = ((u - intrinsic.cx) / intrinsic.fx).expand(H, W)
    y = ((v - intrinsic.cy) / intrinsic.fy).expand(H, W)
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # direction per unit z
    E = extrinsic.to(device=dev, dtype=torch.float32)
    R = E[:3, :3]
    t = E[:3, 3]
    cam_origin = -R.T @ t

    bs = vbg.block_size
    n_steps = max(int(2.0 * vbg.sdf_trunc / bs + 0.5) + 2, 2)
    zs = torch.linspace(-vbg.sdf_trunc, vbg.sdf_trunc, n_steps, dtype=torch.float32, device=dev)
    keys_all = []
    for i in range(n_steps):
        z = d + zs[i]
        p_cam = ray * z[..., None]
        p_world = p_cam.reshape(-1, 3) @ R + cam_origin  # R^T applied row-wise
        block = torch.floor(p_world / bs).to(torch.int32)
        keys = hm.pack_coords(block)
        ok = valid.reshape(-1) & (z > 0).reshape(-1)
        keys_all.append(torch.where(ok[:, None], keys, 0))
    return hm.unique_keys(torch.cat(keys_all), frame_block_capacity)


# ---------------------------------------------------------------------------
# Integrate
# ---------------------------------------------------------------------------


def _voxel_local_coords(B: int, device=None) -> torch.Tensor:
    """(B^3, 3) int32 local voxel coords, x fastest (flat index x + y B +
    z B^2)."""
    r = torch.arange(B, dtype=torch.int32, device=device)
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def _new_voxel_values(
    vbg, block_keys, depth, color, intrinsic, extrinsic, depth_max, depth_scale, ok
):
    """Per-voxel projective SDF samples for the touched blocks: (tsdf_new
    (M, B^3) f32, wn (M, B^3) f32, cnew (M, B^3) int32 packed colour or
    None). Pixels are sampled by flat gathers."""
    B = vbg.block_resolution
    dev = depth.device
    coords = hm.unpack_coords(block_keys)  # (M, 3)
    local = _voxel_local_coords(B, dev)  # (B^3, 3)
    origin = coords.to(torch.float32) * vbg.block_size
    pw = origin[:, None, :] + local.to(torch.float32) * vbg.voxel_size
    E = extrinsic.to(device=dev, dtype=torch.float32)
    R = E[:3, :3]
    t = E[:3, 3]
    # The JAX package's CPU form, a float32 (..., 3) @ (3, 3) product, on
    # every device: on the card a float32 matmul is full float32 (TF32 off,
    # PyTorch's default). The JAX package's TPU-only elementwise form exists
    # to avoid the TPU's one-pass-bf16 matmul, which the card does not use.
    pc = pw @ R.T + t
    xc, yc, z = pc[..., 0], pc[..., 1], pc[..., 2]
    u = xc / torch.clamp(z, min=1e-6) * intrinsic.fx + intrinsic.cx
    v = yc / torch.clamp(z, min=1e-6) * intrinsic.fy + intrinsic.cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    Wd = intrinsic.width
    inb = (z > 1e-4) & (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < intrinsic.height)
    lin = torch.where(inb, vi * Wd + torch.clamp(ui, 0, Wd - 1), 0)

    d = depth.reshape(-1)[lin] / depth_scale  # (M, B^3) flat gather
    d_ok = inb & (d > 0) & (d < depth_max)
    sdf = d - z
    keep = d_ok & (sdf >= -vbg.sdf_trunc)
    tsdf_new = torch.clamp(sdf / vbg.sdf_trunc, -1.0, 1.0)
    wn = (keep & ok[:, None]).to(torch.float32)

    cnew = None
    if color is not None and vbg.has_color:
        cnew = pack_rgb(color).reshape(-1)[lin]  # (M, B^3) int32
    return tsdf_new.contiguous(), wn.contiguous(), cnew


def integrate(
    vbg: VoxelBlockGrid,
    block_keys: torch.Tensor,  # (M, 2) packed, invalid-padded (from touch)
    depth: torch.Tensor,
    color: Optional[torch.Tensor],
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_max: float = 3.0,
    depth_scale: float = 1.0,
    weight_max: float = 10000.0,
    use_pallas: Optional[bool] = None,
    fallback_capacity: int = 16,
) -> VoxelBlockGrid:
    """Fuse one depth (+colour) frame: activate the blocks, then one kernel
    pass over all M of them (blocks that could not be activated go to the
    dump row and are skipped).

    depth is metric float32 (or raw with `depth_scale`); extrinsic is
    world -> camera. `vbg.tw` and `vbg.color` are updated in place; the
    returned grid carries the new table.

    `use_pallas` picks the reference's TPU kernel or its XLA path. The port
    has one path, its kernel (K1, K4 or K3, by the grid's block size;
    their plain versions on CPU tensors), so None and True select it and
    False, which asks for another path, raises. `fallback_capacity` sizes
    the reference's second pass for blocks outside its slab windows, a TPU
    workaround the kernel does not need: it is ignored."""
    if use_pallas is False:
        raise NotImplementedError(
            "integrate: the port has no XLA-style path; use_pallas=False cannot be honoured"
        )
    C = vbg.capacity
    table, slot, ok = hm.activate(vbg.table, block_keys)
    rows = torch.where(ok, slot, C).to(torch.int32).contiguous()
    if depth_scale != 1.0:
        depth = depth / depth_scale
    vbg = dataclasses.replace(vbg, table=table)

    if vbg.block_resolution != 16:
        # other resolutions: per-voxel samples in plain torch, then the fuse
        # kernel (K3) over the work list's payload rows
        from open3d_tpu_torch.ops.kernels import tsdf as k3

        tsdf_new, wn, cnew = _new_voxel_values(
            vbg, block_keys, depth, color, intrinsic, extrinsic, depth_max, 1.0, ok
        )
        k3.fuse_blocks(vbg.tw_flat, vbg.color_flat if cnew is not None else None,
                       rows, tsdf_new, wn, cnew, weight_max)
        # restore the dump-row invariant (the kernel skips row C; the plain
        # version writes it back unchanged)
        vbg.tw[C] = 0
        if cnew is not None:
            vbg.color[C] = 0
        return vbg

    coords = hm.unpack_coords(block_keys).contiguous()
    if os.environ.get("O3DTPU_INTEGRATE_V1"):
        # the V1 kernel (K4): bf16 hi+lo depth and bf16 colour planes
        from open3d_tpu_torch.ops.kernels import integrate as k4

        planes = k4.prepare_planes(depth, color, vbg.has_color)
        k4.integrate_blocks(
            vbg.tw, vbg.color, rows, coords, planes, intrinsic, extrinsic,
            vbg.voxel_size, vbg.sdf_trunc, depth_max, weight_max,
        )
    else:
        from open3d_tpu_torch.ops.kernels import integrate2 as k1

        d21, rgb24 = k1.prepare_frame(depth, color if vbg.has_color else None, depth_max)
        if vbg.has_color and rgb24 is None:
            rgb24 = torch.zeros_like(d21)
        k1.integrate_blocks_v2(
            vbg.tw, vbg.color, rows, coords, d21, rgb24, intrinsic,
            extrinsic, vbg.voxel_size, vbg.sdf_trunc, depth_max, weight_max,
        )
    vbg.tw[C] = 0
    if vbg.color is not None:
        vbg.color[C] = 0
    return vbg


# ---------------------------------------------------------------------------
# Dense block index: a frustum-local block-coord -> payload row volume
# ---------------------------------------------------------------------------


class BlockIndex(NamedTuple):
    rows: torch.Tensor  # (E^3,) int32 payload row a cell; C = missing
    origin: torch.Tensor  # (3,) int32 block coords of cell (0, 0, 0)
    extent: int


def build_block_index(
    vbg: VoxelBlockGrid,
    center_world: torch.Tensor,
    extent: int,
) -> BlockIndex:
    """Dense row-index volume of `extent`^3 blocks centred at center_world,
    scattered straight from the table (slot index == payload row). Every
    sample through it is one dense gather and one payload gather, with no
    hash probes; blocks outside the volume read as missing."""
    C = vbg.capacity
    E = int(extent)
    dev = vbg.device
    occ = hm.occupied_mask(vbg.table)
    coords = hm.unpack_coords(vbg.table)
    center = center_world.to(device=dev, dtype=torch.float32)
    origin = torch.floor(_div(center, vbg.block_size)).to(torch.int32) - E // 2
    rel = (coords - origin).to(torch.int64)
    inr = occ & torch.all((rel >= 0) & (rel < E), dim=-1)
    lin = rel[:, 0] + rel[:, 1] * E + rel[:, 2] * E * E
    # each live block owns its cell; every other slot writes C into the
    # extra cell E^3, which is sliced off (the JAX package's mode="drop")
    rows = torch.full((E * E * E + 1,), C, dtype=torch.int32, device=dev)
    rows.scatter_(0, torch.where(inr, lin, E * E * E),
                  torch.where(inr, torch.arange(C, dtype=torch.int32, device=dev), C))
    return BlockIndex(rows=rows[: E * E * E], origin=origin, extent=E)


def _index_rows(vbg: VoxelBlockGrid, bindex: BlockIndex, block: torch.Tensor) -> torch.Tensor:
    """Block coords (..., 3) -> payload rows (...,) int64 through the dense
    index; C where the block is missing or outside the volume."""
    E = bindex.extent
    rel = (block - bindex.origin).to(torch.int64)
    inr = torch.all((rel >= 0) & (rel < E), dim=-1)
    lin = rel[..., 0] + rel[..., 1] * E + rel[..., 2] * E * E
    return torch.where(inr, bindex.rows[torch.where(inr, lin, 0)].to(torch.int64), vbg.capacity)


def _voxel_rows(vbg: VoxelBlockGrid, bindex: BlockIndex, voxel: torch.Tensor):
    """Integer voxel coords (..., 3) -> (payload row, flat voxel in the
    block), both int64. Negative coords floor to their block."""
    B = vbg.block_resolution
    block = torch.div(voxel, B, rounding_mode="floor")
    local = voxel - block * B
    flat = (local[..., 0] + local[..., 1] * B + local[..., 2] * B * B).to(torch.int64)
    return _index_rows(vbg, bindex, block), flat


def _sample_voxels_indexed(vbg: VoxelBlockGrid, bindex: BlockIndex, voxel: torch.Tensor):
    """Nearest-voxel (tsdf, weight) at integer voxel coords (..., 3). The
    dump row C keeps weight 0, so a missing block reads as empty."""
    rows, flat = _voxel_rows(vbg, bindex, voxel)
    B3 = vbg.block_resolution ** 3
    return unpack_tw(vbg.tw.view(-1)[rows * B3 + flat])  # flat 1-D gather


def _corners(device):
    """(dx, dy, dz, offset (3,) int32 on `device`) of the 8 trilinear
    corners, in the JAX package's order (made on the device: a tensor built
    from a host list would cost a host-to-device copy and a sync a call)."""
    k = torch.arange(8, dtype=torch.int32, device=device)
    offs = torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], dim=-1)
    return [(dx, dy, dz, offs[4 * dx + 2 * dy + dz])
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _corner_weight(f: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    return ((f[..., 0] if dx else 1.0 - f[..., 0]) * (f[..., 1] if dy else 1.0 - f[..., 1])
            * (f[..., 2] if dz else 1.0 - f[..., 2]))


def _sample_tsdf_trilinear_indexed(vbg: VoxelBlockGrid, bindex: BlockIndex, p: torch.Tensor):
    """Trilinear TSDF at world points p (..., 3) through the dense index;
    voxel v's sample sits at v * voxel_size (integrate's corner convention).
    Returns (tsdf, wsum), wsum the interpolation weight summed over the
    allocated corners (0 = no data)."""
    g = _div(p, vbg.voxel_size)
    g0 = torch.floor(g).to(torch.int32)
    f = g - g0.to(torch.float32)
    ts_acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    w_acc = torch.zeros_like(ts_acc)
    for dx, dy, dz, corner in _corners(p.device):
        wt = _corner_weight(f, dx, dy, dz)
        ts, w = _sample_voxels_indexed(vbg, bindex, g0 + corner)
        alloc = w > 0
        ts_acc = ts_acc + torch.where(alloc, wt * ts, 0.0)
        w_acc = w_acc + torch.where(alloc, wt, 0.0)
    return ts_acc / torch.clamp(w_acc, min=1e-6), w_acc


def _sample_color_indexed(vbg: VoxelBlockGrid, bindex: BlockIndex, voxel: torch.Tensor):
    """Colour (..., 3) in [0, 1] at integer voxel coords; 0 where the
    block is missing."""
    rows, flat = _voxel_rows(vbg, bindex, voxel)
    B3 = vbg.block_resolution ** 3
    c = unpack_rgb(vbg.color.view(-1)[rows * B3 + flat])
    return torch.where((rows < vbg.capacity)[..., None], c, 0.0)


# ---------------------------------------------------------------------------
# Raycast pass 1: per-tile block depth ranges
# ---------------------------------------------------------------------------


def estimate_range(
    vbg: VoxelBlockGrid,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_min: float,
    depth_max: float,
    tile: int = 16,
    active_capacity: int = 16384,
    max_tiles_per_block: int = 64,  # 8x8 tile footprint cap
):
    """Rasterise the active blocks into per-(tile x tile)-pixel (z_min,
    z_max), with a bounded-footprint scatter-min/max over the tile grid.

    Blocks whose footprint exceeds the cap, or that straddle the camera
    plane, widen a global fallback range applied to every tile. Only
    frustum-visible blocks enter the `active_capacity` working set; the
    overflow test widens the global range to [depth_min, depth_max]. As in
    the JAX package, the visible count is read after compact_indices has
    clamped it to the capacity, so that test never fires there or here.
    Returns (z_min (TH, TW), z_max (TH, TW)); z_min > z_max is empty."""
    dev = vbg.device
    TH = -(-intrinsic.height // tile)
    TW = -(-intrinsic.width // tile)
    E = extrinsic.to(device=dev, dtype=torch.float32)
    R = E[:3, :3]
    t = E[:3, 3]
    k = torch.arange(8, dtype=torch.int32, device=dev)
    corners = torch.stack([k & 1, (k >> 1) & 1, (k >> 2) & 1], -1).to(torch.float32) * vbg.block_size

    occ = hm.occupied_mask(vbg.table)
    all_coords = hm.unpack_coords(vbg.table)
    z_all = ((all_coords.to(torch.float32)[:, None, :] * vbg.block_size + corners)
             @ R.T[:, 2:3] + t[2])[..., 0]
    vis_all = occ & (z_all.amax(-1) > depth_min) & (z_all.amin(-1) < depth_max)
    A = active_capacity
    vidx, vcount = compact_indices(vis_all, A)
    overflowed = vcount > A
    live = torch.arange(A, device=dev) < torch.clamp(vcount, max=A)
    keys = vbg.table[torch.clamp(vidx, min=0).to(torch.int64)]
    coords = hm.unpack_coords(keys)  # (A, 3)

    pw = coords.to(torch.float32)[:, None, :] * vbg.block_size + corners
    pc = pw @ R.T + t  # (A, 8, 3)
    z = pc[..., 2]
    zsafe = torch.clamp(z, min=1e-6)
    u = pc[..., 0] / zsafe * intrinsic.fx + intrinsic.cx
    v = pc[..., 1] / zsafe * intrinsic.fy + intrinsic.cy

    front = torch.all(z > 1e-4, dim=-1)  # fully in front
    z0 = z.amin(-1)
    z1 = z.amax(-1)
    vis = live & (z1 > depth_min) & (z0 < depth_max)

    def tiles(x, n):
        return torch.clamp(torch.floor(x / tile), 0, n - 1).to(torch.int32)

    tu0, tu1 = tiles(u.amin(-1), TW), tiles(u.amax(-1), TW)
    tv0, tv1 = tiles(v.amin(-1), TH), tiles(v.amax(-1), TH)
    # fully off-screen blocks (their rectangle clips to nothing)
    on = ((u.amax(-1) >= 0) & (u.amin(-1) < intrinsic.width)
          & (v.amax(-1) >= 0) & (v.amin(-1) < intrinsic.height))
    rw = tu1 - tu0 + 1
    rh = tv1 - tv0 + 1
    K = int(max_tiles_per_block)
    KW = 8
    # the scatter enumerates ky in [0, K // KW), so a tall block goes to the
    # fallback too
    fits = front & (rw * rh <= K) & (rw <= KW) & (rh <= K // KW)
    ok = vis & on & front & fits
    fb = vis & front & ~fits & on  # visible, footprint too large
    fb_part = vis & live & ~front  # straddles the camera plane
    wide = fb | fb_part
    any_fb = torch.any(wide) | overflowed
    inf = torch.full((), float("inf"), device=dev)
    g_zmin = torch.where(any_fb, torch.where(wide, torch.clamp(z0, min=depth_min), inf).min(), inf)
    g_zmax = torch.where(any_fb, torch.where(wide, torch.clamp(z1, max=depth_max), -inf).max(),
                         -inf)
    g_zmin = torch.where(overflowed, depth_min, g_zmin)
    g_zmax = torch.where(overflowed, depth_max, g_zmax)

    n_tiles = TH * TW
    kk = torch.arange(K, dtype=torch.int32, device=dev)
    kx = kk % KW
    ky = kk // KW
    tx = tu0[:, None] + kx[None, :]
    ty = tv0[:, None] + ky[None, :]
    inside = ok[:, None] & (kx[None, :] < rw[:, None]) & (ky[None, :] < rh[:, None])
    idx = torch.where(inside, ty * TW + tx, n_tiles).reshape(-1).to(torch.int64)
    z0b = z0[:, None].expand(tx.shape).reshape(-1)
    z1b = z1[:, None].expand(tx.shape).reshape(-1)
    zmin_t = torch.full((n_tiles + 1,), float("inf"), device=dev).scatter_reduce_(
        0, idx, z0b, "amin")[:n_tiles]
    zmax_t = torch.full((n_tiles + 1,), float("-inf"), device=dev).scatter_reduce_(
        0, idx, z1b, "amax")[:n_tiles]
    zmin_t = torch.minimum(zmin_t, g_zmin)
    zmax_t = torch.maximum(zmax_t, g_zmax)
    return zmin_t.reshape(TH, TW), zmax_t.reshape(TH, TW)


# ---------------------------------------------------------------------------
# Raycast
# ---------------------------------------------------------------------------


class RaycastResult(NamedTuple):
    depth: torch.Tensor  # (H, W) f32, 0 = miss
    vertex: torch.Tensor  # (H, W, 3) world frame
    color: torch.Tensor  # (H, W, 3)
    mask: torch.Tensor  # (H, W) bool
    normal: Optional[torch.Tensor] = None  # (H, W, 3) TSDF-gradient normals, world frame
    index: Optional[torch.Tensor] = None  # (H, W, 8) int32 flat payload ids, -1 = none
    interp_ratio: Optional[torch.Tensor] = None  # (H, W, 8) trilinear weights


def _pixel_rays(intrinsic: PinholeCameraIntrinsic, extrinsic: torch.Tensor):
    """(camera centre (3,), world ray of every pixel per unit z-depth (H,
    W, 3)) for a world -> camera extrinsic on its device. Written as
    elementwise products and sums, so the card and the CPU round alike."""
    H, W = intrinsic.height, intrinsic.width
    dev = extrinsic.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = _div(torch.zeros((H, 1), device=dev) + u - intrinsic.cx, intrinsic.fx)
    y = _div(v + torch.zeros((1, W), device=dev) - intrinsic.cy, intrinsic.fy)
    R = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    origin = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])  # -R^T t
    dirs = x[..., None] * R[0] + y[..., None] * R[1] + R[2]  # [x, y, 1] @ R
    return origin, dirs


def _march_rays(intrinsic: PinholeCameraIntrinsic, extrinsic: torch.Tensor):
    """_pixel_rays by a division and one matrix product: fewer launches,
    but the card and the CPU may round it an ulp apart. The march's vertex
    map is set up so when no surface map is asked for."""
    H, W = intrinsic.height, intrinsic.width
    dev = extrinsic.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = (torch.zeros((H, 1), device=dev) + u - intrinsic.cx) / intrinsic.fx
    y = (v + torch.zeros((1, W), device=dev) - intrinsic.cy) / intrinsic.fy
    R = extrinsic[:3, :3]
    return -R.T @ extrinsic[:3, 3], torch.stack([x, y, torch.ones_like(x)], dim=-1) @ R


def _gradient_normals(vbg, bindex, p, dirs, mask):
    """Camera-facing TSDF-gradient normals at world points p (N, 3):
    central differences one voxel either side on the trilinear TSDF."""
    eps = vbg.voxel_size
    comps = []
    for ax in range(3):
        off = torch.zeros(3, dtype=torch.float32, device=p.device)
        off[ax] = eps
        tp, _ = _sample_tsdf_trilinear_indexed(vbg, bindex, p + off)
        tm, _ = _sample_tsdf_trilinear_indexed(vbg, bindex, p - off)
        comps.append(tp - tm)
    g = torch.stack(comps, dim=-1)
    n = g / torch.clamp(torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True)), min=1e-9)
    # orient towards the camera (against the ray)
    flip = torch.sum(n * dirs, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(mask[..., None], n, 0.0)


def _index_ratio_maps(vbg, bindex, p, mask):
    """Per-hit flat payload index (row * B^3 + voxel, -1 where the corner's
    block is missing) and trilinear weight of the 8 corners, (N, 8) each:
    d(tsdf)/d(payload) follows from these alone."""
    B3 = vbg.block_resolution ** 3
    g = _div(p, vbg.voxel_size)
    g0 = torch.floor(g).to(torch.int32)
    f = g - g0.to(torch.float32)
    idxs, wts = [], []
    for dx, dy, dz, corner in _corners(p.device):
        rows, flat = _voxel_rows(vbg, bindex, g0 + corner)
        wt = _corner_weight(f, dx, dy, dz)
        found = mask & (rows < vbg.capacity)
        idxs.append(torch.where(found, rows * B3 + flat, -1))
        wts.append(torch.where(found, wt, 0.0))
    return torch.stack(idxs, dim=-1).to(torch.int32), torch.stack(wts, dim=-1)


def _surface_maps(vbg, bindex, p_hit, dirs, mask, color_voxel, shape, with_color,
                  with_normals, with_index_ratio) -> dict:
    """The colour, normal and index/ratio fields of a RaycastResult of
    `shape` (H, W), from the hits p_hit (N, 3): colour read at the integer
    voxels `color_voxel` (N, 3) (zeros when not asked for or the grid has
    none), the rest None when not asked for."""
    H, W = shape
    maps = {"color": torch.zeros((H, W, 3), dtype=torch.float32, device=p_hit.device),
            "normal": None, "index": None, "interp_ratio": None}
    if with_color and vbg.has_color:
        col = _sample_color_indexed(vbg, bindex, color_voxel)
        maps["color"] = torch.where(mask[:, None], col, 0.0).reshape(H, W, 3)
    if with_normals:
        maps["normal"] = _gradient_normals(vbg, bindex, p_hit, dirs, mask).reshape(H, W, 3)
    if with_index_ratio:
        idx, wt = _index_ratio_maps(vbg, bindex, p_hit, mask)
        maps["index"], maps["interp_ratio"] = idx.reshape(H, W, 8), wt.reshape(H, W, 8)
    return maps


def _index_extent(vbg: VoxelBlockGrid, depth_max: float) -> int:
    """Cells a side of the dense index: the depth_max ball around the
    camera (67 at the SLAM grid's 3/512 m voxels, 1.2 MB of int32)."""
    return min(int(2.0 * depth_max / vbg.block_size) + 3, 128)


def _maps_on_depth(vbg, intrinsic, extrinsic, depth_img, depth_max, with_color=True,
                   with_normals=False, with_index_ratio=False) -> RaycastResult:
    """Vertex, mask and the asked-for maps from a raycast depth image (the
    march's), as the JAX package's `_raycast_pallas` assembles them. The
    dense index is built only when a map needs it."""
    H, W = intrinsic.height, intrinsic.width
    dev = vbg.device
    E = extrinsic.to(device=dev, dtype=torch.float32)
    mask = depth_img > 0
    any_map = (with_color and vbg.has_color) or with_normals or with_index_ratio
    origin, dirs = (_pixel_rays if any_map else _march_rays)(intrinsic, E)
    p_hit = origin + dirs * depth_img[..., None]
    vertex = torch.where(mask[..., None], p_hit, 0.0)
    maps = {"color": torch.zeros((H, W, 3), dtype=torch.float32, device=dev)}
    if any_map:
        bindex = build_block_index(vbg, origin, _index_extent(vbg, depth_max))
        p = p_hit.reshape(-1, 3)
        voxel = torch.floor(_div(p, vbg.voxel_size)).to(torch.int32)
        maps = _surface_maps(vbg, bindex, p, dirs.reshape(-1, 3), mask.reshape(-1), voxel,
                             (H, W), with_color, with_normals, with_index_ratio)
    return RaycastResult(depth=depth_img, vertex=vertex, mask=mask, **maps)


class _TraceState(NamedTuple):
    z: torch.Tensor
    prev_t: torch.Tensor
    prev_z: torch.Tensor
    z_lo: torch.Tensor
    z_hi: torch.Tensor
    done: torch.Tensor


def _trace_init(z_start: torch.Tensor, z_end: torch.Tensor) -> _TraceState:
    zeros = torch.zeros_like(z_start)
    return _TraceState(z_start, torch.ones_like(z_start), z_start, zeros, zeros, z_start >= z_end)


def _trace_step(vbg, bindex, origin, dirs, z_end, s: _TraceState) -> _TraceState:
    """One step of the bracket search along every ray. A ray that is done
    keeps z, and z_lo/z_hi change only on a crossing of a ray not done, so
    a ray's bracket is final once it is done: further steps change no
    output."""
    p = origin + dirs * s.z[:, None]
    voxel = torch.floor(p * (1.0 / vbg.voxel_size)).to(torch.int32)
    ts, w = _sample_voxels_indexed(vbg, bindex, voxel)
    alloc = w > 0
    # a hit: the previous sample positive, this one not, in known space
    crossing = alloc & (s.prev_t > 0) & (ts <= 0) & ~s.done
    z_lo = torch.where(crossing, s.prev_z, s.z_lo)
    z_hi = torch.where(crossing, s.z, s.z_hi)
    done = s.done | crossing | (s.z > z_end)
    # the projective TSDF over-estimates the euclidean distance (it tunnels
    # at grazing incidence), so advance by 3/4 of it; empty space by half a
    # block, so a one-block shell cannot be jumped
    step = torch.where(alloc, torch.clamp(0.75 * ts * vbg.sdf_trunc, min=vbg.voxel_size),
                       0.5 * vbg.block_size)
    prev_t = torch.where(alloc, ts, 1.0)  # empty space resets the sign
    z = torch.where(done, s.z, s.z + step)
    return _TraceState(z, prev_t, s.z, z_lo, z_hi, done)


def _sphere_trace(vbg, intrinsic, extrinsic, depth_min, depth_max, max_steps, with_color,
                  with_normals, with_index_ratio, use_range_map) -> RaycastResult:
    """The JAX package's XLA raycast: rays bounded by their tile's block
    depth range (estimate_range) step through the dense index to a sign
    change, which four bisection rounds on the trilinear TSDF and a secant
    refine. Plain torch on the grid's device.

    The reference's while_loop stops once every ray is done; here exactly
    `max_steps` steps run, with no host sync, and the outputs are the same
    (see _trace_step)."""
    H, W = intrinsic.height, intrinsic.width
    dev = vbg.device
    E = extrinsic.to(device=dev, dtype=torch.float32)
    origin, dirs = _pixel_rays(intrinsic, E)
    dirs = dirs.reshape(-1, 3)
    N = dirs.shape[0]
    bindex = build_block_index(vbg, origin, _index_extent(vbg, depth_max))

    if use_range_map:
        zmin_t, zmax_t = estimate_range(vbg, intrinsic, E, depth_min, depth_max)
        tile = 16
        tv = (torch.arange(H, device=dev) // tile)[:, None]
        tu = (torch.arange(W, device=dev) // tile)[None, :]
        z_start = torch.clamp(zmin_t[tv, tu] - vbg.sdf_trunc, min=depth_min).reshape(-1)
        z_end = torch.clamp(zmax_t[tv, tu] + vbg.sdf_trunc, max=depth_max).reshape(-1)
    else:
        z_start = torch.full((N,), depth_min, dtype=torch.float32, device=dev)
        z_end = torch.full((N,), depth_max, dtype=torch.float32, device=dev)

    s = _trace_init(z_start, z_end)
    for _ in range(max_steps):
        s = _trace_step(vbg, bindex, origin, dirs, z_end, s)
    z_lo, z_hi = s.z_lo, s.z_hi

    hit = z_hi > 0
    # sub-voxel refinement: bisection on the trilinear TSDF inside the
    # bracket, then a secant
    t_lo = torch.ones((N,), dtype=torch.float32, device=dev)
    t_hi = -torch.ones((N,), dtype=torch.float32, device=dev)
    for _ in range(4):
        zm = 0.5 * (z_lo + z_hi)
        tm, wm = _sample_tsdf_trilinear_indexed(vbg, bindex, origin + dirs * zm[:, None])
        known = wm > 0.25  # unknown samples must not move the bracket
        neg = (tm <= 0) & known
        pos = (tm > 0) & known
        z_hi = torch.where(hit & neg, zm, z_hi)
        t_hi = torch.where(hit & neg, tm, t_hi)
        z_lo = torch.where(hit & pos, zm, z_lo)
        t_lo = torch.where(hit & pos, tm, t_lo)
    hit_z = z_lo + t_lo / torch.clamp(t_lo - t_hi, min=1e-6) * (z_hi - z_lo)
    hit_z = torch.where(hit, hit_z, 0.0)

    mask = hit_z > 0
    depth_img = torch.where(mask, hit_z, 0.0).reshape(H, W)
    p_hit = origin + dirs * hit_z[:, None]
    vertex = torch.where(mask[:, None], p_hit, 0.0).reshape(H, W, 3)
    voxel = torch.floor(p_hit * (1.0 / vbg.voxel_size)).to(torch.int32)
    maps = _surface_maps(vbg, bindex, p_hit, dirs, mask, voxel, (H, W), with_color,
                         with_normals, with_index_ratio)
    return RaycastResult(depth=depth_img, vertex=vertex, mask=mask.reshape(H, W), **maps)


def raycast(
    vbg: VoxelBlockGrid,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_min: float = 0.1,
    depth_max: float = 3.0,
    max_steps: int = 96,
    with_color: bool = True,
    with_normals: bool = False,
    with_index_ratio: bool = False,
    use_range_map: bool = True,
    max_probes: int = 8,
    use_pallas: Optional[bool] = None,
) -> RaycastResult:
    """Render depth, vertex and colour maps (and, when asked, TSDF-gradient
    normals and the 8-corner index/ratio maps) from the pose `extrinsic`
    (world -> camera), on the grid's device.

    Two paths, as in the JAX package:
    - the tile march (`use_pallas` True, or None on a 16^3 grid; the card
      takes the JAX package's TPU path): per-tile candidate lists, the
      march kernel K2 for depth (its plain version on CPU tensors), then
      the maps on that depth through the dense block index. 16^3 only;
    - the sphere trace (`use_pallas` False, or None on any other block
      size): `max_steps` steps a ray through the dense block index, each
      ray bounded by its tile's block depth range when `use_range_map`.

    The march has no step count and its candidate lists are its range, so
    it ignores `max_steps` and `use_range_map`. `max_probes` is read by
    neither path (the reference's trace ignores it as well): the dense
    index replaced the hash probes."""
    if use_pallas is None:
        use_pallas = vbg.block_resolution == 16
    if not use_pallas:
        return _sphere_trace(vbg, intrinsic, extrinsic, depth_min, depth_max, max_steps,
                             with_color, with_normals, with_index_ratio, use_range_map)
    if vbg.block_resolution != 16:
        raise NotImplementedError("the raycast march assumes 16^3 blocks")
    from open3d_tpu_torch.ops.kernels import raycast as rc

    depth_img, _ = rc.raycast_depth(
        vbg, intrinsic, extrinsic, depth_min=depth_min, depth_max=depth_max
    )
    return _maps_on_depth(vbg, intrinsic, extrinsic, depth_img, depth_max, with_color,
                          with_normals, with_index_ratio)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


def extract_point_cloud(
    vbg: VoxelBlockGrid,
    point_capacity: int = 262144,
    weight_threshold: float = 3.0,
) -> PointCloud:
    """Zero-crossing surface points with forward-difference gradient
    normals (and colours), compacted into a cloud of `point_capacity`. A
    voxel's +x/+y/+z neighbour comes from its own block, or from the face
    of the neighbouring block found in the hash table."""
    B = vbg.block_resolution
    C = vbg.capacity
    dev = vbg.device
    occ = hm.occupied_mask(vbg.table)
    coords = hm.unpack_coords(vbg.table)  # (C, 3), garbage where unoccupied
    local = _voxel_local_coords(B, dev)  # (B^3, 3)
    tw2d = vbg.tw_flat
    own = torch.arange(C, device=dev)

    def neighbor_vals(axis):
        e = torch.zeros(3, dtype=torch.int32, device=dev)
        e[axis] = 1
        nb_slot, nb_found = hm.find(vbg.table, hm.pack_coords(coords + e))
        nb_rows = torch.where(nb_found & occ, nb_slot, C).to(torch.int64)
        nxt = local + e
        inside = nxt[:, axis] < B
        wrapped = torch.where(inside[:, None], nxt, nxt - e * B)
        flat = (wrapped[:, 0] + wrapped[:, 1] * B + wrapped[:, 2] * B * B).to(torch.int64)
        t_in, w_in = unpack_tw(tw2d[own[:, None], flat[None, :]])
        t_out, w_out = unpack_tw(tw2d[nb_rows[:, None], flat[None, :]])
        return (torch.where(inside[None, :], t_in, t_out),
                torch.where(inside[None, :], w_in, w_out))

    t0, w0 = unpack_tw(tw2d[:C])
    txs, wxs = zip(*(neighbor_vals(axis) for axis in range(3)))
    # gradient for normals from forward differences
    grad = torch.stack([txs[0] - t0, txs[1] - t0, txs[2] - t0], dim=-1)
    gnorm = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-9)

    base_w_ok = occ[:, None] & (w0 >= weight_threshold)
    origin = coords.to(torch.float32) * vbg.block_size
    vpos = origin[:, None, :] + local.to(torch.float32)[None, :, :] * vbg.voxel_size

    points, masks = [], []
    for axis in range(3):
        tn, wn = txs[axis], wxs[axis]
        cross = base_w_ok & (wn >= weight_threshold) & (t0 * tn < 0)
        denom = t0 - tn  # sign-preserving: clamping with max() breaks t0 < 0
        frac = torch.clamp(t0 / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9), 0.0, 1.0)
        e = torch.zeros(3, dtype=torch.float32, device=dev)
        e[axis] = vbg.voxel_size
        points.append((vpos + frac[..., None] * e).reshape(-1, 3))
        masks.append(cross.reshape(-1))

    pts = torch.cat(points)
    nrm = gnorm.reshape(-1, 3).repeat(3, 1)
    msk = torch.cat(masks)

    idx, count = compact_indices(msk, point_capacity)
    idx = idx.to(torch.int64)
    sel_mask = torch.arange(point_capacity, device=dev) < count
    out_pos = torch.where(sel_mask[:, None], pts[idx], FAR_COORD)
    attrs = {"normals": torch.where(sel_mask[:, None], nrm[idx], 0.0)}
    if vbg.has_color:
        cc = unpack_rgb(vbg.color_flat[:C]).reshape(-1, 3).repeat(3, 1)
        attrs["colors"] = torch.where(sel_mask[:, None], cc[idx], 0.0)
    return PointCloud(positions=out_pos, mask=sel_mask, attrs=attrs)
