"""Sparse TSDF voxel block grid (port of the create / touch / integrate /
raycast / point-cloud extraction path of
open3d_tpu/geometry/voxel_block_grid.py).

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
torch and the row fuse K3.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core.masking import FAR_COORD, compact_indices
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
) -> VoxelBlockGrid:
    """Fuse one depth (+colour) frame: activate the blocks, then one kernel
    pass over all M of them (blocks that could not be activated go to the
    dump row and are skipped).

    depth is metric float32 (or raw with `depth_scale`); extrinsic is
    world -> camera. `vbg.tw` and `vbg.color` are updated in place; the
    returned grid carries the new table."""
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
# Raycast
# ---------------------------------------------------------------------------


class RaycastResult(NamedTuple):
    depth: torch.Tensor  # (H, W) f32, 0 = miss
    vertex: torch.Tensor  # (H, W, 3) world frame
    color: torch.Tensor  # (H, W, 3)
    mask: torch.Tensor  # (H, W) bool
    normal: Optional[torch.Tensor] = None
    index: Optional[torch.Tensor] = None
    interp_ratio: Optional[torch.Tensor] = None


def raycast(
    vbg: VoxelBlockGrid,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    depth_min: float = 0.1,
    depth_max: float = 3.0,
    with_color: bool = True,
    with_normals: bool = False,
    with_index_ratio: bool = False,
) -> RaycastResult:
    """Render the depth and vertex maps by the tile march (the JAX
    package's `_raycast_pallas` path, taken on every device here): per-tile
    candidate lists, the march kernel for depth, then vertex and mask.

    The JAX package's `max_steps` belongs to its XLA sphere trace, which is
    not ported; the march has no step count, so it takes none. Colour,
    normal and index/ratio maps are not ported yet and raise."""
    if with_normals or with_index_ratio or (with_color and vbg.has_color):
        raise NotImplementedError(
            "raycast colour, normal and index/ratio maps are not ported yet"
        )
    if vbg.block_resolution != 16:
        raise NotImplementedError("the raycast march assumes 16^3 blocks")
    from open3d_tpu_torch.ops.kernels import raycast as rc

    H, W = intrinsic.height, intrinsic.width
    dev = vbg.device
    depth_img, _ = rc.raycast_depth(
        vbg, intrinsic, extrinsic, depth_min=depth_min, depth_max=depth_max
    )
    mask = depth_img > 0
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = (torch.zeros((H, 1), device=dev) + u - intrinsic.cx) / intrinsic.fx
    y = (v + torch.zeros((1, W), device=dev) - intrinsic.cy) / intrinsic.fy
    E = extrinsic.to(device=dev, dtype=torch.float32)
    R = E[:3, :3]
    t = E[:3, 3]
    origin = -R.T @ t
    dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ R
    p_hit = origin + dirs * depth_img[..., None]
    vertex = torch.where(mask[..., None], p_hit, 0.0)
    color_img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    return RaycastResult(depth=depth_img, vertex=vertex, color=color_img, mask=mask)


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
