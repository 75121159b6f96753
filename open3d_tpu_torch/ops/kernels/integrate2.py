"""Fused TSDF integrate of the touched 16^3 blocks (port of
open3d_tpu/ops/pallas/integrate2.py).

`integrate_blocks_v2` launches the CUDA kernel in `csrc/integrate2.cu` for
CUDA tensors and runs `integrate_blocks_plain`, the same function in plain
PyTorch, for CPU tensors. Nothing falls back: a CUDA tensor either launches
the kernel or raises.

Replaces: open3d_tpu/ops/pallas/integrate2.py:_integrate_kernel_v2.
Bound: bytes. A touched block reads and writes its 16 KiB tw row and its
16 KiB colour row; the kernel reads each row once, writes it once, and
gathers depth and colour from the frame images directly. At the SLAM
workload (about 580 live blocks a frame) the rows are too few to fill the
card one load at a time, so the kernel is bound by memory latency. Its
design: four CTAs an entry, and a thread owns one 16-byte group (4
voxels) of the block's rows; it projects its voxels, issues every frame
gather together with its two 16-byte row loads, and only then computes
and writes back, so a voxel costs one memory round trip, not two. The
rows must be 16-byte aligned (the wrapper checks).

Depth is quantised as the JAX kernel quantises it, d21 =
floor(clip(d, 0, depth_max) * (2^21 - 1) / depth_max), and decoded as
d21 * depth_max / (2^21 - 1); colour is sampled as 8:8:8 rgb24 and
repacked with +0.5 and truncation. The port reproduces d21 rather than
sampling float32 depth so that its payload rows are bit-comparable with
integrate_blocks_v2's.

Rounding: multiply-adds are fused (fmaf in the kernel, `_plain.fma` in the
plain version) exactly where XLA's CPU backend fuses them in the
interpreted JAX kernel, the reference the CPU tests hold the port to: the
voxel position, the first product pair of each projection row, the pixel
coordinate and the running means. Everywhere else each product is rounded on its own (the kernel is
built with --fmad=false). Pixels round half to even, as jnp.round does.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_aligned
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels._plain import fma
from open3d_tpu_torch.utils.timer import span

_B = 16
_B3 = _B**3
_D21 = float((1 << 21) - 1)
_TSDF_SCALE = 16383.0


def prepare_frame(depth: torch.Tensor, color: Optional[torch.Tensor], depth_max: float):
    """The frame as the kernel samples it: (d21 (H, W) int32, rgb24 (H, W)
    int32 or None). The role of prepare_planes_v2, without the int8 split,
    the shifted copy and the padding."""
    ok = (depth > 0) & torch.isfinite(depth)
    q = torch.floor(torch.clamp(depth, 0.0, depth_max) * (_D21 / depth_max))
    d21 = torch.where(ok, q, 0.0).to(torch.int32).contiguous()
    if color is None:
        return d21, None
    c8 = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)
    rgb24 = (c8[..., 0] << 16) | (c8[..., 1] << 8) | c8[..., 2]
    return d21, rgb24.contiguous()


def _params(extrinsic: torch.Tensor, device) -> torch.Tensor:
    """(12,) float32: R row-major, then t (world -> camera)."""
    E = extrinsic.to(device=device, dtype=torch.float32)
    return torch.cat([E[:3, :3].reshape(-1), E[:3, 3]]).contiguous()


def _integrate_plain(tw, color, slots, coords, intrinsic, extrinsic, voxel_size, sdf_trunc,
                     depth_max, weight_max, H, W, depth_at, color_at, v1=False) -> None:
    """The integrate kernels' function in plain PyTorch, vectorised over
    (M, 4096), in the JAX kernels' element-wise order, for either sample
    format: depth_at(lin, inb) gives the depth sample, color_at(lin, inb)
    the (r, g, b) sample in [0, 1]. `v1` takes the V1 kernel's projection
    (both product pairs fused) and passes the new tsdf through its bf16
    hi + lo relayout split. Updates the rows of `tw` (and `color`) named by
    `slots` in place; entries whose slot is the dump row C are skipped
    (left out before any arithmetic: a frame's work list is mostly dump
    entries at a large frame_block_capacity)."""
    C = tw.shape[0] - 1
    tw2 = tw.view(C + 1, _B3)
    col2 = color.view(C + 1, _B3) if color is not None else None
    live = torch.nonzero((slots >= 0) & (slots < C)).reshape(-1)
    rows = slots[live].to(torch.int64)
    coords = coords[live]
    p = _params(extrinsic, tw.device)
    R00, R01, R02, R10, R11, R12, R20, R21, R22, tX, tY, tZ = [p[i] for i in range(12)]

    f = torch.arange(_B3, device=tw.device)
    lx = (f & 15).to(torch.float32)[None, :]
    ly = ((f >> 4) & 15).to(torch.float32)[None, :]
    lz = (f >> 8).to(torch.float32)[None, :]
    bs = voxel_size * _B
    bxf = (coords[:, 0].to(torch.float32) * bs)[:, None]
    byf = (coords[:, 1].to(torch.float32) * bs)[:, None]
    bzf = (coords[:, 2].to(torch.float32) * bs)[:, None]
    M = coords.shape[0]
    pwx = fma(lx.expand(M, _B3), voxel_size, bxf)
    pwy = fma(ly.expand(M, _B3), voxel_size, byf)
    pwz = fma(lz.expand(M, _B3), voxel_size, bzf)
    if v1:
        pcx = fma(R02, pwz, fma(R00, pwx, R01 * pwy)) + tX
        pcy = fma(R12, pwz, fma(R10, pwx, R11 * pwy)) + tY
        pcz = fma(R22, pwz, fma(R20, pwx, R21 * pwy)) + tZ
    else:
        pcx = fma(R00, pwx, R01 * pwy) + R02 * pwz + tX
        pcy = fma(R10, pwx, R11 * pwy) + R12 * pwz + tY
        pcz = fma(R20, pwx, R21 * pwy) + R22 * pwz + tZ
    zc = torch.clamp(pcz, min=1e-6)
    ui = torch.round(fma(pcx / zc, intrinsic.fx, intrinsic.cx)).to(torch.int64)
    vi = torch.round(fma(pcy / zc, intrinsic.fy, intrinsic.cy)).to(torch.int64)
    inb = (pcz > 1e-4) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    lin = torch.where(inb, vi * W + ui, 0)
    d = depth_at(lin, inb)
    d_ok = (d > 0) & (d < depth_max)
    sdf = d - pcz
    keep = d_ok & (sdf >= -sdf_trunc)
    tsdf_new = torch.clamp(sdf * (1.0 / sdf_trunc), -1.0, 1.0)
    w_n = keep.to(torch.float32)

    old = tw2[rows]
    old_t = (old >> 16).to(torch.float32) * (1.0 / _TSDF_SCALE)
    old_w = (old & 0xFFFF).to(torch.float32)
    w_sum = old_w + w_n
    inv = 1.0 / torch.clamp(w_sum, min=1e-6)
    upd = w_n > 0
    t_new = torch.where(keep, tsdf_new, 0.0)
    if v1:
        t_new = _hi_lo(t_new)
    t2 = torch.where(upd, fma(old_t, old_w, t_new * w_n) * inv, old_t)
    w2 = torch.clamp(w_sum, max=weight_max)
    tq = torch.round(torch.clamp(t2, -1.0, 1.0) * _TSDF_SCALE).to(torch.int32)
    new_tw = (tq << 16) | w2.to(torch.int32)

    tw2.index_copy_(0, rows, new_tw)
    if col2 is None:
        return
    oldc = col2[rows]
    ro = ((oldc >> 21) & 0x7FF).to(torch.float32) * (1.0 / 2047.0)
    go = ((oldc >> 10) & 0x7FF).to(torch.float32) * (1.0 / 2047.0)
    bo = (oldc & 0x3FF).to(torch.float32) * (1.0 / 1023.0)
    rn, gn, bn = (torch.where(keep, c, 0.0) for c in color_at(lin, inb))
    r2 = torch.where(upd, fma(ro, old_w, rn * w_n) * inv, ro)
    g2 = torch.where(upd, fma(go, old_w, gn * w_n) * inv, go)
    b2 = torch.where(upd, fma(bo, old_w, bn * w_n) * inv, bo)
    ri = torch.clamp(fma(r2, 2047.0, 0.5), 0, 2047).to(torch.int32)
    gi = torch.clamp(fma(g2, 2047.0, 0.5), 0, 2047).to(torch.int32)
    bi = torch.clamp(fma(b2, 1023.0, 0.5), 0, 1023).to(torch.int32)
    new_c = (ri << 21) | (gi << 10) | bi
    col2.index_copy_(0, rows, new_c)


def _hi_lo(x: torch.Tensor) -> torch.Tensor:
    """x through the V1 relayout's bf16 hi + lo split: f32(hi) + f32(lo)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi + lo


def integrate_blocks_plain(
    tw: torch.Tensor,
    color: Optional[torch.Tensor],
    slots: torch.Tensor,
    coords: torch.Tensor,
    d21: torch.Tensor,
    rgb24: Optional[torch.Tensor],
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    voxel_size: float,
    sdf_trunc: float,
    depth_max: float,
    weight_max: float = 10000.0,
) -> None:
    """The kernel's function in plain PyTorch on the d21 and rgb24 images
    (see _integrate_plain)."""
    d21f = d21.reshape(-1)

    def depth_at(lin, inb):
        return torch.where(inb, d21f[lin], 0).to(torch.float32) * (depth_max / _D21)

    def color_at(lin, inb):
        cq = torch.where(inb, rgb24.reshape(-1)[lin], 0) if rgb24 is not None else \
            torch.zeros_like(lin, dtype=torch.int32)
        return (((cq >> 16) & 0xFF).to(torch.float32) * (1.0 / 255.0),
                ((cq >> 8) & 0xFF).to(torch.float32) * (1.0 / 255.0),
                (cq & 0xFF).to(torch.float32) * (1.0 / 255.0))

    H, W = d21.shape
    _integrate_plain(tw, color, slots, coords, intrinsic, extrinsic, voxel_size, sdf_trunc,
                     depth_max, weight_max, H, W, depth_at, color_at)


def integrate_blocks_v2(
    tw: torch.Tensor,  # (C+1, 32, 128) int32, updated in place
    color: Optional[torch.Tensor],  # (C+1, 32, 128) int32 or None
    slots: torch.Tensor,  # (M,) int32 payload rows; C = dump (skipped)
    coords: torch.Tensor,  # (M, 3) int32 block coords
    d21: torch.Tensor,  # (H, W) int32 from prepare_frame
    rgb24: Optional[torch.Tensor],  # (H, W) int32 or None
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,  # (4, 4) world -> camera
    voxel_size: float,
    sdf_trunc: float,
    depth_max: float,
    weight_max: float = 10000.0,
) -> None:
    """Sample and fuse M touched blocks in place (the grid is not copied;
    the JAX package donated it instead). The dump row C stays zero.

    CUDA tensors launch the kernel; CPU tensors run integrate_blocks_plain."""
    dev = tw.device
    C1 = tw.shape[0]
    M = slots.shape[0]
    H, W = intrinsic.height, intrinsic.width
    _check("tw", tw, torch.int32, dev, (C1, 32, 128))
    if color is not None:
        _check("color", color, torch.int32, dev, (C1, 32, 128))
    _check("slots", slots, torch.int32, dev, (M,))
    _check("coords", coords, torch.int32, dev, (M, 3))
    _check("d21", d21, torch.int32, dev, (H, W))
    if rgb24 is not None:
        _check("rgb24", rgb24, torch.int32, dev, (H, W))
    if color is not None and rgb24 is None:
        raise ValueError("color grid given without an rgb24 frame")
    check_aligned("tw", tw)
    if color is not None:
        check_aligned("color", color)

    with span("k1.launch"):
        if dev.type == "cpu":
            integrate_blocks_plain(
                tw, color, slots, coords, d21, rgb24, intrinsic, extrinsic,
                voxel_size, sdf_trunc, depth_max, weight_max,
            )
            return
        if dev.type != "cuda":
            raise ValueError(f"integrate_blocks_v2: unsupported device {dev}")

        params = _params(extrinsic, dev)
        _build.launch(
            "o3dt_integrate_blocks", dev, tw.data_ptr(),
            color.data_ptr() if color is not None else None,
            slots.data_ptr(), coords.data_ptr(), M, C1 - 1,
            d21.data_ptr(), rgb24.data_ptr() if rgb24 is not None else None, H, W,
            params.data_ptr(),
            intrinsic.fx, intrinsic.fy, intrinsic.cx, intrinsic.cy,
            voxel_size, voxel_size * _B, -sdf_trunc, 1.0 / sdf_trunc, depth_max,
            depth_max / _D21, weight_max,
        )
