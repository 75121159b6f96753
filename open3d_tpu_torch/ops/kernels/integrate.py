"""Fused TSDF integrate of the touched 16^3 blocks from bf16 frame planes
(port of open3d_tpu/ops/pallas/integrate.py, the V1 integrate that
voxel_block_grid.integrate takes when O3DTPU_INTEGRATE_V1 is set).

`integrate_blocks` launches the CUDA kernel in `csrc/integrate2.cu`, built
in its bf16-plane mode, for CUDA tensors and runs
`integrate_blocks_plain_v1` for CPU tensors. Nothing falls back.

Replaces: open3d_tpu/ops/pallas/integrate.py:_integrate_kernel (via
integrate_blocks), with its planes from prepare_planes.
Bound: bytes, as K1: each touched block reads and writes its 16 KiB tw and
colour rows; the kernel reads each once and gathers five 2-byte plane
samples a voxel from the frame. It is K1's template, so K1's design holds:
a thread issues the five plane gathers of its 4 voxels with its two
16-byte row loads in one burst before it computes (the rows must be
16-byte aligned; the wrapper checks).

What it computes is the V1 kernel's function on a block that its slab
window covers: K1's projection, keep rule and running mean, with two
sample formats of its own:
- depth is d_hi + d_lo with d_hi = bf16(d) and d_lo = bf16(d - d_hi), about
  17 bits; colour is the bf16 of each float channel;
- the new tsdf reaches the fuse through the V1 kernel's relayout matmul,
  which splits each f32 value into bf16 words hi = bf16(t) and
  lo = bf16(t - hi) and adds them back: t' = hi + lo. The plain version
  and the kernel apply that split, so their rows match the interpreted JAX
  kernel's bit for bit. The weight (0 or 1) and the bf16 colours pass the
  split unchanged.
The one-hot MXU selects, the 64-lane shifted plane copy, the slab windows
and the fit flags are TPU mechanics and are not reproduced: every block of
the work list integrates in one launch, with no XLA fallback.

The plain version is K1's (`integrate2._integrate_plain`) with these
samples, projection and split, as the kernel is K1's template.

Rounding: multiply-adds are fused where XLA's CPU backend fuses them in the
interpreted JAX kernel (fmaf in the kernel, `_plain.fma` in the plain
version): the voxel
position and both product pairs of each projection row, fma(R02, pwz,
fma(R00, pwx, R01 * pwy)) + tX, where K1 fuses only the first (measured
against the interpreter: the other forms flip a few voxels' pixels); and,
as in K1, the pixel coordinate, the running means and the colour repack,
where the interpreter's rows match either form.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_aligned
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels.integrate2 import _integrate_plain, _params
from open3d_tpu_torch.utils.timer import span

_B = 16
N_PLANES = 5  # d_hi, d_lo, r, g, b


def prepare_planes(depth: torch.Tensor, color: Optional[torch.Tensor], with_color: bool):
    """The frame as the kernel samples it: (5, H, W) bfloat16 planes
    [d_hi | d_lo | r | g | b]. d_hi + d_lo restore ~17 bits of the float32
    depth; 8-bit colours are exact in bf16. Without colour the colour planes
    are zero. The role of the JAX prepare_planes without its padding and
    shifted copy."""
    d_hi = depth.to(torch.bfloat16).to(torch.float32)
    d_lo = depth - d_hi
    if with_color and color is not None:
        planes = [d_hi, d_lo, color[..., 0], color[..., 1], color[..., 2]]
    else:
        z = torch.zeros_like(depth)
        planes = [d_hi, d_lo, z, z, z]
    return torch.stack(planes, dim=0).to(torch.bfloat16).contiguous()


def integrate_blocks_plain_v1(
    tw: torch.Tensor,
    color: Optional[torch.Tensor],
    slots: torch.Tensor,
    coords: torch.Tensor,
    planes: torch.Tensor,
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,
    voxel_size: float,
    sdf_trunc: float,
    depth_max: float,
    weight_max: float = 10000.0,
) -> None:
    """The kernel's function in plain PyTorch on the bf16 planes: K1's plain
    version with the V1 samples, projection and relayout split."""
    H, W = planes.shape[1], planes.shape[2]
    pl = planes.reshape(N_PLANES, H * W).to(torch.float32)

    def depth_at(lin, inb):
        return torch.where(inb, pl[0][lin] + pl[1][lin], 0.0)

    def color_at(lin, inb):
        return pl[2][lin], pl[3][lin], pl[4][lin]

    _integrate_plain(tw, color, slots, coords, intrinsic, extrinsic, voxel_size, sdf_trunc,
                     depth_max, weight_max, H, W, depth_at, color_at, v1=True)


def integrate_blocks(
    tw: torch.Tensor,  # (C+1, 32, 128) int32, updated in place
    color: Optional[torch.Tensor],  # (C+1, 32, 128) int32 or None
    slots: torch.Tensor,  # (M,) int32 payload rows; C = dump (skipped)
    coords: torch.Tensor,  # (M, 3) int32 block coords
    planes: torch.Tensor,  # (5, H, W) bfloat16 from prepare_planes
    intrinsic: PinholeCameraIntrinsic,
    extrinsic: torch.Tensor,  # (4, 4) world -> camera
    voxel_size: float,
    sdf_trunc: float,
    depth_max: float,
    weight_max: float = 10000.0,
) -> None:
    """Sample and fuse M touched blocks in place. The dump row C stays zero.

    CUDA tensors launch the kernel; CPU tensors run integrate_blocks_plain_v1."""
    dev = tw.device
    C1 = tw.shape[0]
    M = slots.shape[0]
    H, W = intrinsic.height, intrinsic.width
    _check("tw", tw, torch.int32, dev, (C1, 32, 128))
    if color is not None:
        _check("color", color, torch.int32, dev, (C1, 32, 128))
    _check("slots", slots, torch.int32, dev, (M,))
    _check("coords", coords, torch.int32, dev, (M, 3))
    _check("planes", planes, torch.bfloat16, dev, (N_PLANES, H, W))
    check_aligned("tw", tw)
    if color is not None:
        check_aligned("color", color)

    with span("k4.launch"):
        if dev.type == "cpu":
            integrate_blocks_plain_v1(
                tw, color, slots, coords, planes, intrinsic, extrinsic,
                voxel_size, sdf_trunc, depth_max, weight_max,
            )
            return
        if dev.type != "cuda":
            raise ValueError(f"integrate_blocks: unsupported device {dev}")

        params = _params(extrinsic, dev)
        _build.launch(
            "o3dt_integrate_blocks_v1", dev,
            tw.data_ptr(), color.data_ptr() if color is not None else None,
            slots.data_ptr(), coords.data_ptr(), M, C1 - 1,
            planes.data_ptr(), H, W, params.data_ptr(),
            intrinsic.fx, intrinsic.fy, intrinsic.cx, intrinsic.cy,
            voxel_size, voxel_size * _B, -sdf_trunc, 1.0 / sdf_trunc, depth_max,
            weight_max,
        )
