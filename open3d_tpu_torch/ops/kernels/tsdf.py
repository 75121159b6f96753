"""In-place weighted-mean fuse of precomputed voxel samples into the rows of
a TSDF voxel block grid (port of open3d_tpu/ops/pallas/tsdf.py).

`fuse_blocks` launches the CUDA kernel in `csrc/tsdf.cu` for CUDA tensors
and runs `fuse_blocks_plain`, the same function in plain PyTorch, for CPU
tensors. Nothing falls back: a CUDA tensor either launches the kernel or
raises.

Replaces: open3d_tpu/ops/pallas/tsdf.py:_fuse_kernel_color and
_fuse_kernel_nocolor (via fuse_blocks). Any block resolution: a payload row
is B^3 voxels, 512 for the 8^3 blocks of the reconstruction system's
fragments.
Bound: bytes. A live row reads its tsdf sample (4 B), weight sample (4 B)
and colour sample (4 B) and its tw and colour words (8 B), and writes the
two words back (8 B): 28 B a voxel, against ~30 float32 operations. The
kernel reads and writes each word once: a CTA scans eight work-list
entries and its threads take the live rows' 4-voxel groups, issuing each
group's five 16-byte loads in one burst, so every row and sample tensor
must start on a 16-byte boundary when B^3 % 4 == 0 (the wrapper checks;
other block sizes go one voxel a group).

Function: the running weighted mean of the JAX kernels, their s1.14 | u16
tsdf/weight repack with round-half-to-even, and the R11|G11|B10 colour
repack with +0.5 and truncation (not pack_rgb's round). The colour variant
multiplies by inv = 1 / max(w_sum, 1e-6); the no-colour variant divides.
Entries whose row is the dump row C are skipped; the caller re-zeroes row
C, as in the JAX package.

Rounding: every product and sum rounds on its own, as XLA's CPU backend
computes the interpreted JAX kernels (the reference of the CPU tests): it
fuses no multiply-add there, and the kernel is built with --fmad=false.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_aligned
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.utils.timer import span

_TSDF_SCALE = 16383.0


def fuse_blocks_plain(
    tw: torch.Tensor,
    color: Optional[torch.Tensor],
    rows: torch.Tensor,
    tsdf_new: torch.Tensor,
    wn: torch.Tensor,
    cnew: Optional[torch.Tensor],
    weight_max: float = 10000.0,
) -> None:
    """The kernels' function in plain PyTorch over (M, B^3), in place on
    the rows of `tw` (and `color`) that `rows` names. Dump-row entries are
    written back unchanged, so row C keeps whatever it held."""
    C = tw.shape[0] - 1
    live = (rows >= 0) & (rows < C)
    r = torch.where(live, rows, C).to(torch.int64)
    old = tw[r]
    old_t = (old >> 16).to(torch.float32) * (1.0 / _TSDF_SCALE)
    old_w = (old & 0xFFFF).to(torch.float32)
    w_sum = old_w + wn
    upd = wn > 0
    num = old_t * old_w + tsdf_new * wn
    if cnew is None:
        t2 = torch.where(upd, num / torch.clamp(w_sum, min=1e-6), old_t)
    else:
        inv = 1.0 / torch.clamp(w_sum, min=1e-6)
        t2 = torch.where(upd, num * inv, old_t)
    w2 = torch.clamp(w_sum, max=weight_max)
    tq = torch.round(torch.clamp(t2, -1.0, 1.0) * _TSDF_SCALE).to(torch.int32)
    new_tw = (tq << 16) | w2.to(torch.int32)
    tw.index_copy_(0, r, torch.where(live[:, None], new_tw, old))
    if cnew is None:
        return

    def unpack(c):
        return (((c >> 21) & 0x7FF).to(torch.float32) * (1.0 / 2047.0),
                ((c >> 10) & 0x7FF).to(torch.float32) * (1.0 / 2047.0),
                (c & 0x3FF).to(torch.float32) * (1.0 / 1023.0))

    oldc = color[r]
    packed = []
    for o, n, scale, hi in zip(unpack(oldc), unpack(cnew), (2047.0, 2047.0, 1023.0),
                               (2047, 2047, 1023)):
        v = torch.where(upd, (o * old_w + n * wn) * inv, o)
        packed.append(torch.clamp(v * scale + 0.5, 0, hi).to(torch.int32))
    new_c = (packed[0] << 21) | (packed[1] << 10) | packed[2]
    color.index_copy_(0, r, torch.where(live[:, None], new_c, oldc))


def fuse_blocks(
    tw: torch.Tensor,  # (C+1, B^3) int32, updated in place
    color: Optional[torch.Tensor],  # (C+1, B^3) int32 or None
    rows: torch.Tensor,  # (M,) int32 payload rows; C = dump (skipped)
    tsdf_new: torch.Tensor,  # (M, B^3) float32
    wn: torch.Tensor,  # (M, B^3) float32, 0 or 1
    cnew: Optional[torch.Tensor],  # (M, B^3) int32 packed colour, or None
    weight_max: float = 10000.0,
) -> None:
    """Fuse M rows of per-voxel samples into the grid in place. Colour is
    fused when `cnew` is given, and then `color` must be too. Row C is not
    cleared here: callers re-zero it.

    CUDA tensors launch the kernel; CPU tensors run fuse_blocks_plain."""
    dev = tw.device
    if tw.ndim != 2:
        raise ValueError(f"tw: expected (C+1, B^3), got {tuple(tw.shape)}")
    C1, B3 = tw.shape
    M = rows.shape[0]
    _check("tw", tw, torch.int32, dev, (C1, B3))
    if (color is None) != (cnew is None):
        raise ValueError("color and cnew go together: pass both or neither")
    if color is not None:
        _check("color", color, torch.int32, dev, (C1, B3))
        _check("cnew", cnew, torch.int32, dev, (M, B3))
    _check("rows", rows, torch.int32, dev, (M,))
    _check("tsdf_new", tsdf_new, torch.float32, dev, (M, B3))
    _check("wn", wn, torch.float32, dev, (M, B3))
    if B3 % 4 == 0:
        for name, t in (("tw", tw), ("color", color), ("tsdf_new", tsdf_new), ("wn", wn),
                        ("cnew", cnew)):
            if t is not None:
                check_aligned(name, t)

    with span("k3.launch"):
        if dev.type == "cpu":
            fuse_blocks_plain(tw, color, rows, tsdf_new, wn, cnew, weight_max)
            return
        if dev.type != "cuda":
            raise ValueError(f"fuse_blocks: unsupported device {dev}")

        _build.launch(
            "o3dt_fuse_blocks", dev, tw.data_ptr(), color.data_ptr() if color is not None else None,
            rows.data_ptr(), tsdf_new.data_ptr(), wn.data_ptr(),
            cnew.data_ptr() if cnew is not None else None,
            M, C1 - 1, B3, weight_max,
        )


def occupancy(with_color: bool, B3: int) -> dict:
    """The kernel for this variant and row size on the card: CTAs a
    multiprocessor, multiprocessors, threads a CTA, registers a thread."""
    return _build.occupancy("o3dt_fuse_occupancy", int(with_color), B3)


def synthetic_work_list(generator: torch.Generator, device, C: int = 8192, M: int = 4096,
                        n_live: int = 395, B: int = 8):
    """Inputs shaped like a fragment frame's (the reconstruction defaults:
    8192 blocks of 8^3, a 4096-entry work list of which about 395 are live):
    tw words of random tsdf and weights below 64, random colour words, the
    first n_live entries distinct random rows (unique_keys packs the live
    keys first) and the rest the dump row C, random samples. Returns (tw,
    color, rows, tsdf_new, wn, cnew)."""
    g, dev, B3 = generator, device, B**3
    tw = torch.randint(-2**31, 2**31 - 1, (C + 1, B3), generator=g, device=dev,
                       dtype=torch.int32) & ~0xFFC0
    color = torch.randint(0, 2**31 - 1, (C + 1, B3), generator=g, device=dev, dtype=torch.int32)
    rows = torch.full((M,), C, dtype=torch.int32, device=dev)
    rows[:n_live] = torch.randperm(C, generator=g, device=dev)[:n_live].to(torch.int32)
    tsdf_new = torch.rand((M, B3), generator=g, device=dev) * 2 - 1
    wn = (torch.rand((M, B3), generator=g, device=dev) > 0.3).float()
    cnew = torch.randint(0, 2**31 - 1, (M, B3), generator=g, device=dev, dtype=torch.int32)
    return tw, color, rows, tsdf_new, wn, cnew
