"""K1, `open3d_tpu_torch/csrc/integrate2.cu:integrate_kernel`: the fused
TSDF integrate of a frame into its touched 16^3 blocks.

Frozen from `chip_smoke.py` as of commit c976156:
`K1_OPS_VOXEL` (line 198) and the byte count at :3851-3852. A call needs,
for each live entry of its work list (a touched block that has a payload
row), its 16 KiB tsdf-weight row and its 16 KiB colour row read once and
written once; the work list's 16 bytes an entry (row and coordinates);
and the frame's d21 depth and rgb24 colour images, 4 bytes a pixel each.
Its float32 operations are 86 a voxel: 56 for tsdf and weight, 30 for
colour (an fma counts two).
"""

from benchmark.counts.peaks import bound_ms

OPS_VOXEL = 86


def bound(n_live: int, n_entries: int, n_pixels: int) -> float:
    """The least ms of one call with `n_live` live blocks among
    `n_entries` work-list entries, on an image of `n_pixels`."""
    n_bytes = n_live * 4 * 4096 * 4 + n_entries * 16 + n_pixels * 4 * 2
    return bound_ms(n_bytes, n_live * 4096 * OPS_VOXEL)
