"""K3, `open3d_tpu_torch/csrc/tsdf.cu:fuse_kernel`: the row fuse of a
frame's per-voxel samples into an 8^3-block grid (the fragment grid).

Frozen from `chip_smoke.py` as of commit c976156:
`K3_OPS_VOXEL` and `K3_BYTES_VOXEL` (lines 211-212) and the counts at
:549-551. For each live row of the work list it reads the new tsdf, the
new weight, the new colour, the old tsdf-weight word and the old colour
word, and writes the two words back: 28 bytes a voxel, 32 float32
operations; and the work list's 4 bytes an entry. No cell of the
benchmark runs K3 yet; the count waits for the fragment cell.
"""

from benchmark.counts.peaks import bound_ms

OPS_VOXEL = 32
BYTES_VOXEL = 28


def bound(n_live: int, n_entries: int, voxels_per_block: int = 512) -> float:
    return bound_ms(n_live * voxels_per_block * BYTES_VOXEL + n_entries * 4,
                    n_live * voxels_per_block * OPS_VOXEL)
