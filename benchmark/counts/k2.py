"""K2, `open3d_tpu_torch/csrc/raycast.cu:march_kernel`: the tile march that
renders the model's depth.

Frozen from `chip_smoke.py` as of commit c976156: the
operation counts `K2_OPS_RAY`, `K2_OPS_CHORD`, `K2_OPS_SAMPLE` and
`K2_OPS_CROSS` (lines 200-203) and the byte and operation counts at
:3950-3958. The work is what the march's function needs on the call's
inputs, which the reference's march (`reference/grid.py:march` with
`stats`) walks: the distinct 32-byte sectors its samples read before the
break, the (tile, block) steps, the (ray, block) chords and the crossings.
Bytes: the sampled sectors, 16 bytes a walked list entry, the per-tile
counts and the depth written. Operations: 21 a ray (its direction), 23 a
ray for each (tile, block) step (three slab chords and the step), 1 + 6 x
12 for each chord sampled (the contiguity test, six samples), 35 a
crossing (the bracket's voxel-centre parameters and the interpolation).
"""

from benchmark.counts.peaks import bound_ms

OPS_RAY = 21
OPS_CHORD = 23
OPS_SAMPLE = 12
OPS_CROSS = 35
SAMPLES = 6


def bound(stats: dict, width: int, height: int) -> float:
    """The least ms of one march whose walk `stats` describes."""
    pixels = width * height
    n_bytes = (stats["sectors_sampled"] * 32 + stats["pairs_visited"] * 16
               + stats["tiles"] * 4 + 4 + pixels * 4)
    n_ops = (pixels * OPS_RAY + stats["pairs_visited"] * 256 * OPS_CHORD
             + stats["ray_blocks"] * (1 + SAMPLES * OPS_SAMPLE) + stats["crossings"] * OPS_CROSS)
    return bound_ms(n_bytes, n_ops)
