"""Port parity: the row fuse K3 (its plain version `fuse_blocks_plain`, what
the port runs on the CPU) against the JAX kernel `fuse_blocks` itself, run
interpreted on the CPU as tests/test_pallas_tsdf.py runs it; then the port's
8^3 integrate (`_new_voxel_values` + K3) against the JAX package's
`integrate(..., use_pallas=True)`, which reaches the same kernel.

Bars: the fuse is bit-exact on the packed ints (both colour variants,
B = 8, 16 and 6, dump-row entries in the work list). The integrate uses
tests/test_pallas_tsdf.py's bars: tables identical, weight mismatch < 1e-6 of
voxels, tsdf atol 1e-3 where the weights agree, colour within 2/255 at the
99.9 % quantile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.io import write_voxel_block_grid
from open3d_tpu.ops.pallas import tsdf as jtsdf
from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.ops.kernels import tsdf as tk3

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _fuse_inputs(B, seed, C=40, M=24):
    """A grid with random weights and colours, and a work list of M rows:
    distinct live rows and a few dump-row (C) entries."""
    rng = np.random.default_rng(seed)
    B3 = B**3
    tq = rng.integers(-16383, 16384, (C + 1, B3), dtype=np.int32)
    w = rng.integers(0, 40, (C + 1, B3), dtype=np.int32)
    w[rng.random((C + 1, B3)) < 0.3] = 0
    tw = (tq << 16) | w
    tw[C] = 0
    col = rng.integers(0, 2**31 - 1, (C + 1, B3), dtype=np.int32)
    col[C] = 0
    rows = rng.permutation(C)[:M].astype(np.int32)
    rows[[3, 11, 17]] = C
    tsdf_new = rng.uniform(-1, 1, (M, B3)).astype(np.float32)
    wn = (rng.random((M, B3)) > 0.3).astype(np.float32)
    cnew = rng.integers(0, 2**31 - 1, (M, B3), dtype=np.int32)
    return tw, col, rows, tsdf_new, wn, cnew


@pytest.mark.parametrize("B", [8, 16, 6])  # 6: B^3 = 216, no power of two
@pytest.mark.parametrize("with_color", [True, False])
def test_fuse_plain_matches_interpreted_kernel(B, with_color):
    tw, col, rows, tsdf_new, wn, cnew = _fuse_inputs(B, seed=B + with_color)
    C = tw.shape[0] - 1
    tw_j, col_j = jtsdf.fuse_blocks(
        jnp.asarray(tw), jnp.asarray(col) if with_color else None, jnp.asarray(rows),
        jnp.asarray(tsdf_new), jnp.asarray(wn), jnp.asarray(cnew) if with_color else None,
        weight_max=30.0,
    )
    tw_t, col_t = _t(tw), _t(col)
    tk3.fuse_blocks(tw_t, col_t if with_color else None, _t(rows), _t(tsdf_new), _t(wn),
                    _t(cnew) if with_color else None, weight_max=30.0)
    # the JAX kernel fuses dump-row entries into row C, the port skips them;
    # callers re-zero row C, so rows 0..C-1 are the result
    np.testing.assert_array_equal(np.asarray(tw_j)[:C], tw_t.numpy()[:C])
    assert int(tw_t[C].abs().sum()) == 0
    live = rows[rows < C]
    assert (tw_t.numpy()[live] != tw[live]).any()
    assert ((tw_t.numpy()[live] & 0xFFFF) <= 30).all()  # weight_max clip
    if with_color:
        np.testing.assert_array_equal(np.asarray(col_j)[:C], col_t.numpy()[:C])
    else:
        assert col_j is None and np.array_equal(col_t.numpy(), col)


def _one_frame_jax(vbg, intr, depth, color, extr):
    keys, _ = jvbg.compute_unique_block_coordinates(
        vbg, depth, intr, extr, depth_max=3.0, frame_block_capacity=512
    )
    return jvbg.integrate(vbg, keys, depth, color, intr, extr, depth_max=3.0, use_pallas=True)


def _one_frame_port(vbg, intr, depth, color, extr):
    keys, _ = tvbg.compute_unique_block_coordinates(
        vbg, depth, intr, extr, depth_max=3.0, frame_block_capacity=512
    )
    return tvbg.integrate(vbg, keys, depth, color, intr, extr, depth_max=3.0)


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = jsyn.render_sequence(2, intrinsic=JIntr(*INTR), span=0.1)
    return np.asarray(d), np.asarray(c), np.asarray(e)


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_8cubed_matches_jax(frames, with_color):
    d, c, e = frames
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jvbg.create(voxel_size=0.02, block_resolution=8, block_count=1024, with_color=with_color)
    vt = tvbg.create(voxel_size=0.02, block_resolution=8, block_count=1024, with_color=with_color,
                     device="cpu")
    assert tuple(vt.tw.shape) == tuple(vj.tw.shape) == (1025, 4, 128)
    for i in range(2):
        cj = c[i] if with_color else None
        vj = _one_frame_jax(vj, ji, d[i], cj, e[i])
        vt = _one_frame_port(vt, ti, _t(d[i]), _t(c[i]) if with_color else None, _t(e[i]))
    np.testing.assert_array_equal(np.asarray(vj.table), vt.table.numpy())
    ta, wa = (np.asarray(x) for x in vj.tsdf_weight())
    tb, wb = (x.numpy() for x in vt.tsdf_weight())
    diff = wa != wb
    assert diff.mean() < 1e-6, diff.mean()
    assert int((wb > 0).sum()) > 20000
    np.testing.assert_allclose(ta[~diff], tb[~diff], atol=1e-3, rtol=0)
    if with_color:
        err = np.abs(np.asarray(vj.color_f32()) - vt.color_f32().numpy())[~diff].max(axis=-1)
        assert np.quantile(err, 0.999) <= 2.0 / 255.0
    assert int(vt.tw[-1].abs().sum()) == 0


def test_vbg_8cubed_carried_across(frames, tmp_path):
    """JAX -> numpy (the checkpoint schema) -> port -> numpy, bit-identical,
    for an 8^3 grid: its payload is (C+1, 4, 128) in both packages."""
    d, c, e = frames
    ji = JIntr(*INTR)
    vj = jvbg.create(voxel_size=0.02, block_resolution=8, block_count=512)
    vj = _one_frame_jax(vj, ji, d[0], c[0], e[0])
    path = str(tmp_path / "grid.npz")
    write_voxel_block_grid(path, vj)
    arrays = dict(np.load(path))
    vt = convert.vbg_from_numpy(**arrays, device="cpu")
    assert tuple(vt.tw.shape) == tuple(vj.tw.shape) == (513, 4, 128)
    assert tuple(vt.color.shape) == tuple(vj.color.shape)
    back = convert.vbg_to_numpy(vt)
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype and np.array_equal(back[k], arrays[k]), k
