"""Port parity: the touch + integrate stage of open3d_tpu_torch against
open3d_tpu, at 160x120 on the synthetic scene.

- compute_unique_block_coordinates and the hash activation: identical keys,
  counts and tables (deterministic integer work on the same float inputs).
- integrate_blocks_plain (the K1 kernel's plain version, what the port runs
  on the CPU) against the JAX kernel integrate_blocks_v2 itself, run
  interpreted as tests/test_pallas_tsdf.py runs it, on the same grid state
  and work list. Every block of the work list fits the kernel's slab
  window, so no block needs the JAX package's XLA fallback (asserted).
  Bars: weight mismatch < 1e-6 of voxels, tsdf atol 1e-3 where the weights
  agree (one s1.14 LSB is 6e-5), colour within 1/2047.
- the port's integrate against the JAX XLA integrate (use_pallas=False)
  over two frames, with the bars of tests/test_pallas_tsdf.py: the XLA path
  samples float32 depth and 11-bit colour where the kernel samples d21 and
  8-bit colour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import hashmap as jhm
from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.ops.pallas import integrate as jpint
from open3d_tpu.ops.pallas import integrate2 as jpint2
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import hashmap as thm
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.ops.kernels import integrate2 as tk1

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
VOXEL = 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = jsyn.render_sequence(2, intrinsic=JIntr(*INTR), span=0.1)
    return np.asarray(d), np.asarray(c), np.asarray(e)


def _to_port(vbg):
    return convert.vbg_from_numpy(
        np.asarray(vbg.table), np.asarray(vbg.tw), np.asarray(vbg.color),
        vbg.voxel_size, vbg.block_resolution, vbg.sdf_trunc, device="cpu",
    )


def _weights_tsdf(tw):
    tw = np.asarray(tw).reshape(-1)
    return tw & 0xFFFF, (tw >> 16).astype(np.float32) / 16383.0


@pytest.mark.parametrize("frame", [0, 1])
def test_unique_block_coordinates(frames, frame):
    d, _, e = frames
    vj = jvbg.create(voxel_size=VOXEL, block_count=1024)
    vt = tvbg.create(voxel_size=VOXEL, block_count=1024, device="cpu")
    kj, cj = jvbg.compute_unique_block_coordinates(vj, d[frame], JIntr(*INTR), e[frame], 3.0, frame_block_capacity=256)
    kt, ct = tvbg.compute_unique_block_coordinates(vt, _t(d[frame]), TIntr(*INTR), _t(e[frame]), 3.0, frame_block_capacity=256)
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    assert int(cj) == int(ct) > 0


def test_codecs_and_frame_prep(frames):
    rng = np.random.default_rng(0)
    ts = rng.uniform(-1.2, 1.2, 5000).astype(np.float32)
    w = rng.integers(0, 70000, 5000).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jvbg.pack_tw(ts, w)), tvbg.pack_tw(_t(ts), _t(w)).numpy())
    packed = np.asarray(jvbg.pack_tw(ts, w))
    for a, b in zip(jvbg.unpack_tw(packed), tvbg.unpack_tw(_t(packed))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rgb = rng.uniform(-0.1, 1.1, (5000, 3)).astype(np.float32)
    pj = np.asarray(jvbg.pack_rgb(rgb))
    np.testing.assert_array_equal(pj, tvbg.pack_rgb(_t(rgb)).numpy())
    np.testing.assert_array_equal(np.asarray(jvbg.unpack_rgb(pj)), tvbg.unpack_rgb(_t(pj)).numpy())
    # the kernel's frame prep: d21 and rgb24 as the JAX int8 subplanes encode them
    d, c, _ = frames
    dep = d[0].copy()
    dep[:3, :3] = [np.nan, -1.0, 3.0 - 1e-7]
    planes = np.asarray(jpint2.prepare_planes_v2(dep, c[0], True, 3.0)).astype(np.int32)
    Hp = planes.shape[0] // (2 * jpint2._NSUB)
    sub = [planes[p * Hp : p * Hp + 120, :160] & 0xFF for p in range(jpint2._NSUB)]
    d21_j = (sub[0] << 14) | (sub[1] << 7) | sub[2]
    rgb_j = (sub[3] << 18) | (sub[4] << 12) | (sub[5] << 6) | sub[6]
    d21_t, rgb_t = tk1.prepare_frame(_t(dep), _t(c[0]), 3.0)
    np.testing.assert_array_equal(d21_j, d21_t.numpy())
    np.testing.assert_array_equal(rgb_j, rgb_t.numpy())


def test_plain_integrate_matches_interpreted_kernel(frames):
    """Frame 0 through the JAX XLA path gives both packages the same grid;
    frame 1 then goes through the JAX kernel (interpreted) and through the
    port's plain version, so the running means start from weights > 0."""
    d, c, e = frames
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jvbg.create(voxel_size=VOXEL, block_count=1024)
    k0, _ = jvbg.compute_unique_block_coordinates(vj, d[0], ji, e[0], 3.0, frame_block_capacity=256)
    vj = jvbg.integrate(vj, k0, d[0], c[0], ji, e[0], depth_max=3.0, use_pallas=False)
    vt = _to_port(vj)

    keys, _ = jvbg.compute_unique_block_coordinates(vj, d[1], ji, e[1], 3.0, frame_block_capacity=64)
    coords = jhm.unpack_coords(keys)
    hp, wp = jpint2.plane_dims(ji.height, ji.width)
    v0, u0, shift, fit = jpint.block_slab_fit(
        coords, ji, e[1], VOXEL, valign=jpint2._VALIGN, vwin=jpint2._VWIN, hp=hp, wp=wp
    )
    valid = np.asarray(jhm.is_valid(keys))
    keys = np.where((np.asarray(fit) == 1)[:, None], np.asarray(keys), 0)
    live = jhm.is_valid(jnp.asarray(keys))
    # the work list holds only blocks the kernel's window covers: nothing
    # would reach the XLA fallback
    assert int(live.sum()) >= 40 and int(live.sum()) >= valid.sum() - 8
    table, slot, ok = jhm.activate(vj.table, jnp.asarray(keys))
    C = vj.capacity
    rows = jnp.where(ok, slot, C).astype(jnp.int32)
    planes = jpint2.prepare_planes_v2(d[1], c[1], True, 3.0)
    tw_j, col_j = jpint2.integrate_blocks_v2(
        vj.tw, vj.color, rows, coords, v0, u0, shift, fit, planes, ji, e[1],
        VOXEL, vj.sdf_trunc, 3.0, interpret=True,
    )

    tt, st, okt = thm.activate(vt.table, _t(keys))
    np.testing.assert_array_equal(np.asarray(table), tt.numpy())
    rows_t = torch.where(okt, st, C).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(rows), rows_t.numpy())
    d21, rgb24 = tk1.prepare_frame(_t(d[1]), _t(c[1]), 3.0)
    tk1.integrate_blocks_v2(
        vt.tw, vt.color, rows_t, thm.unpack_coords(_t(keys)), d21, rgb24, ti, _t(e[1]),
        VOXEL, vt.sdf_trunc, 3.0,
    )
    wa, ta = _weights_tsdf(tw_j)
    wb, tb = _weights_tsdf(vt.tw)
    diff = wa != wb
    assert diff.mean() < 1e-6, diff.sum()
    np.testing.assert_allclose(ta[~diff], tb[~diff], atol=1e-3, rtol=0)
    ca = np.asarray(jvbg.unpack_rgb(np.asarray(col_j).reshape(-1)))
    cb = tvbg.unpack_rgb(vt.color.reshape(-1)).numpy()
    assert np.abs(ca - cb)[~diff].max() <= 1.0 / 2047.0 + 1e-7
    assert int(np.asarray(vt.tw)[C].sum()) == 0


def test_plain_integrate_skips_dump_entries_as_the_kernel_does(frames):
    """A work list mostly of dump entries, as integrate_scene's
    frame_block_capacity of 8192 gives: frame 1's keys at capacity 256,
    shuffled so the dump entries lie between live ones. The plain version
    (which leaves dump entries out before computing) against the JAX
    kernel, interpreted, at the bars above; and bit-equal to itself on the
    live entries alone, with every row outside the work list and the dump
    row unchanged."""
    d, c, e = frames
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jvbg.create(voxel_size=VOXEL, block_count=1024)
    k0, _ = jvbg.compute_unique_block_coordinates(vj, d[0], ji, e[0], 3.0, frame_block_capacity=256)
    vj = jvbg.integrate(vj, k0, d[0], c[0], ji, e[0], depth_max=3.0, use_pallas=False)
    vt = _to_port(vj)

    keys, _ = jvbg.compute_unique_block_coordinates(vj, d[1], ji, e[1], 3.0, frame_block_capacity=256)
    keys = np.asarray(keys)[np.random.default_rng(1).permutation(256)]
    coords = jhm.unpack_coords(jnp.asarray(keys))
    hp, wp = jpint2.plane_dims(ji.height, ji.width)
    v0, u0, shift, fit = jpint.block_slab_fit(
        coords, ji, e[1], VOXEL, valign=jpint2._VALIGN, vwin=jpint2._VWIN, hp=hp, wp=wp
    )
    keys = np.where((np.asarray(fit) == 1)[:, None], keys, 0)
    C = vj.capacity
    table, slot, ok = jhm.activate(vj.table, jnp.asarray(keys))
    rows = jnp.where(ok, slot, C).astype(jnp.int32)
    live = np.asarray(rows) < C
    assert 40 <= live.sum() < 0.5 * live.size and not live[: live.sum()].all()
    planes = jpint2.prepare_planes_v2(d[1], c[1], True, 3.0)
    tw_j, col_j = jpint2.integrate_blocks_v2(
        vj.tw, vj.color, rows, coords, v0, u0, shift, fit, planes, ji, e[1],
        VOXEL, vj.sdf_trunc, 3.0, interpret=True,
    )

    rows_t = _t(rows)
    coords_t = thm.unpack_coords(_t(keys))
    d21, rgb24 = tk1.prepare_frame(_t(d[1]), _t(c[1]), 3.0)
    tail = (ti, _t(e[1]), VOXEL, vt.sdf_trunc, 3.0)
    tw0, col0 = vt.tw.clone(), vt.color.clone()
    tk1.integrate_blocks_plain(vt.tw, vt.color, rows_t, coords_t, d21, rgb24, *tail)
    wa, ta = _weights_tsdf(tw_j)
    wb, tb = _weights_tsdf(vt.tw)
    diff = wa != wb
    assert diff.mean() < 1e-6, diff.sum()
    np.testing.assert_allclose(ta[~diff], tb[~diff], atol=1e-3, rtol=0)
    ca = np.asarray(jvbg.unpack_rgb(np.asarray(col_j).reshape(-1)))
    cb = tvbg.unpack_rgb(vt.color.reshape(-1)).numpy()
    assert np.abs(ca - cb)[~diff].max() <= 1.0 / 2047.0 + 1e-7

    tw1, col1 = tw0.clone(), col0.clone()
    sel = torch.from_numpy(live)
    tk1.integrate_blocks_plain(tw1, col1, rows_t[sel], coords_t[sel], d21, rgb24, *tail)
    assert torch.equal(tw1, vt.tw) and torch.equal(col1, vt.color)
    outside = torch.ones(C + 1, dtype=torch.bool)
    outside[rows_t[sel].long()] = False
    assert torch.equal(vt.tw[outside], tw0[outside]) and torch.equal(vt.color[outside], col0[outside])
    assert int(vt.tw[C].abs().sum()) == 0 and int(vt.color[C].abs().sum()) == 0


def test_integrate_matches_xla_path(frames):
    d, c, e = frames
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jvbg.create(voxel_size=VOXEL, block_count=1024)
    vt = tvbg.create(voxel_size=VOXEL, block_count=1024, device="cpu")
    for i in range(2):
        kj, _ = jvbg.compute_unique_block_coordinates(vj, d[i], ji, e[i], 3.0, frame_block_capacity=256)
        vj = jvbg.integrate(vj, kj, d[i], c[i], ji, e[i], depth_max=3.0, use_pallas=False)
        kt, _ = tvbg.compute_unique_block_coordinates(vt, _t(d[i]), ti, _t(e[i]), 3.0, frame_block_capacity=256)
        vt = tvbg.integrate(vt, kt, _t(d[i]), _t(c[i]), ti, _t(e[i]), depth_max=3.0)
    np.testing.assert_array_equal(np.asarray(vj.table), vt.table.numpy())
    wa, ta = _weights_tsdf(vj.tw)
    wb, tb = _weights_tsdf(vt.tw)
    diff = wa != wb
    assert diff.mean() < 1e-6, diff.sum()
    assert np.abs(wa.astype(np.int64) - wb)[diff].max(initial=0) <= 1
    np.testing.assert_allclose(ta[~diff], tb[~diff], atol=1e-3, rtol=0)
    ca = np.asarray(vj.color_f32())
    cb = vt.color_f32().numpy()
    err = np.abs(ca - cb).max(axis=-1).reshape(-1)[~diff]
    assert np.quantile(err, 0.999) <= 2.0 / 255.0, np.quantile(err, 0.999)
    assert (err > 2.0 / 255.0).mean() < 1e-3
    assert int(np.asarray(vt.tw)[-1].sum()) == 0 and int(np.asarray(vt.color)[-1].sum()) == 0
