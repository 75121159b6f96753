"""Port parity: the V1 integrate (K4's plain version, what the port runs on
the CPU) against the JAX kernel integrate_blocks itself, run interpreted as
tests/test_pallas_tsdf.py runs it, on the same grid state and work list, at
160x120. Every block of the work list fits the JAX kernel's slab window
(asserted), so the JAX kernel integrates all of them, as the port's does.

Bars (K1's): weight mismatch < 1e-6 of voxels, tsdf atol 1e-3 where the
weights agree, colour within 1/2047. The plain version emulates the V1
kernel's bf16 hi+lo depth and relayout split, so the rows in fact agree bit
for bit (asserted too).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import hashmap as jhm
from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.ops.pallas import integrate as jpint
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import hashmap as thm
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.ops.kernels import integrate as tk4

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)
VOXEL = 0.01
M_MAX = 32


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = jsyn.render_sequence(2, intrinsic=JIntr(*INTR), span=0.1)
    return np.asarray(d), np.asarray(c), np.asarray(e)


def test_prepare_planes_matches_jax(frames):
    d, c, _ = frames
    for with_color in (True, False):
        pj = np.asarray(jpint.prepare_planes(jnp.asarray(d[0]), jnp.asarray(c[0]), with_color))
        Hp = pj.shape[0] // 10
        pt = tk4.prepare_planes(_t(d[0]), _t(c[0]), with_color)
        for k in range(5):
            np.testing.assert_array_equal(
                pj[k * Hp : k * Hp + 120, :160].astype(np.float32), pt[k].to(torch.float32).numpy()
            )


@pytest.mark.parametrize("with_color", [True, False])
def test_plain_v1_matches_interpreted_kernel(frames, with_color):
    """Frame 0 through the JAX XLA path gives both packages the same grid;
    frame 1 goes through the JAX V1 kernel (interpreted) and the port's
    plain version, so the running means start from weights > 0."""
    d, c, e = frames
    ji, ti = JIntr(*INTR), TIntr(*INTR)
    vj = jvbg.create(voxel_size=VOXEL, block_count=256, with_color=with_color)
    cj = c[0] if with_color else None
    k0, _ = jvbg.compute_unique_block_coordinates(vj, d[0], ji, e[0], 3.0, frame_block_capacity=256)
    vj = jvbg.integrate(vj, k0, d[0], cj, ji, e[0], depth_max=3.0, use_pallas=False)
    vt = convert.vbg_from_numpy(
        np.asarray(vj.table), np.asarray(vj.tw), np.asarray(vj.color), vj.voxel_size,
        vj.block_resolution, vj.sdf_trunc, device="cpu",
    )

    keys, _ = jvbg.compute_unique_block_coordinates(vj, d[1], ji, e[1], 3.0, frame_block_capacity=M_MAX)
    coords = jhm.unpack_coords(keys)
    v0, u0, shift, fit = jpint.block_slab_fit(coords, ji, e[1], VOXEL)
    valid = np.asarray(jhm.is_valid(keys))
    assert valid.sum() >= 24
    assert (np.asarray(fit)[valid] == 1).all(), "every block fits the JAX kernel's window"
    table, slot, ok = jhm.activate(vj.table, keys)
    C = vj.capacity
    rows = jnp.where(ok, slot, C).astype(jnp.int32)
    planes = jpint.prepare_planes(jnp.asarray(d[1]), jnp.asarray(c[1]), with_color)
    C1 = vj.tw.shape[0]
    col_in = vj.color.reshape(C1, -1) if with_color else jnp.zeros((C1, 0), jnp.int32)
    tw_j, col_j = jpint.integrate_blocks(
        vj.tw.reshape(C1, -1), col_in, rows, coords, v0, u0, shift, fit, planes,
        ji, e[1], VOXEL, vj.sdf_trunc, 3.0, interpret=True,
    )

    tt, st, okt = thm.activate(vt.table, _t(keys))
    rows_t = torch.where(okt, st, C).to(torch.int32)
    np.testing.assert_array_equal(np.asarray(rows), rows_t.numpy())
    pt = tk4.prepare_planes(_t(d[1]), _t(c[1]), with_color)
    tk4.integrate_blocks(
        vt.tw, vt.color, rows_t, thm.unpack_coords(_t(keys)), pt, ti, _t(e[1]),
        VOXEL, vt.sdf_trunc, 3.0,
    )
    a = np.asarray(tw_j).reshape(-1)
    b = vt.tw.numpy().reshape(-1)
    wa, wb = a & 0xFFFF, b & 0xFFFF
    diff = wa != wb
    assert diff.mean() < 1e-6, diff.sum()
    ta, tb = (a >> 16) / 16383.0, (b >> 16) / 16383.0
    np.testing.assert_allclose(ta[~diff], tb[~diff], atol=1e-3, rtol=0)
    assert int((wb > 0).sum()) > 10000
    np.testing.assert_array_equal(a, b)
    if with_color:
        ca = np.asarray(jvbg.unpack_rgb(np.asarray(col_j).reshape(-1)))
        cb = tvbg.unpack_rgb(vt.color.reshape(-1)).numpy()
        assert np.abs(ca - cb)[~diff].max() <= 1.0 / 2047.0 + 1e-7
        np.testing.assert_array_equal(np.asarray(col_j).reshape(-1), vt.color.numpy().reshape(-1))
    assert int(vt.tw[C].abs().sum()) == 0


def test_integrate_selects_v1_under_the_switch(frames, monkeypatch):
    """voxel_block_grid.integrate on a 16^3 grid takes K4 when
    O3DTPU_INTEGRATE_V1 is set, as the JAX package does, and K1 otherwise;
    on this frame the two agree to the K1 bars."""
    d, c, e = frames
    ti = TIntr(*INTR)
    out = {}
    for v1 in (False, True):
        if v1:
            monkeypatch.setenv("O3DTPU_INTEGRATE_V1", "1")
        g = tvbg.create(voxel_size=VOXEL, block_count=256, device="cpu")
        keys, _ = tvbg.compute_unique_block_coordinates(g, _t(d[0]), ti, _t(e[0]), 3.0, frame_block_capacity=256)
        g = tvbg.integrate(g, keys, _t(d[0]), _t(c[0]), ti, _t(e[0]), depth_max=3.0)
        out[v1] = g
    assert os.environ.get("O3DTPU_INTEGRATE_V1") == "1"
    assert torch.equal(out[False].table, out[True].table)
    wa, wb = out[False].tw.reshape(-1) & 0xFFFF, out[True].tw.reshape(-1) & 0xFFFF
    diff = wa != wb
    assert float(diff.float().mean()) < 1e-4 and int((wb > 0).sum()) > 10000
    ta, tb = tvbg.unpack_tw(out[False].tw.reshape(-1))[0], tvbg.unpack_tw(out[True].tw.reshape(-1))[0]
    assert float((ta - tb).abs()[~diff].max()) <= 1e-3
