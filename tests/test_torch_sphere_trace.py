"""Port parity: the sphere-trace raycast (`raycast(use_pallas=False)`, and
every grid of another block size than 16^3) and its per-tile range pass
`estimate_range`, of open3d_tpu_torch against open3d_tpu, on the small
scene of tests/test_pallas_raycast.py (80x64, voxel 3 cm, with colour),
fused by the port's integrate into a 16^3 grid (K1's plain version) and an
8^3 grid (K3's); the JAX package gets the same grids.

Bars:
- estimate_range: the same empty tiles, and z_min, z_max equal;
- the trace with and without the range map: hit masks agree on >= 99.9 %
  of rays; depths within 1e-5 m on >= 99.9 % of the rays both hit and
  within a voxel on all (float32 sums in another order can move a sample
  across a voxel boundary on a few rays); on those rays the index maps
  equal, normals within 1e-4 and colours within 1e-6;
- the trace's fixed `max_steps` loop (no host sync) leaves every ray's
  bracket as an early-exit loop (the reference's while_loop) leaves it;
- dispatch: an 8^3 grid traces by default, `use_pallas=True` on it raises,
  `max_steps` bounds the trace and `max_probes` changes nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch import convert
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr

torch.set_num_threads(2)
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)
DEPTH_MAX = 4.0


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = jsyn.render_sequence(4, intrinsic=JIntr(*INTR), span=0.15)
    return np.asarray(d), np.asarray(c), np.asarray(e)


@pytest.fixture(scope="module", params=[16, 8], ids=["16^3", "8^3"])
def grids(request, frames):
    d, c, e = frames
    ti = TIntr(*INTR)
    B = request.param
    g = tvbg.create(voxel_size=0.03, block_resolution=B, block_count=4096, device="cpu")
    for i in range(4):
        keys, _ = tvbg.compute_unique_block_coordinates(g, _t(d[i]), ti, _t(e[i]), depth_max=DEPTH_MAX,
                                                        frame_block_capacity=1024)
        g = tvbg.integrate(g, keys, _t(d[i]), _t(c[i]), ti, _t(e[i]), depth_max=DEPTH_MAX)
    a = convert.vbg_to_numpy(g)
    shape = tuple(g.tw.shape)
    vj = jvbg.VoxelBlockGrid(
        table=jnp.asarray(a["table"]), tw=jnp.asarray(a["tw"].reshape(shape)),
        color=jnp.asarray(a["color"].reshape(shape)), voxel_size=g.voxel_size,
        block_resolution=B, sdf_trunc=g.sdf_trunc)
    return g, vj, e


@pytest.mark.parametrize("frame", [0, 3])
def test_estimate_range_matches_reference(grids, frame):
    g, vj, e = grids
    zt = tvbg.estimate_range(g, TIntr(*INTR), _t(e[frame]).float(), 0.1, DEPTH_MAX)
    zj = jvbg.estimate_range(vj, JIntr(*INTR), jnp.asarray(e[frame]), 0.1, DEPTH_MAX)
    for a, b in zip(zt, zj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zmin, zmax = zt
    assert tuple(zmin.shape) == (4, 5) and bool((zmin <= zmax).any())


@pytest.mark.parametrize("use_range_map", [True, False], ids=["range_map", "full_range"])
def test_sphere_trace_matches_reference(grids, use_range_map):
    g, vj, e = grids
    kw = dict(use_pallas=False, use_range_map=use_range_map, with_color=True,
              with_normals=True, with_index_ratio=True)
    rt = tvbg.raycast(g, TIntr(*INTR), _t(e[0]).float(), 0.1, DEPTH_MAX, **kw)
    rj = jvbg.raycast(vj, JIntr(*INTR), jnp.asarray(e[0]), 0.1, DEPTH_MAX, **kw)
    mt, mj = rt.mask.numpy(), np.asarray(rj.mask)
    assert mt.mean() > 0.8 and (mt == mj).mean() >= 0.999
    both = mt & mj
    dz = np.abs(rt.depth.numpy() - np.asarray(rj.depth))[both]
    assert (dz <= 1e-5).mean() >= 0.999 and dz.max() <= g.voxel_size
    near = np.zeros_like(both)
    near[both] = dz <= 1e-5
    assert (rt.index.numpy()[near] == np.asarray(rj.index)[near]).all(-1).mean() >= 0.999
    dn = np.abs(rt.normal.numpy() - np.asarray(rj.normal))[near].max(-1)
    assert (dn <= 1e-4).mean() >= 0.999
    dc = np.abs(rt.color.numpy() - np.asarray(rj.color))[near].max(-1)
    assert (dc <= 1e-6).mean() >= 0.999
    np.testing.assert_allclose(rt.vertex.numpy()[near], np.asarray(rj.vertex)[near], atol=1e-5)


def _bracket(g, e, max_steps, early_exit):
    """The trace's bracket search on frame 0, run `max_steps` steps or
    stopped as soon as every ray is done (the reference's while_loop);
    returns the final state and the steps taken."""
    E = _t(e[0]).float()
    origin, dirs = tvbg._pixel_rays(TIntr(*INTR), E)
    dirs = dirs.reshape(-1, 3)
    bindex = tvbg.build_block_index(g, origin, tvbg._index_extent(g, DEPTH_MAX))
    zmin, zmax = tvbg.estimate_range(g, TIntr(*INTR), E, 0.1, DEPTH_MAX)
    tv = (torch.arange(64) // 16)[:, None]
    tu = (torch.arange(80) // 16)[None, :]
    z_start = torch.clamp(zmin[tv, tu] - g.sdf_trunc, min=0.1).reshape(-1)
    z_end = torch.clamp(zmax[tv, tu] + g.sdf_trunc, max=DEPTH_MAX).reshape(-1)
    s = tvbg._trace_init(z_start, z_end)
    steps = 0
    while steps < max_steps and not (early_exit and bool(s.done.all())):
        s = tvbg._trace_step(g, bindex, origin, dirs, z_end, s)
        steps += 1
    return s, steps


def test_fixed_step_loop_equals_early_exit(grids):
    g, _, e = grids
    early, taken = _bracket(g, e, 96, early_exit=True)
    fixed, _ = _bracket(g, e, 96, early_exit=False)
    assert taken < 96  # every ray finished before the step budget
    assert bool(early.done.all()) and bool(fixed.done.all())
    for name in ("z", "z_lo", "z_hi", "done"):
        assert torch.equal(getattr(early, name), getattr(fixed, name)), name
    assert float((fixed.z_hi > 0).float().mean()) > 0.8


def test_raycast_dispatch(grids):
    g, _, e = grids
    E = _t(e[0]).float()
    intr = TIntr(*INTR)
    trace = tvbg.raycast(g, intr, E, 0.1, DEPTH_MAX, use_pallas=False)
    default = tvbg.raycast(g, intr, E, 0.1, DEPTH_MAX, max_probes=1)
    if g.block_resolution == 16:  # the march
        march = tvbg.raycast(g, intr, E, 0.1, DEPTH_MAX, use_pallas=True)
        assert torch.equal(default.depth, march.depth)
        assert not torch.equal(default.depth, trace.depth)
    else:
        assert torch.equal(default.depth, trace.depth)
        with pytest.raises(NotImplementedError):
            tvbg.raycast(g, intr, E, 0.1, DEPTH_MAX, use_pallas=True)
    short = tvbg.raycast(g, intr, E, 0.1, DEPTH_MAX, use_pallas=False, max_steps=3)
    assert float(short.mask.float().mean()) < 0.5 * float(trace.mask.float().mean())
