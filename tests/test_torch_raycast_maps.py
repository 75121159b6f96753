"""Port parity: the raycast's surface maps (colour, TSDF-gradient normals,
the 8-corner index/ratio maps) and the dense block index they read, of
open3d_tpu_torch against open3d_tpu, on the small scene of
tests/test_pallas_raycast.py (80x64, voxel 3 cm) with colour. The SLAM step
with raycast normals is tests/test_torch_slam_normals.py.

- build_block_index: rows and origin equal the JAX package's.
- The map functions, given the same hit points (the port's march depth
  unprojected) and the same grid in both packages: index maps equal,
  ratios within 1e-6, normals within 1e-5 (a central difference of two
  trilinear samples over a voxel, divided by its length), colours within
  1e-6 (the same 11/10-bit decode).
- raycast with every map, on the march (use_pallas None on a 16^3 grid)
  and on the sphere trace (use_pallas False): tests/test_pallas_raycast.py
  TestAuxMaps's bars (unit normals within 1e-3 on hits, camera-facing on
  > 95 % of hits, |tsdf| rebuilt from index and ratio with a median under
  0.1, ratios summing to 1 within 1e-4 where all 8 corners exist; on the
  march the |tsdf| bar adds the half voxel its hits sit beyond the
  surface, 0.125 of sdf_trunc here), and the
  colour map against the scene's texture at the vertex: the largest
  channel error under 0.03 at the median and under 0.1 at the 90th
  percentile (the fused colour is a mean over a 3 cm voxel of a texture
  whose terms have periods down to 0.6 m, read up to half a voxel off the
  surface; the tail is at occluding edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch import convert
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr

torch.set_num_threads(2)
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)
DEPTH_MAX = 4.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_grid(g):
    """The port's grid as the JAX package holds it (the same bytes)."""
    a = convert.vbg_to_numpy(g)
    shape = tuple(g.tw.shape)
    return jvbg.VoxelBlockGrid(
        table=jnp.asarray(a["table"]), tw=jnp.asarray(a["tw"].reshape(shape)),
        color=jnp.asarray(a["color"].reshape(shape)), voxel_size=g.voxel_size,
        block_resolution=g.block_resolution, sdf_trunc=g.sdf_trunc)


@pytest.fixture(scope="module")
def scene():
    """Four frames of tests/test_pallas_raycast.py's orbit, with colour,
    fused by the port's 16^3 integrate; the JAX package gets the same
    grid."""
    ti = TIntr(*INTR)
    d, c, e, _ = jsyn.render_sequence(4, intrinsic=JIntr(*INTR), span=0.15)
    d, c, e = np.asarray(d), np.asarray(c), np.asarray(e)
    g = tvbg.create(voxel_size=0.03, block_resolution=16, block_count=4096, device="cpu")
    for i in range(4):
        keys, _ = tvbg.compute_unique_block_coordinates(g, _t(d[i]), ti, _t(e[i]), depth_max=DEPTH_MAX,
                                                        frame_block_capacity=1024)
        g = tvbg.integrate(g, keys, _t(d[i]), _t(c[i]), ti, _t(e[i]), depth_max=DEPTH_MAX)
    return g, _jax_grid(g), e


@pytest.mark.parametrize("frame,extent", [(0, None), (3, None), (0, 5)])
def test_build_block_index_matches_reference(scene, frame, extent):
    """The index at the raycast's own extent (19 cells here) and at a
    volume smaller than the live blocks' spread, which drops blocks."""
    g, vj, e = scene
    E = _t(e[frame]).float()
    origin, _ = tvbg._pixel_rays(TIntr(*INTR), E)
    ext = extent or tvbg._index_extent(g, DEPTH_MAX)
    bt = tvbg.build_block_index(g, origin, ext)
    bj = jvbg.build_block_index(vj, jnp.asarray(origin.numpy()), ext)
    assert bt.extent == bj.extent == ext
    np.testing.assert_array_equal(bt.origin.numpy(), np.asarray(bj.origin))
    np.testing.assert_array_equal(bt.rows.numpy(), np.asarray(bj.rows))
    live = int((bt.rows < g.capacity).sum())
    n_active = int(g.num_active_blocks())
    assert live > 0 and (live < n_active if extent else live == n_active)


@pytest.fixture(scope="module")
def hits(scene):
    """The port's march depth from frame 0, unprojected: the same hit
    points, rays and mask for both packages' map functions."""
    g, vj, e = scene
    E = _t(e[0]).float()
    res = tvbg.raycast(g, TIntr(*INTR), E, 0.1, DEPTH_MAX, with_color=False)
    origin, dirs = tvbg._pixel_rays(TIntr(*INTR), E)
    p = (origin + dirs * res.depth[..., None]).reshape(-1, 3)
    mask = res.mask.reshape(-1)
    assert float(mask.float().mean()) > 0.5
    ext = tvbg._index_extent(g, DEPTH_MAX)
    return (p, dirs.reshape(-1, 3), mask, tvbg.build_block_index(g, origin, ext),
            jvbg.build_block_index(vj, jnp.asarray(origin.numpy()), ext))


def _j(x):
    return jnp.asarray(x.numpy())


def test_color_map_matches_reference(scene, hits):
    g, vj, _ = scene
    p, _, mask, bt, bj = hits
    voxel = torch.floor(tvbg._div(p, g.voxel_size)).to(torch.int32)
    ct = tvbg._sample_color_indexed(g, bt, voxel)
    cj = np.asarray(jvbg._sample_color_indexed(vj, bj, _j(voxel)))
    np.testing.assert_allclose(ct.numpy(), cj, atol=1e-6, rtol=0)
    assert float((ct[mask].amax(-1) > 0).float().mean()) > 0.95  # hits read coloured voxels


def test_normal_map_matches_reference(scene, hits):
    g, vj, _ = scene
    p, dirs, mask, bt, bj = hits
    nt = tvbg._gradient_normals(g, bt, p, dirs, mask)
    nj = np.asarray(jvbg._gradient_normals(vj, bj, _j(p), _j(dirs), _j(mask)))
    np.testing.assert_allclose(nt.numpy(), nj, atol=1e-5, rtol=0)


def test_index_ratio_maps_match_reference(scene, hits):
    g, vj, _ = scene
    p, _, mask, bt, bj = hits
    it, wt = tvbg._index_ratio_maps(g, bt, p, mask)
    ij, wj = jvbg._index_ratio_maps(vj, bj, _j(p), _j(mask))
    assert it.dtype == torch.int32 and np.asarray(ij).dtype == np.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)
    assert int((it[mask] >= 0).all(-1).sum()) > 0.9 * int(mask.sum())


def test_trilinear_sample_matches_reference(scene, hits):
    g, vj, _ = scene
    p, _, mask, bt, bj = hits
    tt, wt = tvbg._sample_tsdf_trilinear_indexed(g, bt, p)
    tj, wj = jvbg._sample_tsdf_trilinear_indexed(vj, bj, _j(p))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_pallas", [None, False], ids=["march", "trace"])
def test_raycast_aux_maps_meet_reference_bars(scene, use_pallas):
    g, _, e = scene
    E = _t(e[0]).float()
    res = tvbg.raycast(g, TIntr(*INTR), E, 0.1, DEPTH_MAX, use_pallas=use_pallas,
                       with_color=True, with_normals=True, with_index_ratio=True)
    hit = res.mask.numpy()
    assert hit.mean() > 0.5
    n = res.normal.numpy()
    lens = np.linalg.norm(n[hit], axis=-1)
    assert np.all(np.abs(lens[lens > 0] - 1.0) < 1e-3)
    R, t = e[0][:3, :3], e[0][:3, 3]
    rays = res.vertex.numpy()[hit] - (-R.T @ t)
    assert (np.sum(n[hit] * rays, axis=-1) <= 1e-6).mean() > 0.95
    idx8, wt8 = res.index.numpy()[hit], res.interp_ratio.numpy()[hit]
    ts = (g.tw.view(-1).numpy()[np.maximum(idx8, 0)] >> 16).astype(np.float32) / 16383.0
    wsum = wt8.sum(-1)
    good = wsum > 0.5
    # the march's hits sit half a voxel beyond the surface (ROADMAP.md
    # section 3 fault 4, the reference's own), which adds that much |tsdf|
    bar = 0.1 if use_pallas is False else 0.1 + 0.5 * g.voxel_size / g.sdf_trunc
    assert np.median(np.abs((ts * wt8).sum(-1)[good] / wsum[good])) < bar
    full = (idx8 >= 0).all(-1)
    assert full.mean() > 0.9 and np.allclose(wt8[full].sum(-1), 1.0, atol=1e-4)
    err = np.abs(res.color.numpy()[hit] - tsyn.scene_color(res.vertex[res.mask]).numpy()).max(-1)
    assert np.median(err) < 0.03 and np.quantile(err, 0.9) < 0.1
    assert np.all(res.color.numpy()[~hit] == 0) and np.all(n[~hit] == 0)


def test_march_maps_leave_the_depth_as_the_march_gives_it(scene):
    """With every map asked for, the march path's depth is the march's."""
    from open3d_tpu_torch.ops.kernels import raycast as trc

    g, _, e = scene
    E = _t(e[1]).float()
    res = tvbg.raycast(g, TIntr(*INTR), E, 0.1, DEPTH_MAX, with_normals=True,
                       with_index_ratio=True)
    depth, _ = trc.raycast_depth(g, TIntr(*INTR), E, 0.1, DEPTH_MAX)
    assert torch.equal(res.depth, depth)
    assert res.index.dtype == torch.int32 and tuple(res.interp_ratio.shape) == (64, 80, 8)
