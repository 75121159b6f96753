"""Port parity: the raycast stage of open3d_tpu_torch against open3d_tpu,
on the small scene of tests/test_pallas_raycast.py (80x64, voxel 3 cm).

- build_tile_lists: rows, coords, nk, n_extra and overflow identical (the
  stable descending sort breaks ties as lax.top_k does).
- march_tiles_plain (the K2 kernel's plain version, what the port runs on
  the CPU) against the JAX kernel march_tiles run interpreted: hit masks
  agree on >= 99.9 % of rays and |depth difference| <= 1e-4 m on >= 99.9 %
  of the rays both hit (float32 rounding can move a sample across a voxel
  boundary on a few rays).
- raycast_depth against the rendered truth with the bars of
  tests/test_pallas_raycast.py.
- the CUDA march's schedule, modelled in numpy (phase A: each ray to its
  first hit and on, keeping one lowering of its hit past it with the hit
  before; k* = the tile's largest first-hit candidate; phase B on to k*;
  sampled words only; the first crossing of a block interpolated),
  on a 160x120 scene at three poses (one with extras, one where many rays
  never hit): equal to march_tiles_plain bit for bit; against the
  interpreted JAX kernel, hit masks agree on >= 99.9 % of rays, and depths
  within 1e-4 m on >= 99.8 % of the rays both hit and within a voxel on all.
- march_tiles_plain's stats on a tiny grid against a hand count.
"""

import jax
import numpy as np
import pytest
import torch

from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu.ops.pallas import raycast as jrc
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import hashmap as thm
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.ops.kernels import raycast as trc

torch.set_num_threads(2)
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """tests/test_pallas_raycast.py's _build: four frames fused by the JAX
    XLA integrate; the port gets the same grid through convert."""
    ji = JIntr(*INTR)
    depths, _, extr, _ = jsyn.render_sequence(4, intrinsic=ji, span=0.15)
    vbg = jvbg.create(voxel_size=0.03, block_resolution=16, block_count=4096, with_color=False)
    for i in range(4):
        keys, _ = jvbg.compute_unique_block_coordinates(vbg, depths[i], ji, extr[i], depth_max=4.0, frame_block_capacity=1024)
        vbg = jvbg.integrate(vbg, keys, depths[i], None, ji, extr[i], depth_max=4.0, use_pallas=False)
    vt = convert.vbg_from_numpy(
        np.asarray(vbg.table), np.asarray(vbg.tw), np.zeros((vbg.tw.shape[0], 0), np.int32),
        vbg.voxel_size, 16, vbg.sdf_trunc, device="cpu",
    )
    return vbg, vt, np.asarray(depths), np.asarray(extr)


@pytest.mark.parametrize("frame,K", [(0, 24), (0, 40), (3, 24)])
def test_tile_lists_identical(scene, frame, K):
    vj, vt, _, extr = scene
    lj = jrc.build_tile_lists(vj, JIntr(*INTR), extr[frame], 0.1, 4.0, K=K)
    lt = trc.build_tile_lists(vt, TIntr(*INTR), _t(extr[frame]), 0.1, 4.0, K=K)
    for name in ("rows", "coords", "nk", "n_extra", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(lj, name)), getattr(lt, name).numpy(), err_msg=name)
    assert int(lt.nk.max()) > 0


def test_march_matches_interpreted_kernel(scene):
    vj, vt, _, extr = scene
    lj = jrc.build_tile_lists(vj, JIntr(*INTR), extr[0], 0.1, 4.0)
    dj = np.asarray(jrc.march_tiles(vj, lj, JIntr(*INTR), extr[0], 0.1, 4.0, interpret=True))
    lt = trc.build_tile_lists(vt, TIntr(*INTR), _t(extr[0]), 0.1, 4.0)
    dt = trc.march_tiles(vt, lt, TIntr(*INTR), _t(extr[0]), 0.1, 4.0).numpy()
    assert ((dj > 0) == (dt > 0)).mean() >= 0.999
    both = (dj > 0) & (dt > 0)
    assert both.mean() > 0.7
    assert (np.abs(dj - dt)[both] <= 1e-4).mean() >= 0.999


def test_raycast_depth_matches_truth(scene):
    _, vt, depths, extr = scene
    dn, ovf = trc.raycast_depth(vt, TIntr(*INTR), _t(extr[0]), depth_min=0.1, depth_max=4.0, K=40)
    dn = dn.numpy()
    dt = depths[0]
    both = (dn > 0) & (dt > 0)
    assert both.mean() > 0.7, both.mean()
    err = np.abs(dn - dt)[both]
    assert np.median(err) < vt.voxel_size, np.median(err)
    assert np.quantile(err, 0.9) < 3 * vt.voxel_size
    in_range = (dt > 0.3) & (dt < 3.5)
    assert ((dn == 0) & in_range).mean() < 0.08
    assert int(ovf) >= 0


def test_raycast_result_and_empty_grid(scene):
    _, vt, depths, extr = scene
    ti = TIntr(*INTR)
    res = tvbg.raycast(vt, ti, _t(extr[0]), 0.1, 4.0, with_color=False)
    d = res.depth.numpy()
    np.testing.assert_array_equal(res.mask.numpy(), d > 0)
    # vertices lie on the camera rays at the hit depth: back in the camera
    # frame their z is the depth
    E = extr[0]
    v = res.vertex.numpy()[d > 0]
    z = v @ E[:3, :3].T[:, 2] + E[2, 3]
    np.testing.assert_allclose(z, d[d > 0], atol=1e-4)
    empty = tvbg.create(voxel_size=0.03, block_count=512, with_color=False, device="cpu")
    de, _ = trc.raycast_depth(empty, TIntr(64, 32, 40.0, 40.0, 31.5, 15.5), torch.eye(4), 0.1, 3.0, K=8)
    assert float(de.abs().max()) == 0.0
    # the normal map (ported since) leaves depth and mask as they are; the
    # vertex map, whose rays are then set up to round alike on every device,
    # moves by an ulp of a ray times the depth (< 4 m) and the sum's rounding
    rn = tvbg.raycast(vt, ti, _t(extr[0]), 0.1, 4.0, with_normals=True)
    for name in ("depth", "mask"):
        assert torch.equal(getattr(rn, name), getattr(res, name)), name
    torch.testing.assert_close(rn.vertex, res.vertex, atol=2e-6, rtol=0)
    lens = torch.linalg.norm(rn.normal[rn.mask], dim=-1)
    assert float((lens > 0).float().mean()) > 0.95 and float(rn.normal[~rn.mask].abs().max()) == 0
    assert float((lens[lens > 0] - 1.0).abs().max()) < 1e-3


# ---- the CUDA march's schedule, ray by ray, in numpy

INTR160 = (160, 120, 131.25, 131.25, 79.5, 59.5)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    f = np.float32
    return (np.asarray(a, f).astype(np.float64) * np.asarray(b, f).astype(np.float64)
            + np.asarray(c, f).astype(np.float64)).astype(f)


def _march_model(tw, rows, coords, nk, n_extra, intr, params, vs, dmin, dmax, slots=1, K=24, M=6):
    """csrc/raycast.cu's march, one tile at a time with its rays as a vector:
    each ray walks to its first hit and on (phase A), the tile's k* is the
    largest first-hit candidate (a ray that never hits counts nk_tot - 1),
    a hit lowered after k* is put back, and rays that stopped short of k*
    walk on to it (phase B). `slots` speculative lowerings are kept (the
    kernel keeps 1; 0 sends every ray that lowers its hit to phase B). A
    ray reads only the words it samples, and interpolates only the first
    crossing of a block."""
    f32 = np.float32
    W, H, fx, fy, cx, cy = intr
    TH, TW = -(-H // 16), -(-W // 16)
    T = TH * TW
    flat_tw = tw.reshape(-1)
    bs, inv_vs, half, two = f32(vs * 16), f32(1.0 / vs), f32(0.5 * vs), f32(2.0 * vs)
    inv_m = f32(1.0 / M)
    p = params.astype(f32)
    nex = int(n_extra[0])
    out = np.zeros((TH * 16, TW * 16), f32)
    r = np.arange(256)
    for t in range(T):
        u = (t % TW) * 16 + r % 16
        v = (t // TW) * 16 + r // 16
        x = (u.astype(f32) - f32(cx)) * f32(1.0 / fx)
        y = (v.astype(f32) - f32(cy)) * f32(1.0 / fy)
        dX = _fma(p[0], x, p[1] * y) + p[2]
        dY = _fma(p[3], x, p[4] * y) + p[5]
        dZ = _fma(p[6], x, p[7] * y) + p[8]
        oX, oY, oZ = p[9], p[10], p[11]
        d2 = np.maximum(_fma(dZ, dZ, _fma(dX, dX, dY * dY)), f32(1e-12))
        zhit = np.full(256, 1e9, f32)
        pv, pz = np.ones(256, f32), np.zeros(256, f32)
        nk_tot = int(nk[t]) + nex

        def step(k, act):
            idx = t * K + (k - nex) if k >= nex else T * K + k
            b = coords[idx].astype(f32)
            lo_hi = []
            for o, d, bc in ((oX, dX, b[0]), (oY, dY, b[1]), (oZ, dZ, b[2])):
                dd = np.where(np.abs(d) > f32(1e-9), d, f32(1e-9))
                a1 = _fma(bc, bs, -o) / dd
                a2 = (_fma(bc, bs, bs) - o) / dd
                lo_hi.append((np.minimum(a1, a2), np.maximum(a1, a2)))
            t_in = np.maximum(np.maximum(lo_hi[0][0], lo_hi[1][0]), np.maximum(lo_hi[2][0], f32(dmin)))
            t_out = np.minimum(np.minimum(lo_hi[0][1], lo_hi[1][1]), np.minimum(lo_hi[2][1], f32(dmax)))
            meet = act & (t_out > t_in)
            stp = (t_out - t_in) * inv_m
            bi = coords[idx] * 16
            contig = np.abs(t_in - pz) <= np.maximum(stp, two)
            vprev0 = np.where(contig, pv, f32(1.0))
            zprev0 = np.where(contig, pz, t_in)
            vprev, zprev = vprev0.copy(), zprev0.copy()
            cand = np.full(256, 1e9, f32)
            found = np.zeros(256, bool)
            prev_l, prev_inb = None, None
            for m in range(M):
                zm = _fma(f32(m + 0.5), stp, t_in)
                l = [np.floor(_fma(dd_, zm, o_) * inv_vs).astype(np.int32) - bi[j]
                     for j, (dd_, o_) in enumerate(((dX, oX), (dY, oY), (dZ, oZ)))]
                inb = np.all([(q >= 0) & (q < 16) for q in l], axis=0) & meet
                w = np.zeros(256, np.int32)
                w[inb] = flat_tw[int(rows[idx]) * 4096 + (l[0] + 16 * l[1] + 256 * l[2])[inb]]
                val = np.where((w & 0xFFFF) > 0, (w >> 16).astype(f32) * f32(1.0 / 16383.0), f32(2.0))
                ok = inb & (val < 1.5)
                v_eff = np.where(ok, val, f32(1.0))
                cross = ~found & (vprev > 0) & (v_eff <= 0) & ok & (zm > zprev)

                def vparam(lv):
                    c3 = [_fma((bi[j] + lv[j]).astype(f32), f32(vs), half) for j in range(3)]
                    num = _fma(c3[2] - oZ, dZ, _fma(c3[0] - oX, dX, (c3[1] - oY) * dY))
                    return num / d2

                zv = vparam(l)
                zvprev = zprev0 if m == 0 else np.where(prev_inb, vparam(prev_l), zprev)
                zc = _fma(vprev / np.maximum(vprev - v_eff, f32(1e-6)), zv - zvprev, zvprev)
                zc = np.minimum(np.maximum(zc, np.minimum(zprev, zm)), np.maximum(zprev, zm))
                cand = np.where(cross, np.minimum(cand, zc), cand)
                found |= cross
                vprev, zprev, prev_l, prev_inb = v_eff, zm, l, inb
            zhit[:] = np.where(meet, np.minimum(zhit, cand), zhit)
            pv[:] = np.where(meet, np.where(ok, val, f32(1.0)), pv)
            pz[:] = np.where(meet, np.maximum(zm, pz), pz)

        # phase A, with no report seen while walking (every step after a
        # ray's first hit is speculative): one speculative lowering of the
        # hit is kept with the hit before it; a second is undone and the ray
        # stops there
        k_first = np.full(256, nk_tot - 1)
        hit = np.zeros(256, bool)
        walking = np.ones(256, bool)
        stop = np.full(256, nk_tot)  # the first step a ray has not taken
        spec_k = np.full(256, -1)
        spec_z = np.full(256, 1e9, f32)
        for k in range(nk_tot):
            before = zhit.copy(), pv.copy(), pz.copy()
            step(k, walking)
            first = walking & ~hit & (zhit < 1e9)
            k_first[first] = k
            lower = walking & hit & (zhit < before[0])
            undo = lower & ((spec_k >= 0) | (slots == 0))
            for arr, old in zip((zhit, pv, pz), before):
                arr[undo] = old[undo]
            rec = lower & ~undo
            spec_k[rec], spec_z[rec] = k, before[0][rec]
            stop[undo] = k
            walking &= ~undo
            hit |= first
        k_star = int(k_first.max()) if nk_tot else -1  # the break
        late = spec_k > k_star
        zhit[late] = spec_z[late]
        for k in range(k_star + 1):  # phase B: the rays that stopped, on to k*
            step(k, k >= stop)
        tile = np.where(zhit < 1e9, zhit, f32(0.0)).reshape(16, 16)
        out[(t // TW) * 16:(t // TW + 1) * 16, (t % TW) * 16:(t % TW + 1) * 16] = tile
    return out[:H, :W]


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def _forward(d):
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -d
    return T


@pytest.fixture(scope="module")
def scene160():
    ji = JIntr(*INTR160)
    depths, _, extr, _ = jsyn.render_sequence(4, intrinsic=ji, span=0.15)
    vbg = jvbg.create(voxel_size=0.03, block_resolution=16, block_count=4096, with_color=False)
    for i in range(4):
        keys, _ = jvbg.compute_unique_block_coordinates(vbg, depths[i], ji, extr[i], depth_max=4.0, frame_block_capacity=1024)
        vbg = jvbg.integrate(vbg, keys, depths[i], None, ji, extr[i], depth_max=4.0, use_pallas=False)
    vt = convert.vbg_from_numpy(
        np.asarray(vbg.table), np.asarray(vbg.tw), np.zeros((vbg.tw.shape[0], 0), np.int32),
        vbg.voxel_size, 16, vbg.sdf_trunc, device="cpu",
    )
    return vbg, vt, np.asarray(extr)


# frame 0 (one extra, rays off the scene's edge never hit), the camera
# turned 0.6 rad (half the rays never hit), and moved 1 m into the grid
# (five extras straddle the camera plane)
POSES = {"frame0": lambda e: e, "turned": lambda e: _rot_y(0.6) @ e,
         "inside": lambda e: _forward(1.0) @ e}


@pytest.mark.parametrize("pose", sorted(POSES))
def test_break_schedule_model_matches_plain_and_kernel(scene160, pose):
    vj, vt, extr = scene160
    E = POSES[pose](extr[0]).astype(np.float32)
    ti = TIntr(*INTR160)
    lt = trc.build_tile_lists(vt, ti, _t(E), 0.1, 4.0)
    rows = torch.where(lt.rows >= 0, lt.rows, vt.capacity).to(torch.int32)
    stats = {}
    dp = trc.march_tiles_plain(vt.tw, rows, lt.coords, lt.nk, lt.n_extra, ti, _t(E), vt.voxel_size,
                               0.1, 4.0, stats=stats).numpy()
    steps, nk_tot = stats["tile_steps"].numpy(), lt.nk.numpy() + int(lt.n_extra[0])
    assert (steps == nk_tot).any() and (steps < nk_tot).any()  # some tiles break early, some never
    if pose == "inside":
        assert int(lt.n_extra[0]) >= 2
    params = trc._march_params(_t(E), "cpu").numpy()
    dm = _march_model(vt.tw.numpy(), rows.numpy(), lt.coords.numpy(), lt.nk.numpy(),
                      lt.n_extra.numpy(), INTR160, params, vt.voxel_size, 0.1, 4.0)
    np.testing.assert_array_equal(dm, dp)
    assert 0.3 < (dm > 0).mean() < 0.99
    d0 = _march_model(vt.tw.numpy(), rows.numpy(), lt.coords.numpy(), lt.nk.numpy(),
                      lt.n_extra.numpy(), INTR160, params, vt.voxel_size, 0.1, 4.0, slots=0)
    np.testing.assert_array_equal(d0, dp)  # phase B for every ray that lowers its hit
    lj = jrc.build_tile_lists(vj, JIntr(*INTR160), E, 0.1, 4.0)
    dj = np.asarray(jrc.march_tiles(vj, lj, JIntr(*INTR160), E, 0.1, 4.0, interpret=True))
    # the interpreted kernel rounds a few samples across a voxel boundary
    # (22 of 17 773 rays at frame 0): within a voxel, and 1e-4 m on >= 99.8 %
    assert ((dj > 0) == (dm > 0)).mean() >= 0.999
    err = np.abs(dj - dm)[(dj > 0) & (dm > 0)]
    assert (err <= 1e-4).mean() >= 0.998 and err.max() < vt.voxel_size


def test_march_stats_hand_count():
    """One 16^3 block at the origin (5 cm voxels, tsdf > 0 below voxel
    z = 8 and < 0 from there), one 16x16 tile looking down +z from 0.5 m in
    front of it. Every ray stays in voxel column (0, 0) and meets the block
    on t in [0.51, 1.3] (depth_min 0.51), so its M = 4 samples read voxel
    z = 2, 6, 10 and 14 (each over 0.02 voxel from a boundary), and it
    crosses the surface once, between the second and third."""
    vs = 0.05
    g = tvbg.create(voxel_size=vs, block_count=8, with_color=False, device="cpu")
    g.table, slot, ok = thm.activate(g.table, thm.pack_coords(torch.zeros((1, 3), dtype=torch.int32)))
    assert bool(ok.all())
    z = torch.arange(4096) >> 8
    tq = torch.where(z < 8, 8000, -8000).to(torch.int32)
    g.tw.view(-1, 4096)[int(slot[0])] = (tq << 16) | 1
    intr = TIntr(16, 16, 1000.0, 1000.0, -0.5, -0.5)  # ray x, y in (0, 0.016) per unit z
    E = torch.eye(4)
    E[2, 3] = 0.5
    lists = trc.build_tile_lists(g, intr, E, 0.51, 3.0)
    rows = torch.where(lists.rows >= 0, lists.rows, g.capacity).to(torch.int32)
    stats = {}
    d = trc.march_tiles_plain(g.tw, rows, lists.coords, lists.nk, lists.n_extra, intr, E, vs,
                              0.51, 3.0, M=4, stats=stats)
    assert float((d > 0).float().mean()) == 1.0
    assert stats["tile_steps"].tolist() == [1]
    assert stats["pairs_visited"] == 1 and stats["rows_marched"] == 1
    assert stats["ray_blocks"] == 256 and stats["crossings"] == 256
    # voxels (0, 0, z) for z = 2, 6, 10, 14: flat 256 z, four 8-word sectors
    assert stats["sectors_sampled"] == 4


def test_float64_reciprocal_division_is_exact():
    """csrc/raycast.cu divides by a per-ray value y as RN32(RN64(x *
    RN64(1 / y))). That equals the float32 IEEE quotient: the float64
    product is within 2^-52 (relative) of x / y, and a float32 quotient is
    never nearer than 2^-49 to a float32 rounding midpoint. Checked on
    random operands over a wide exponent range, and on quotients placed
    next to midpoints."""
    rng = np.random.default_rng(0)
    n = 1_000_000
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    y = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 10, n))).astype(np.float32)
    y = np.where(np.abs(y) > 1e-9, y, np.float32(1e-9)).astype(np.float32)
    d = rng.integers(2**23, 2**24, n).astype(np.float32)
    near_mid = (d.astype(np.float64) * (rng.integers(2**23, 2**24, n) + 0.5)).astype(np.float32)
    for a, b in ((x, y), (near_mid, d)):
        q = (a.astype(np.float64) * (1.0 / b.astype(np.float64))).astype(np.float32)
        np.testing.assert_array_equal(q, a / b)
