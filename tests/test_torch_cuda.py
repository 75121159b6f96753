"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small sizes. They need a CUDA card and skip without one; on a machine
with a card and no JAX run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bars: the kernels fuse multiply-adds at the same places as their plain
versions and round alike, so on the same card they agree exactly; the
primitive probes' products, which cuBLAS sums in another order, agree
within micro_primitives.tolerance.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg

    d, c, e, intr = synthetic.render_sequence(2, span=0.1, device=cuda)
    g = vbg.create(voxel_size=0.02, block_count=1024, device=cuda)
    return g, d, c, e, intr


def test_integrate_kernel_matches_plain(scene):
    from open3d_tpu_torch.core import hashmap as hm
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg
    from open3d_tpu_torch.ops.kernels import integrate2 as k1

    g, d, c, e, intr = scene
    tw_ref, col_ref = g.tw.clone(), g.color.clone()
    for i in range(2):
        keys, _ = vbg.compute_unique_block_coordinates(g, d[i], intr, e[i], frame_block_capacity=256)
        g.table, slot, ok = hm.activate(g.table, keys)
        rows = torch.where(ok, slot, g.capacity).to(torch.int32)
        d21, rgb24 = k1.prepare_frame(d[i], c[i], 3.0)
        args = (rows, hm.unpack_coords(keys), d21, rgb24, intr, e[i], g.voxel_size, g.sdf_trunc, 3.0)
        n = k1.integrate_blocks_v2.launches
        k1.integrate_blocks_v2(g.tw, g.color, *args)
        assert k1.integrate_blocks_v2.launches == n + 1
        k1.integrate_blocks_plain(tw_ref, col_ref, *args)
        torch.cuda.synchronize()
        assert torch.equal(g.tw, tw_ref) and torch.equal(g.color, col_ref)
    assert int((g.tw.view(g.capacity + 1, -1) & 0xFFFF).sum()) > 0


def test_march_kernel_matches_plain(scene):
    from open3d_tpu_torch.ops.kernels import raycast as k2

    g, d, c, e, intr = scene
    lists = k2.build_tile_lists(g, intr, e[1], 0.1, 3.0)
    rows = torch.where(lists.rows >= 0, lists.rows, g.capacity).to(torch.int32)
    n = k2.march_tiles.launches
    dk = k2.march_tiles(g, lists, intr, e[1], 0.1, 3.0)
    assert k2.march_tiles.launches == n + 1
    dp = k2.march_tiles_plain(g.tw, rows, lists.coords, lists.nk, lists.n_extra, intr, e[1],
                              g.voxel_size, 0.1, 3.0)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    assert float((dk > 0).float().mean()) > 0.5


def test_march_kernel_matches_plain_with_missing_rays(scene):
    """The camera turned half away from the fused surface: many rays never
    hit, so their tiles walk every candidate before the break."""
    import math

    from open3d_tpu_torch.ops.kernels import raycast as k2

    g, d, c, e, intr = scene
    a = 0.6
    turn = torch.tensor([[math.cos(a), 0, math.sin(a), 0], [0, 1, 0, 0],
                         [-math.sin(a), 0, math.cos(a), 0], [0, 0, 0, 1]], dtype=torch.float32)
    E = turn.to(e.device) @ e[1]
    lists = k2.build_tile_lists(g, intr, E, 0.1, 3.0)
    rows = torch.where(lists.rows >= 0, lists.rows, g.capacity).to(torch.int32)
    dk = k2.march_tiles(g, lists, intr, E, 0.1, 3.0)
    stats = {}
    dp = k2.march_tiles_plain(g.tw, rows, lists.coords, lists.nk, lists.n_extra, intr, E,
                              g.voxel_size, 0.1, 3.0, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    hit = float((dk > 0).float().mean())
    assert 0.05 < hit < 0.95, hit
    nk_tot = lists.nk.long() + int(lists.n_extra[0])
    assert bool(((stats["tile_steps"] == nk_tot) & (nk_tot > 1)).any())


def test_integrate_kernel_mostly_dump_rows(scene):
    """A work list of which nine entries in ten are the dump row C: only the
    live rows change, and the dump row stays zero."""
    from open3d_tpu_torch.core import hashmap as hm
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg
    from open3d_tpu_torch.ops.kernels import integrate2 as k1

    g, d, c, e, intr = scene
    keys, _ = vbg.compute_unique_block_coordinates(g, d[0], intr, e[0], frame_block_capacity=256)
    table, slot, ok = hm.activate(g.table, keys)
    rows = torch.where(ok, slot, g.capacity).to(torch.int32)
    rows[torch.arange(rows.numel(), device=rows.device) % 10 != 0] = g.capacity
    live = rows[rows < g.capacity].long()
    assert live.numel() > 0 and live.numel() * 5 < rows.numel()
    tw, col = g.tw.clone(), g.color.clone()
    tw_ref, col_ref = g.tw.clone(), g.color.clone()
    d21, rgb24 = k1.prepare_frame(d[0], c[0], 3.0)
    args = (rows, hm.unpack_coords(keys), d21, rgb24, intr, e[0], g.voxel_size, g.sdf_trunc, 3.0)
    k1.integrate_blocks_v2(tw, col, *args)
    k1.integrate_blocks_plain(tw_ref, col_ref, *args)
    torch.cuda.synchronize()
    assert torch.equal(tw, tw_ref) and torch.equal(col, col_ref)
    flat, before = tw.view(g.capacity + 1, -1), g.tw.view(g.capacity + 1, -1)
    changed = (flat != before).any(-1)
    assert bool(changed[live].all())
    assert int(changed.sum()) == live.numel()
    assert int(flat[g.capacity].abs().sum()) == 0


def test_integrate_v1_kernel_matches_plain(scene):
    from open3d_tpu_torch.core import hashmap as hm
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg
    from open3d_tpu_torch.ops.kernels import integrate as k4

    g, d, c, e, intr = scene
    tw, col = g.tw.clone(), g.color.clone()
    tw_ref, col_ref = g.tw.clone(), g.color.clone()
    for i in range(2):
        keys, _ = vbg.compute_unique_block_coordinates(g, d[i], intr, e[i], frame_block_capacity=256)
        table, slot, ok = hm.activate(g.table, keys)
        rows = torch.where(ok, slot, g.capacity).to(torch.int32)
        planes = k4.prepare_planes(d[i], c[i], True)
        args = (rows, hm.unpack_coords(keys), planes, intr, e[i], g.voxel_size, g.sdf_trunc, 3.0)
        n = k4.integrate_blocks.launches
        k4.integrate_blocks(tw, col, *args)
        assert k4.integrate_blocks.launches == n + 1
        k4.integrate_blocks_plain_v1(tw_ref, col_ref, *args)
        torch.cuda.synchronize()
        assert torch.equal(tw, tw_ref) and torch.equal(col, col_ref)
    assert int((tw.view(g.capacity + 1, -1) & 0xFFFF).sum()) > 0


def _fuse_case(cuda, B, C=64, M=32, seed=1):
    gen = torch.Generator().manual_seed(seed)
    B3 = B**3
    tw = torch.randint(-2**31, 2**31 - 1, (C + 1, B3), generator=gen, dtype=torch.int32)
    col = torch.randint(0, 2**31 - 1, (C + 1, B3), generator=gen, dtype=torch.int32)
    rows = torch.randperm(C, generator=gen)[:M].to(torch.int32)
    rows[::5] = C
    tsdf_new = torch.rand((M, B3), generator=gen) * 2 - 1
    wn = (torch.rand((M, B3), generator=gen) > 0.3).float()
    cnew = torch.randint(0, 2**31 - 1, (M, B3), generator=gen, dtype=torch.int32)
    return [x.to(cuda) for x in (tw, col, rows, tsdf_new, wn, cnew)]


# B^3 = 512 (the fragments'), 216, 125 (one voxel a group), 4096; M = 37:
# the last CTA's scan of 8 entries only partly filled, live entries past
# the last full group of 8
@pytest.mark.parametrize("B, M", [(8, 32), (6, 32), (5, 32), (16, 32), (8, 37)])
@pytest.mark.parametrize("with_color", [True, False])
def test_fuse_kernel_matches_plain(cuda, B, M, with_color):
    from open3d_tpu_torch.ops.kernels import tsdf as k3

    a = _fuse_case(cuda, B, M=M)
    b = [x.clone() for x in a]
    before = a[0].clone()
    if not with_color:
        a[1] = a[5] = b[1] = b[5] = None
    n = k3.fuse_blocks.launches
    k3.fuse_blocks(*a)
    assert k3.fuse_blocks.launches == n + 1
    k3.fuse_blocks_plain(*b)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    if with_color:
        assert torch.equal(a[1], b[1])
    C = a[0].shape[0] - 1
    live = a[2][a[2] < C].long()
    assert bool((a[0][live] != before[live]).any())


def test_fuse_kernel_all_dump_rows(cuda):
    """A 4096-entry work list of dump rows only: the kernel changes nothing,
    row C included."""
    from open3d_tpu_torch.ops.kernels import tsdf as k3

    tw, col = _fuse_case(cuda, 8)[:2]
    C, M = tw.shape[0] - 1, 4096
    rows = torch.full((M,), C, dtype=torch.int32, device=cuda)
    tsdf_new = torch.zeros((M, 512), device=cuda)
    wn = torch.ones((M, 512), device=cuda)
    cnew = torch.zeros((M, 512), dtype=torch.int32, device=cuda)
    tw0, col0 = tw.clone(), col.clone()
    k3.fuse_blocks(tw, col, rows, tsdf_new, wn, cnew)
    torch.cuda.synchronize()
    assert torch.equal(tw, tw0) and torch.equal(col, col0)


def test_wrapper_raises_on_mixed_devices(scene):
    from open3d_tpu_torch.ops.kernels import integrate2 as k1

    g, d, c, e, intr = scene
    d21, rgb24 = k1.prepare_frame(d[0], c[0], 3.0)
    slots = torch.zeros(4, dtype=torch.int32)  # on the CPU
    coords = torch.zeros((4, 3), dtype=torch.int32, device=g.device)
    with pytest.raises(ValueError):
        k1.integrate_blocks_v2(g.tw, g.color, slots, coords, d21, rgb24, intr, e[0],
                               g.voxel_size, g.sdf_trunc, 3.0)


def test_micro_gather_kernel_matches_plain(cuda):
    from open3d_tpu_torch.ops.kernels import micro_gather as p2

    gen = torch.Generator(device=cuda).manual_seed(2)
    # a tail past the 16-byte steps; the 160 KB table; ending inside a
    # grid-stride round and off a 16-byte step; the script's index count
    for R, n in [(32, 4099), (320, 1 << 16), (320, 5 * 16384 + 4101), (320, 12_000_000)]:
        table, idx = p2.make_inputs(R, n, gen, cuda)
        count = p2.gather.launches
        out = p2.gather(table, idx)
        assert p2.gather.launches == count + 1
        torch.cuda.synchronize()
        assert torch.equal(out, p2.gather_plain(table, idx))


def test_micro_raymarch_kernel_matches_plain(cuda):
    from open3d_tpu_torch.ops.kernels import micro_raymarch as p3

    tw, rows = p3.make_inputs(torch.Generator(device=cuda).manual_seed(3), cuda, T=300, C=512)
    count = p3.march.launches
    out = p3.march(rows, tw)
    assert p3.march.launches == count + 1
    torch.cuda.synchronize()
    ref = p3.march_plain(rows, tw)
    assert torch.equal(out, ref)
    assert p3.parity(out, ref)["hit_frac"] > 0.5


@pytest.mark.parametrize("name", [
    "mul (2048,128) f32", "take_along_axis (2048,128)", "take_along 1col (2048,128)",
    "maskmul+lanereduce (2048,128)", "segreduce 5x(2048,128)->(2048,5)",
    "reshape (2048,1)->(16,128)", "reshape3d+subreduce (2048,128)",
    "onehot build (2048,128) bf16", "matmul bf16 (2048,128)@(128,128)",
    "matmul bf16 (2048,128)@(128,640)", "matmul f32 (16,2048)@(2048,128)",
    "matmul f32 (16,2048)@(2048,640)", "transpose (128,2048)", "transpose (2048,8)",
    "bcast lane->sub (32,128)->(32,128,128)",
])
def test_micro_primitives_kernel_matches_plain(cuda, name):
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1

    torch.backends.cuda.matmul.allow_tf32 = False
    probe = p1.BY_NAME[name]
    ins = p1.make_inputs(probe, torch.Generator(device=cuda).manual_seed(4), cuda)
    count = p1.run_probe.launches
    out = p1.run_probe(probe, ins, 50)
    assert p1.run_probe.launches == count + 1
    torch.cuda.synchronize()
    ref = p1.probe_plain(probe, ins, 50)
    if p1.tolerance(probe) == 0.0:
        assert torch.equal(out, ref)
    else:
        assert p1.rel_err(out, ref) <= p1.tolerance(probe)


REDESIGNED = ("segreduce 5x(2048,128)->(2048,5)", "reshape3d+subreduce (2048,128)",
              "matmul bf16 (2048,128)@(128,640)", "matmul bf16 (2048,128)@(128,128)",
              "matmul f32 (16,2048)@(2048,640)", "matmul f32 (16,2048)@(2048,128)")


@pytest.mark.parametrize("iters", [0, 1, 50, 1000])
@pytest.mark.parametrize("name", REDESIGNED)
def test_redesigned_probes_match_plain(cuda, name, iters):
    """The wgmma and register-blocked products and the two reductions that
    keep partials across the iterations, at several repeat counts: the
    reductions bit for bit (the plain sums take their order), the products
    within tolerance()."""
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1

    torch.backends.cuda.matmul.allow_tf32 = False
    probe = p1.BY_NAME[name]
    ins = p1.make_inputs(probe, torch.Generator(device=cuda).manual_seed(5), cuda)
    out = p1.run_probe(probe, ins, iters)
    torch.cuda.synchronize()
    ref = p1.probe_plain(probe, ins, iters)
    if iters == 0:
        assert not bool(out.any())
    elif probe.family == "reduce":
        assert torch.equal(out, ref)
    else:
        assert p1.rel_err(out, ref) <= p1.tolerance(probe)


@pytest.mark.parametrize("name", ["matmul bf16 (2048,128)@(128,640)",
                                  "matmul bf16 (2048,128)@(128,128)"])
def test_bf16_product_at_the_largest_index(cuda, name):
    """At ITERS_HI the bfloat16 product meets i up to 8999 (a + bf16(i)
    near 9024) and sums about 80 times larger than at ITERS_LO: each
    iteration's products still start from zero on the tensor cores and are
    added in float32 with rounding, so the error stays within the bar set
    at ITERS_LO."""
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1

    probe = p1.BY_NAME[name]
    ins = p1.make_inputs(probe, torch.Generator(device=cuda).manual_seed(6), cuda)
    out = p1.run_probe(probe, ins, p1.ITERS_HI)
    torch.cuda.synchronize()
    assert p1.rel_err(out, p1.probe_plain(probe, ins, p1.ITERS_HI)) <= p1.tolerance(probe)


@pytest.mark.parametrize("family,M,K,N", [
    ("mma_bf16", 128, 128, 96), ("mma_bf16", 64, 128, 80), ("ffma", 8, 1024, 24),
    ("ffma", 4, 3072, 8),
])
def test_product_kernels_at_other_tiles(cuda, family, M, K, N):
    """Shapes that take the other bfloat16 tile width, one or three parts
    of K, and a grid of a few CTAs."""
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if family == "mma_bf16" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    b = torch.randn((K, N), generator=gen, device=cuda).to(dtype)
    out = p1.product(family, a, b, 20)
    ref = p1.product(family, a.cpu(), b.cpu(), 20)
    torch.cuda.synchronize()
    tol = 1e-4 if family == "mma_bf16" else 1e-5
    assert p1.rel_err(out.cpu(), ref) <= tol


@pytest.mark.parametrize("family,M,K,N", [("mma_bf16", 64, 128, 80), ("ffma", 4, 1024, 8)])
def test_product_refuses_a_misaligned_base_on_the_card(cuda, family, M, K, N):
    """A contiguous view one element into its storage raises ValueError
    before any launch, and the card goes on running the kernel."""
    from open3d_tpu_torch.ops.kernels import micro_primitives as p1

    dtype = torch.bfloat16 if family == "mma_bf16" else torch.float32
    a = torch.zeros(M * K + 1, dtype=dtype, device=cuda)[1:].view(M, K)
    b = torch.zeros((K, N), dtype=dtype, device=cuda)
    count = p1.run_probe.launches
    with pytest.raises(ValueError, match="aligned"):
        p1.product(family, a, b, 1)
    assert p1.run_probe.launches == count
    out = p1.product(family, a.clone(), b, 1)
    torch.cuda.synchronize()
    assert not bool(out.any())


@pytest.fixture(scope="module", params=[16, 8], ids=["16^3", "8^3"])
def fused(cuda, request):
    """Two frames fused into a coloured grid on the card (K1 at 16^3, K3 at
    8^3), and a CPU copy of it."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg

    d, c, e, intr = synthetic.render_sequence(2, span=0.1, device=cuda)
    g = vbg.create(voxel_size=0.02, block_resolution=request.param, block_count=4096, device=cuda)
    for i in range(2):
        keys, _ = vbg.compute_unique_block_coordinates(g, d[i], intr, e[i], frame_block_capacity=1024)
        g = vbg.integrate(g, keys, d[i], c[i], intr, e[i])
    cpu = vbg.VoxelBlockGrid(g.table.cpu(), g.tw.cpu(), g.color.cpu(), g.voxel_size,
                             g.block_resolution, g.sdf_trunc)
    return g, cpu, e, intr


@pytest.mark.parametrize("fused", [16], indirect=True, ids=["16^3"])
def test_raycast_maps_on_the_march_match_a_cpu_copy(fused):
    """Every map on the card's march depth equals the same function on CPU
    copies of the grid and that depth: index exact, the rest within 1e-5;
    the march kernel ran."""
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg
    from open3d_tpu_torch.ops.kernels import raycast as k2

    g, cpu, e, intr = fused
    n = k2.march_tiles.launches
    res = vbg.raycast(g, intr, e[1], with_color=True, with_normals=True, with_index_ratio=True)
    assert k2.march_tiles.launches == n + 1
    ref = vbg._maps_on_depth(cpu, intr, e[1].cpu(), res.depth.cpu(), 3.0, True, True, True)
    assert torch.equal(res.index.cpu(), ref.index) and torch.equal(res.mask.cpu(), ref.mask)
    for name in ("vertex", "color", "normal", "interp_ratio"):
        err = float((getattr(res, name).cpu() - getattr(ref, name)).abs().max())
        assert err <= 1e-5, (name, err)
    assert float(res.mask.float().mean()) > 0.5 and float(res.color.abs().sum()) > 0


def test_sphere_trace_on_the_card_matches_a_cpu_copy(fused):
    """use_pallas=False on the card (8^3: the default) against the same
    trace of the CPU copy: masks agree on >= 99.9 % of rays, depths within
    1e-5 m on >= 99.9 % of the rays both hit; no kernel is launched."""
    from open3d_tpu_torch.geometry import voxel_block_grid as vbg
    from open3d_tpu_torch.ops.kernels import raycast as k2

    g, cpu, e, intr = fused
    n = k2.march_tiles.launches
    use = None if g.block_resolution != 16 else False
    res = vbg.raycast(g, intr, e[1], use_pallas=use, with_normals=True)
    ref = vbg.raycast(cpu, intr, e[1].cpu(), use_pallas=use, with_normals=True)
    assert k2.march_tiles.launches == n
    mk, mc = res.mask.cpu(), ref.mask
    assert float(mk.float().mean()) > 0.5 and float((mk == mc).float().mean()) >= 0.999
    dz = (res.depth.cpu() - ref.depth).abs()[mk & mc]
    assert float((dz <= 1e-5).float().mean()) >= 0.999


# ---- the registration path (plain PyTorch: no kernel of csrc/ on it) --------


@pytest.fixture(scope="module")
def reg_clouds(cuda):
    """Two 160x120 frames of the bench's ICP orbit unprojected into the
    world on the card (voxel 0.02, 30-neighbour normals), and CPU copies."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.pointcloud import PointCloud
    from open3d_tpu_torch.geometry.rgbd import pointcloud_from_depth
    from open3d_tpu_torch.ops import pointcloud as pc_ops

    d, _, e, intr = synthetic.render_sequence(2, span=0.15, device=cuda)
    raw = [pointcloud_from_depth(d[i], intr, e[i]) for i in range(2)]
    card = [pc_ops.estimate_normals(pc_ops.voxel_down_sample(p, 0.02), max_nn=30) for p in raw]

    def cpu(p):
        return PointCloud(p.positions.cpu(), p.mask.cpu(), {k: v.cpu() for k, v in p.attrs.items()})

    return raw, card, [cpu(p) for p in card], cpu


def test_voxel_down_sample_is_deterministic_and_matches_a_cpu_copy(reg_clouds):
    """Two calls on the card give equal clouds (sequential segment sums, no
    float atomics); a CPU copy gives the same mask and row order and means
    within 1e-6."""
    from open3d_tpu_torch.ops import pointcloud as pc_ops

    raw, _, _, cpu = reg_clouds
    a = pc_ops.voxel_down_sample(raw[0], 0.02)
    b = pc_ops.voxel_down_sample(raw[0], 0.02)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.mask, b.mask)
    c = pc_ops.voxel_down_sample(cpu(raw[0]), 0.02)
    assert torch.equal(a.mask.cpu(), c.mask) and int(c.count()) > 1000
    assert float((a.positions.cpu() - c.positions)[c.mask].abs().max()) <= 1e-6


def _expanded_tol(q, t):
    """Per-query bound on how far two float32 evaluations of the expanded
    distance |q|^2 + |t|^2 - 2 q.t may each stray from the exact one:
    4 ulps of |q|^2 + |t|^2 (the largest valid target's), ~1e-5 m^2 at the
    room's scale. TF32 products would stray by ~2^-11 of it."""
    tt = (t.double() ** 2).sum(-1)
    return 4 * 2.0**-23 * ((q.double() ** 2).sum(-1) + tt[tt < 1e6].max())


@pytest.mark.parametrize("k", [1, 8])
def test_nearest_neighbours_match_a_cpu_copy(reg_clouds, k):
    """1-NN and kNN on the card against a CPU copy: distances within both
    devices' rounding of the expanded form (_expanded_tol twice), indices
    equal but where the two winners' float64 distances lie within it. The
    card's expanded-form 1-NN distances agree with the difference form
    within _expanded_tol (the TF32 guard)."""
    from open3d_tpu_torch.core import nns

    _, card, host, _ = reg_clouds
    m = host[0].mask
    q, t = host[0].positions[m], host[1].positions
    tol = 2 * _expanded_tol(q, t)[:, None]
    if k == 1:
        i_c, d_c = nns.one_nn_search(card[0].positions, card[1].positions, card[1].mask)
        i_h, d_h = nns.one_nn_search(host[0].positions, host[1].positions, host[1].mask)
        diff = nns._sq3(card[0].positions - card[1].positions[i_c.long()]).cpu()
        assert bool(((diff - d_c.cpu())[m].abs().double() <= tol[:, 0] / 2).all())
        i_c, d_c, i_h, d_h = i_c[:, None], d_c[:, None], i_h[:, None], d_h[:, None]
    else:
        i_c, d_c = nns.knn_search(card[0].positions, card[1].positions, k, card[1].mask)
        i_h, d_h = nns.knn_search(host[0].positions, host[1].positions, k, host[1].mask)
    assert bool(((d_c.cpu()[m] - d_h[m]).abs().double() <= tol).all())
    differ = (i_c.cpu() != i_h)[m]
    dc = ((q.double()[:, None] - t.double()[i_c.cpu()[m].long()]) ** 2).sum(-1)
    dh = ((q.double()[:, None] - t.double()[i_h[m].long()]) ** 2).sum(-1)
    assert bool(((dc - dh).abs() <= tol)[differ].all())
    assert float(differ.any(1).double().mean()) < 0.01


def _same_sets(a, b):
    """(N,) rows whose neighbour index sets agree."""
    return (a.cpu().sort(1).values == b.cpu().sort(1).values).all(1)


def test_estimate_normals_matches_a_cpu_copy(reg_clouds):
    """Wherever the card and the CPU copy find the same neighbours (a
    neighbour at the k-th place can change with the expanded form's
    rounding, on under 1 % of the rows) and the covariance defines a
    normal (its two smallest eigenvalues apart by over 1e-3 of the largest;
    a rim point with neighbours on a line has none), |n . n'| > 1 - 1e-5."""
    from open3d_tpu_torch.core import nns
    from open3d_tpu_torch.ops import pointcloud as pc_ops

    _, card, host, _ = reg_clouds
    m = host[0].mask
    for kw in (dict(max_nn=30), dict(max_nn=30, radius=0.1)):
        if "radius" in kw:
            i_c = nns.hybrid_search(card[0].positions, card[0].positions, 0.1, 30, card[0].mask)[0]
            i_h = nns.hybrid_search(host[0].positions, host[0].positions, 0.1, 30, host[0].mask)[0]
        else:
            i_c = nns.knn_search(card[0].positions, card[0].positions, 30, card[0].mask)[0]
            i_h = nns.knn_search(host[0].positions, host[0].positions, 30, host[0].mask)[0]
        same = _same_sets(i_c, i_h) & m
        assert float(same.double().sum() / m.double().sum()) > 0.99
        ev = torch.linalg.eigvalsh(pc_ops.estimate_covariances(host[0], **kw).attrs["covariances"].double())
        posed = same & (ev[:, 1] - ev[:, 0] > 1e-3 * ev[:, 2])
        assert float(posed.double().sum() / m.double().sum()) > 0.98
        a = pc_ops.estimate_normals(card[0], **kw).attrs["normals"].cpu()
        b = pc_ops.estimate_normals(host[0], **kw).attrs["normals"]
        assert float((a * b).sum(-1).abs()[posed].min()) > 1 - 1e-5


def _fpfh_bar(idx_a, d2_a, idx_b, d2_b):
    """(N,) float64: how far two FPFH rows may lie apart when their SPFHs
    agree and only the neighbour tables' d2 differ, plus 1e-3. The
    aggregated part is 100 N / D, N = sum_k s_k w_k <= D = sum_k S_k w_k
    with w_k = 1 / d2_k; weights off by a factor within 1 +- e move N and D
    each by at most e D, so 100 N / D moves by at most 200 e / (1 - e). e is
    a row's largest |d2_a / d2_b - 1| over the neighbours both tables weigh
    (rows with the same neighbour set); inf where one table weighs a
    neighbour the other does not."""
    idx_a, d2_a, idx_b, d2_b = (x.cpu() for x in (idx_a, d2_a, idx_b, d2_b))
    n = idx_a.shape[0]
    ia, oa = torch.sort(idx_a, 1)
    ib, ob = torch.sort(idx_b, 1)
    da, db = torch.gather(d2_a, 1, oa).double(), torch.gather(d2_b, 1, ob).double()
    nbr = (ia >= 0) & (ia != torch.arange(n)[:, None])
    wa, wb = da > 1e-12, db > 1e-12
    e = torch.where(nbr & wa & wb, (da / torch.where(wb, db, 1.0) - 1.0).abs(), 0.0)
    e = torch.where(nbr & (wa != wb), torch.inf, e).amax(1)
    return torch.where(e < 1.0, 1e-3 + 200.0 * e / (1.0 - e), torch.inf)


@pytest.mark.parametrize("path", ["brute", "grid"])
def test_fpfh_matches_a_cpu_copy(reg_clouds, path, monkeypatch):
    """The bench's FPFH settings (voxel 0.05, normals within 0.1, FPFH radius
    0.25 and 64 neighbours) on the card and on a CPU copy of the cloud: at
    least 99.99 % of the pairs fall in the same bins and 99 % of the rows
    find the same neighbours; two calls on the card give one result. Every
    row that no differing pair touches agrees within 1e-3 when both devices
    aggregate over one neighbour table, the CPU copy's. On each device's own
    table, the rows that no differing pair or neighbour set touches agree
    within 1e-3 through the hash grid (difference-form distances), and
    through the brute force within _fpfh_bar of the two tables' d2 (each
    device rounds the expanded form its own way)."""
    from open3d_tpu_torch.core import nns
    from open3d_tpu_torch.ops import pointcloud as pc_ops
    from open3d_tpu_torch.pipelines import features

    raw, _, _, cpu = reg_clouds
    c = pc_ops.estimate_normals(pc_ops.voxel_down_sample(raw[0], 0.05), max_nn=30, radius=0.1)
    h = cpu(c)
    thr = 1 if path == "grid" else 65536
    kw = dict(radius=0.25, max_nn=64, nns_grid_threshold=thr, nns_max_per_cell=256)
    f_c = features.compute_fpfh_feature(c, **kw)
    assert torch.equal(f_c, features.compute_fpfh_feature(c, **kw))
    f_h = features.compute_fpfh_feature(h, **kw)
    grid = dict(grid_threshold=thr, max_per_cell=256)
    table = nns.hybrid_search(h.positions, h.positions, 0.25, 64, target_mask=h.mask, **grid)
    i_c, d2_c, _ = nns.hybrid_search(c.positions, c.positions, 0.25, 64, target_mask=c.mask, **grid)
    idx = table[0]
    same = _same_sets(i_c, idx)
    assert float(same[h.mask].double().mean()) > 0.99
    safe = idx.clamp(min=0).long()
    ok = (idx >= 0) & (idx != torch.arange(len(idx))[:, None])
    pos, nrm = h.positions, h.attrs["normals"]
    dev = c.positions.device
    f_dev = [features._pair_features(p[:, None], n[:, None], p[safe.to(p.device)], n[safe.to(p.device)])
             for p, n in ((pos, nrm), (pos.to(dev), nrm.to(dev)))]
    differ = torch.zeros_like(ok)
    for j, (lo, hi) in enumerate(((-3.141592653589793, 3.141592653589793), (-1.0, 1.0), (-1.0, 1.0))):
        b_h = features._bin11(f_dev[0][j], lo, hi).argmax(-1)
        b_c = features._bin11(f_dev[1][j], lo, hi).argmax(-1).cpu()
        differ |= ok & f_dev[0][4] & (b_h != b_c)
    assert int(differ.sum()) <= 1e-4 * int((ok & f_dev[0][4]).sum())
    own = differ.any(1)  # a row's SPFH: its pairs
    spfh_touched = own | (own[safe] & (idx >= 0)).any(1)
    touched = spfh_touched | ~same | (~same[safe] & (idx >= 0)).any(1)
    assert float((~touched)[h.mask].double().mean()) > 0.9
    bar = torch.full((len(idx),), 1e-3, dtype=torch.float64) if path == "grid" else _fpfh_bar(i_c, d2_c, *table[:2])
    row_err = (f_c.cpu() - f_h).abs().amax(1).double()
    assert bool((row_err <= bar)[~touched].all()), (float(row_err[~touched].max()), float(bar[~touched].min()))

    # both devices aggregating over the CPU copy's table: within 1e-3
    on_card = tuple(x.to(dev) for x in table)
    monkeypatch.setattr(nns, "hybrid_search", lambda *a, **k: on_card)
    f_s = features.compute_fpfh_feature(c, **kw)
    assert float((f_s.cpu() - f_h)[~spfh_touched].abs().max()) <= 1e-3


def test_icp_matches_a_cpu_copy(reg_clouds):
    """Banded point-to-plane ICP on the card and on a CPU copy: poses within
    1e-4 elementwise, fitness within 2/N."""
    from open3d_tpu_torch.pipelines import registration as reg

    _, card, host, _ = reg_clouds
    crit = reg.ICPConvergenceCriteria(max_iteration=10)
    a = reg.icp(card[0], card[1], 0.05, criteria=crit, nns_backend="banded")
    b = reg.icp(host[0], host[1], 0.05, criteria=crit, nns_backend="banded")
    assert float((a.transformation.cpu() - b.transformation).abs().max()) <= 1e-4
    assert abs(float(a.fitness) - float(b.fitness)) <= 2.0 / host[0].capacity
    assert float(a.fitness) > 0.5
