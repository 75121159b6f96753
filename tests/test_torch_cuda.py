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
