"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small sizes. They need a CUDA card and skip without one; on a machine
with a card and no JAX run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bars: the kernels fuse multiply-adds at the same places as their plain
versions and round alike, so on the same card they agree exactly.
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


@pytest.mark.parametrize("with_color", [True, False])
def test_fuse_kernel_matches_plain(cuda, with_color):
    from open3d_tpu_torch.ops.kernels import tsdf as k3

    gen = torch.Generator().manual_seed(1)
    C, M, B3 = 64, 32, 512
    tw = torch.randint(-2**31, 2**31 - 1, (C + 1, B3), generator=gen, dtype=torch.int32)
    col = torch.randint(0, 2**31 - 1, (C + 1, B3), generator=gen, dtype=torch.int32)
    rows = torch.randperm(C, generator=gen)[:M].to(torch.int32)
    rows[::5] = C
    tsdf_new = torch.rand((M, B3), generator=gen) * 2 - 1
    wn = (torch.rand((M, B3), generator=gen) > 0.3).float()
    cnew = torch.randint(0, 2**31 - 1, (M, B3), generator=gen, dtype=torch.int32)
    a = [x.to(cuda) for x in (tw, col, rows, tsdf_new, wn, cnew)]
    b = [x.clone() for x in a]
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
    live = rows[rows < C].long()
    assert bool((a[0].cpu()[live] != tw[live]).any())


def test_wrapper_raises_on_mixed_devices(scene):
    from open3d_tpu_torch.ops.kernels import integrate2 as k1

    g, d, c, e, intr = scene
    d21, rgb24 = k1.prepare_frame(d[0], c[0], 3.0)
    slots = torch.zeros(4, dtype=torch.int32)  # on the CPU
    coords = torch.zeros((4, 3), dtype=torch.int32, device=g.device)
    with pytest.raises(ValueError):
        k1.integrate_blocks_v2(g.tw, g.color, slots, coords, d21, rgb24, intr, e[0],
                               g.voxel_size, g.sdf_trunc, 3.0)
