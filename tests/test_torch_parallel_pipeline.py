"""Port parity for parallel/pipeline.py and the mesh path of make_fragments,
at `dryrun_multichip`'s tiny shapes: 6 frames of the synthetic room at
80x60 (span 0.12) in 3 fragments of 2 frames, voxel 0.04, 512 blocks of
8^3, 4096 points a fragment, depth_max 6, 256 touched blocks a frame.

A world of 4 gloo ranks and a world of 1 (whose mesh factory starts the
one-rank group itself) run the cases of `pipeline_cases` as processes of
their own (tests/test_torch_parallel.py's rank program). 3 fragments on 4
ranks: rank 3 builds a padding fragment (all-zero depth: the 8^3 fuse gets
a work list of dump rows only) and registers a padding pair.

Bars:
- stages 1 and 2 on 4 ranks equal the same stages on 1 rank exactly (no
  reduction spans ranks, and every rank runs one thread);
- stage 1 as tests/test_distributed_pipeline.py holds it: valid
  (True, True, True, False), over 200 points in each real fragment and
  none in the padding one, each fragment's second pose within 1.2e-2 of
  the truth; stage 2 valid (True, True, False, False) and each pair within
  0.02 m of the truth;
- fragment 0's chain against the JAX package's `_fragment_chain` called
  unsharded on the same frames (the JAX package fuses through its XLA
  path, the port through K3's plain version): poses within 1e-5, the same
  point count, and every point of the JAX package's cloud within 2e-4 of
  the port's, 99 % of them within 1e-5 (measured: 1.3e-7, 8.1e-5 and
  99.6 %: the two fuses round the colour and the weighted mean in their
  own order, which moves a zero crossing by a few 1e-5 m where a voxel's
  tsdf is near zero);
- make_fragments(mesh=) of the reconstruction pipeline on 4 ranks: every
  rank returns the paths after the files exist (rank 0 writes them), the
  written clouds and pose graphs are the batch's, and a second call finds
  every fragment built and builds none.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

INTR = (80, 60, 65.6, 65.6, 39.5, 29.5)
STAGE1 = dict(voxel_size=0.04, block_count=512, block_resolution=8, point_capacity=4096,
              depth_max=6.0, frame_block_capacity=256)
PAIRS = [[0, 1], [1, 2]]


def frames():
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic

    d, c, e, _ = synthetic.render_sequence(6, intrinsic=PinholeCameraIntrinsic(*INTR),
                                           span=0.12, device="cpu")
    return d.numpy(), c.numpy(), e.numpy()


class _Sequence:
    def __init__(self, intrinsic, depths, colors):
        self.intrinsic, self.depths, self.colors = intrinsic, depths, colors

    def __len__(self):
        return len(self.depths)

    def read_frame(self, i):
        return self.depths[i], self.colors[i]


def pipeline_cases(out: dict, out_dir: str) -> None:
    """The rank program's pipeline group."""
    import os

    import torch.distributed as dist

    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.parallel import pipeline as pp
    from open3d_tpu_torch.pipelines import reconstruction as rc

    intr = PinholeCameraIntrinsic(*INTR)
    d, c, e = frames()
    out["frames"] = (d, c, e)
    dep = torch.from_numpy(d).reshape(3, 2, *d.shape[1:])
    col = torch.from_numpy(c).reshape(3, 2, *c.shape[1:])
    mesh = pp.make_pipeline_mesh(device="cpu")
    fr = pp.make_fragments_sharded(dep, col, intr, mesh, **STAGE1)
    out["stage1"] = {k: v.numpy() for k, v in fr._asdict().items()}
    regs = pp.register_pairs_sharded(fr, torch.tensor(PAIRS, dtype=torch.int32), mesh, 0.08,
                                     max_iteration=10)
    out["stage2"] = {k: v.numpy() for k, v in regs._asdict().items()}
    if dist.get_world_size() == 1:
        return
    # the reconstruction pipeline's mesh path: rank 0 writes, every rank waits
    cfg = rc.ReconstructionConfig(fragment_size=2, voxel_size=0.02, block_count=512,
                                  depth_max=6.0, trunc_voxel_multiplier=4.0,
                                  fragment_point_capacity=4096,
                                  path_output=os.path.join(out_dir, "recon"))
    seq = _Sequence(intr, d, c)
    paths = rc.make_fragments(seq, cfg, mesh=mesh, device="cpu")
    out["paths"] = paths
    out["exist_on_return"] = [os.path.isfile(p) and os.path.isfile(p[:-3] + "json")
                              for p in paths]
    built = []
    orig = rc._make_fragments_via_mesh
    rc._make_fragments_via_mesh = lambda *a: built.append(a[6])
    rc.make_fragments(seq, cfg, mesh=mesh, device="cpu")
    rc._make_fragments_via_mesh = orig
    out["rebuilt"] = built


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two worlds, started (4 ranks and 1)."""
    from test_torch_parallel import spawn_world

    tmp = tmp_path_factory.mktemp("pipeline_worlds")
    return {n: spawn_world("pipeline", n, tmp / f"world{n}") for n in (4, 1)}


@pytest.fixture(scope="module")
def jax_chain(spawned):
    """The JAX package's chain on fragment 0, unsharded (run while the
    ranks work)."""
    import jax.numpy as jnp

    from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
    from open3d_tpu.parallel import pipeline as jpp

    d, c, _ = frames()
    s = STAGE1
    out = jpp._fragment_chain(jnp.asarray(d[:2]), jnp.asarray(c[:2]), JIntr(*INTR),
                              s["voxel_size"], s["block_count"], s["block_resolution"],
                              s["point_capacity"], s["depth_max"], s["frame_block_capacity"],
                              jnp.bool_(True))
    return [np.asarray(x) for x in out], d


@pytest.fixture(scope="module")
def results(spawned, jax_chain):
    return {n: wait() for n, wait in spawned.items()}


def test_ranks_see_the_same_frames_and_import_no_jax(results, jax_chain):
    _, d = jax_chain
    for n, ranks in results.items():
        for r in ranks:
            assert r["modules"] == [] and r["backend"] == "gloo" and r["world"] == n
            np.testing.assert_array_equal(r["frames"][0], d)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_four_ranks_equal_one_rank(results, stage):
    """Row for row: one rank pads to 3 fragments / 2 pairs, four to 4."""
    one = results[1][0][stage]
    for r in results[4]:
        for k, v in one.items():
            np.testing.assert_array_equal(r[stage][k][:len(v)], v,
                                          err_msg=f"{stage} {k} rank {r['rank']}")


def test_stage1_against_the_truth(results):
    fr = results[4][0]["stage1"]
    _, _, extr = results[4][0]["frames"]
    assert fr["valid"].tolist() == [True, True, True, False]
    counts = fr["mask"].sum(1)
    assert (counts[:3] > 200).all() and counts[3] == 0, counts
    for f in range(3):
        gt_rel = extr[2 * f] @ np.linalg.inv(extr[2 * f + 1])
        np.testing.assert_allclose(fr["poses"][f, 1], gt_rel, atol=1.2e-2)


def test_stage2_against_the_truth(results):
    regs = results[4][0]["stage2"]
    _, _, extr = results[4][0]["frames"]
    assert regs["valid"].tolist() == [True, True, False, False]
    assert np.isfinite(regs["transformations"]).all()
    for e, (s, t) in enumerate(PAIRS):
        gt = extr[2 * t] @ np.linalg.inv(extr[2 * s])
        err = np.linalg.norm(regs["transformations"][e, :3, 3] - gt[:3, 3])
        assert err < 0.02, (e, err)


def test_chain_matches_the_reference_chain(results, jax_chain):
    (jpos, _, jmask, jposes), _ = jax_chain
    fr = results[4][0]["stage1"]
    np.testing.assert_allclose(fr["poses"][0], jposes, atol=1e-5)
    tpos = fr["positions"][0][fr["mask"][0]]
    assert tpos.shape[0] == int(jmask.sum())
    d = np.sqrt(((jpos[jmask][:, None, :] - tpos[None, :, :]) ** 2).sum(-1)).min(1)
    assert d.max() < 2e-4 and (d < 1e-5).mean() >= 0.99, (d.max(), (d < 1e-5).mean())


def test_make_fragments_with_a_mesh_writes_once_and_restarts(results):
    from open3d_tpu_torch import io as tio
    from open3d_tpu_torch.pipelines import pose_graph as tpg

    ranks = results[4]
    paths = ranks[0]["paths"]
    assert len(paths) == 3
    for r in ranks:
        assert r["paths"] == paths and all(r["exist_on_return"]) and r["rebuilt"] == []
    for p in paths:
        assert Path(p).is_file()
        cloud = tio.read_point_cloud(p, device="cpu")
        assert int(cloud.count()) > 200
        graph = tpg.read_pose_graph(p[:-3] + "json", device="cpu")
        assert graph.poses.shape[0] == 2
