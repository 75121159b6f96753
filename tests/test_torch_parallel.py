"""Port parity for parallel/: the distributed solvers and the multiway step,
run by a world of 4 gloo ranks on the CPU, against the JAX package on a
4-device slice of the conftest's virtual CPU devices (so both pad the
same way).

The ranks are processes of their own, this file run as a program (`python
tests/test_torch_parallel.py GROUP RANK WORLD STORE OUT`), one thread each;
they meet through a FileStore under the test's tmp directory (no TCP port,
so xdist workers cannot collide), run the cases of GROUP, and each saves
what it computed and the modules it imported. The rank program imports no
JAX: the JAX package runs in the test process only. One spawn serves the
file (module-scoped fixture); tests/test_torch_parallel_pipeline.py
spawns the pipeline group through `spawn_world`.

Cases and bars (the JAX package's own tests' bars):
- `_solve_distributed` (the edge-sharded CG of `solve_pose_graph_cg`) on
  4 ranks, 14 edges (padded to 16): within rtol 1e-4, atol 1e-6 of the
  JAX package's 4-device solve and of the port's unsharded CG
  (tests/test_distributed_solver.py:89);
- `global_optimization(mesh=)`: the edge residual falls below 0.35x its
  start (:92-100), the same on every rank;
- `ba_gauss_newton`, 105 observations (not divisible by 4): poses and
  landmarks within rtol 1e-4, atol 1e-5 of the JAX package's 4-device run
  and of the port's unsharded run (:170-171);
- `multiway_gn_step` on a 2x2 ("edges", "points") mesh, 5 edges over 2
  (padded) and 1023 points a fragment over 2 (padded): poses within atol
  1e-4, inliers rtol 1e-6, RMSE atol 1e-5 of the JAX package's 2x2 step
  and of the port's unsharded step (tests/test_parallel.py:83-85);
- every rank returns the same results; no rank imported jax or
  open3d_tpu.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
FORBIDDEN = ("jax", "jaxlib", "open3d_tpu")


# ---------------------------------------------------------------------------
# The rank program
# ---------------------------------------------------------------------------


def _se3(xi) -> np.ndarray:
    from open3d_tpu_torch.core import lie

    return lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def random_graph(F=12, n_loops=6, seed=0, noise=0.02):
    """tests/test_distributed_solver.py's graph: a random trajectory, a noisy
    odometry chain, exact loop closures, noisy start poses (numpy)."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(F - 1):
        gt.append(gt[-1] @ _se3(np.concatenate([rng.normal(0, 0.1, 3), rng.normal(0, 0.3, 3)])))
    edges, trans, unc = [], [], []
    for i in range(F - 1):
        X = np.linalg.inv(gt[i]) @ gt[i + 1]
        edges.append((i, i + 1))
        trans.append(X @ _se3(np.concatenate([rng.normal(0, noise, 3), rng.normal(0, noise, 3)])))
        unc.append(False)
    for _ in range(n_loops):
        i, j = sorted(rng.choice(F, 2, replace=False))
        edges.append((i, j))
        trans.append(np.linalg.inv(gt[i]) @ gt[j])
        unc.append(True)
    noisy = [gt[0]]
    for i in range(F - 1):
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.05, 3)])
        noisy.append(noisy[-1] @ np.linalg.inv(gt[i]) @ gt[i + 1] @ _se3(xi))
    return dict(poses=np.stack(noisy).astype(np.float32), edges=np.asarray(edges, np.int32),
                trans=np.stack(trans).astype(np.float32), unc=np.asarray(unc))


def ba_problem(F=5, L=21, seed=5, obs_noise=0.002):
    """tests/test_distributed_solver.py's BA problem (every camera sees
    every landmark), fragment 1 perturbed."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (L, 3)).astype(np.float32)
    poses = np.stack([_se3(np.concatenate([rng.normal(0, 0.2, 3), rng.normal(0, 0.5, 3)]))
                      for _ in range(F)])
    cam, lm, p = [], [], []
    for f in range(F):
        W = np.linalg.inv(poses[f])
        for k in range(L):
            cam.append(f)
            lm.append(k)
            p.append(W[:3, :3] @ X[k] + W[:3, 3] + rng.normal(0, obs_noise, 3))
    noisy = poses.copy()
    noisy[1] = poses[1] @ _se3([0.01, -0.02, 0.015, 0.02, 0.0, -0.01])
    return dict(poses=noisy.astype(np.float32), points=X, cam=np.asarray(cam, np.int32),
                lm=np.asarray(lm, np.int32), p=np.asarray(p, np.float32),
                w=np.ones(len(cam), np.float32))


def multiway_inputs(F=4, N=1023):
    """Four surface samplings of the synthetic scene, each moved into a
    perturbed local frame; a chain with two closures (5 edges)."""
    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.data import synthetic

    rng = np.random.default_rng(1)
    pos, nrm, mask = [], [], []
    for i in range(F):
        pc = synthetic.sample_surface(synthetic.default_scene_sdf,
                                      torch.Generator().manual_seed(10 + i), N)
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.03, 3)]) * (i > 0)
        T_inv = lie.invert_se3(torch.as_tensor(_se3(xi)))
        pos.append(lie.transform_points(T_inv, pc.positions).numpy())
        nrm.append(lie.rotate_vectors(T_inv, pc.attrs["normals"]).numpy())
        mask.append(pc.mask.numpy())
    edges = np.asarray([(0, 1), (1, 2), (2, 3), (0, 3), (1, 3)], np.int32)
    return dict(pos=np.stack(pos), nrm=np.stack(nrm), mask=np.stack(mask), edges=edges,
                poses=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def solver_cases(out: dict) -> None:
    from open3d_tpu_torch.parallel import fragments as pf
    from open3d_tpu_torch.parallel import multihost
    from open3d_tpu_torch.parallel import solver as ds
    from open3d_tpu_torch.pipelines import pose_graph as pg

    g = random_graph(F=10, n_loops=5, seed=3)
    graph = pg.PoseGraph.create(g["poses"], g["edges"], g["trans"], uncertain=g["unc"],
                                device="cpu")
    w = torch.where(graph.edge_valid, 1.0, 0.0)
    lam = torch.tensor(1e-3)
    mesh_e = multihost.make_mesh(("edges",), device="cpu")
    out["cg_graph"] = g
    out["cg_mesh"] = pg._solve_distributed(graph, w, lam, 0, mesh_e, "edges").numpy()
    out["cg_local"] = pg._solve_distributed(graph, w, lam, 0, None, "edges").numpy()

    g = random_graph(F=10, n_loops=5, seed=1)
    graph = pg.PoseGraph.create(g["poses"], g["edges"], g["trans"], uncertain=g["unc"],
                                device="cpu")
    opt = pg.global_optimization(
        graph, criteria=pg.GlobalOptimizationConvergenceCriteria(max_iteration=30), mesh=mesh_e)
    ev = graph.edge_valid
    out["go_r0"] = float(torch.linalg.norm(pg._residuals(graph)[ev]))
    out["go_r1"] = float(torch.linalg.norm(pg._residuals(opt)[ev]))
    out["go_poses"] = opt.poses.numpy()

    b = ba_problem()
    prob = ds.BAProblem(_t(b["cam"]), _t(b["lm"]), _t(b["p"]), _t(b["w"]))
    mesh_o = multihost.make_mesh(("obs",), device="cpu")
    out["ba"] = b
    out["ba_mesh"] = [x.numpy() for x in ds.ba_gauss_newton(
        _t(b["poses"]), _t(b["points"]), prob, mesh=mesh_o, n_outer=3)]
    out["ba_local"] = [x.numpy() for x in ds.ba_gauss_newton(
        _t(b["poses"]), _t(b["points"]), prob, n_outer=3)]

    m = multiway_inputs()
    args = (_t(m["pos"]), _t(m["nrm"]), _t(m["mask"]), _t(m["poses"]), _t(m["edges"]),
            torch.ones(len(m["edges"]), dtype=torch.bool))
    mesh2 = pf.make_mesh(device="cpu")
    out["mw"] = m
    out["mw_mesh_shape"] = tuple(mesh2.mesh.shape)
    out["mw_mesh"] = [x.numpy() for x in pf.multiway_gn_step(*args, 0.2, mesh=mesh2)]
    out["mw_local"] = [x.numpy() for x in pf.multiway_gn_step(*args, 0.2)]


def _rank_main(group: str, rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
    # world 1: the mesh factories start the one-rank group themselves
    out = {"rank": rank}
    if group == "solvers":
        solver_cases(out)
    else:
        from test_torch_parallel_pipeline import pipeline_cases

        pipeline_cases(out, out_dir)
    out["world"] = dist.get_world_size()
    out["backend"] = dist.get_backend()
    out["modules"] = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_world(group: str, world: int, tmp: Path, timeout: float = 600):
    """Start `world` rank processes on the cases of `group` (not waited
    for). Returns a function that waits for them and returns each rank's
    results."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), group, str(r), str(world), str(tmp / "store"),
         str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def wait():
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]

    return wait


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])


# ---------------------------------------------------------------------------
# The tests (JAX in this process only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wait = spawn_world("solvers", WORLD, tmp_path_factory.mktemp("solver_world"))
    return wait()


def _jax_mesh(name):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]), (name,))


def test_ranks_import_no_jax_and_run_gloo(ranks):
    for r in ranks:
        assert r["modules"] == [], f"rank {r['rank']} imported {r['modules']}"
        assert r["world"] == WORLD and r["backend"] == "gloo"


def _arrays(x) -> list:
    return x if isinstance(x, list) else [x]


@pytest.mark.parametrize("key", ["cg_mesh", "go_poses", "ba_mesh", "mw_mesh"])
def test_every_rank_returns_the_same(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(_arrays(ranks[0][key]), _arrays(r[key])):
            np.testing.assert_array_equal(a, b)


def test_sharded_cg_matches_the_reference_and_the_local_cg(ranks):
    import jax
    import jax.numpy as jnp

    from open3d_tpu.pipelines import pose_graph as jpg

    r = ranks[0]
    g = r["cg_graph"]
    graph = jpg.PoseGraph.create(g["poses"], g["edges"], g["trans"], uncertain=g["unc"])
    w = jnp.where(graph.edge_valid, 1.0, 0.0)
    mesh = _jax_mesh("edges")
    ref = np.asarray(jax.jit(lambda g: jpg._solve_distributed(
        g, w, jnp.float32(1e-3), 0, mesh, "edges"))(graph))
    np.testing.assert_allclose(r["cg_mesh"], ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["cg_mesh"], r["cg_local"], rtol=1e-4, atol=1e-6)


def test_global_optimization_with_a_mesh_converges(ranks):
    r = ranks[0]
    assert r["go_r1"] < 0.35 * r["go_r0"], (r["go_r0"], r["go_r1"])


def test_sharded_ba_matches_the_reference_and_the_local_ba(ranks):
    import jax
    import jax.numpy as jnp

    from open3d_tpu.parallel import solver as jds

    r = ranks[0]
    b = r["ba"]
    assert len(b["cam"]) % WORLD != 0
    prob = jds.BAProblem(jnp.asarray(b["cam"]), jnp.asarray(b["lm"]), jnp.asarray(b["p"]),
                         jnp.asarray(b["w"]))
    mesh = _jax_mesh("obs")
    ref = jax.jit(lambda P, X: jds.ba_gauss_newton(P, X, prob, mesh=mesh, n_outer=3))(
        jnp.asarray(b["poses"]), jnp.asarray(b["points"]))
    for got, local, want in zip(r["ba_mesh"][:2], r["ba_local"][:2], ref[:2]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, local, rtol=1e-4, atol=1e-5)


def test_sharded_multiway_step_matches_the_reference_and_the_local_step(ranks):
    import jax
    import jax.numpy as jnp

    from open3d_tpu.parallel import fragments as jpf

    r = ranks[0]
    m = r["mw"]
    assert r["mw_mesh_shape"] == (2, 2)
    mesh = jpf.make_mesh(WORLD)
    ref = jax.jit(lambda *a: jpf.multiway_gn_step(*a, max_correspondence_distance=0.2,
                                                  mesh=mesh))(
        jnp.asarray(m["pos"]), jnp.asarray(m["nrm"]), jnp.asarray(m["mask"]),
        jnp.asarray(m["poses"]), jnp.asarray(m["edges"]), jnp.ones(len(m["edges"]), bool))
    for other in ([np.asarray(x) for x in ref], r["mw_local"]):
        np.testing.assert_allclose(r["mw_mesh"][0], other[0], atol=1e-4)
        np.testing.assert_allclose(r["mw_mesh"][2], other[2], rtol=1e-6)
        np.testing.assert_allclose(r["mw_mesh"][1], other[1], atol=1e-5)
