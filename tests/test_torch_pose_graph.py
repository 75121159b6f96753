"""Port parity: pose-graph optimisation of open3d_tpu_torch against
open3d_tpu on a seeded 8-node chain with loop closures and one gross
outlier loop, and the JSON schema.

Tolerances: poses and confidences within 1e-4 (the LM steps are the same;
the dense solve and the Jacobian sums round in another order), edge_valid
equal, to_json_dict equal to JAX's within 1e-6.

Near its optimum the LM accepts or rejects a step by comparing two float32
costs that the packages compute to about 1e-6 relative, so where the optimum
is flat the two can stop one step apart (up to 2e-4 in pose on other seeds
and line-process scales). The graph here has a clear optimum: odometry noise
0.01, and a line-process scale (max_correspondence_distance 0.3) at which
the true loops keep a confidence near 1 and the outlier loop drops to ~0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu_torch import convert
from open3d_tpu_torch.pipelines import pose_graph as tpg

torch.set_num_threads(2)
TOL = 1e-4
JSON_TOL = 1e-6


def _graph_arrays(F=8, seed=1):
    """A circle of F poses; a noisy odometry chain (certain), four near-exact
    loop closures and one gross outlier loop (uncertain)."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(F):
        th = 2 * np.pi * i / F
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        T[:3, 3] = [2.0 * np.cos(th), 2.0 * np.sin(th), 0.1 * i]
        gt.append(T)
    gt = np.stack(gt)

    def noise(scale):
        return np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, scale, 6).astype(np.float32))))

    edges, trans, unc = [], [], []
    for i in range(F - 1):
        edges.append((i, i + 1))
        trans.append(noise(0.01) @ np.linalg.inv(gt[i]) @ gt[i + 1])
        unc.append(False)
    for i, j in [(0, 4), (1, 5), (0, 7), (2, 6)]:
        edges.append((i, j))
        trans.append(noise(0.001) @ np.linalg.inv(gt[i]) @ gt[j])
        unc.append(True)
    bogus = np.eye(4, dtype=np.float32)
    bogus[:3, 3] = (1.5, -1.0, 0.7)
    edges.append((3, 6))
    trans.append(bogus)
    unc.append(True)
    init = [gt[0]]
    for i in range(F - 1):
        init.append(init[-1] @ trans[i])
    infos = np.tile(500.0 * np.eye(6, dtype=np.float32), (len(edges), 1, 1))
    infos[3::2] *= 0.7
    return (np.stack(init).astype(np.float32), np.asarray(edges, np.int32),
            np.stack(trans).astype(np.float32), infos, np.asarray(unc))


@pytest.fixture(scope="module")
def graphs():
    a = _graph_arrays()
    return jpg.PoseGraph.create(*a[:3], informations=a[3], uncertain=a[4]), \
        tpg.PoseGraph.create(*a[:3], informations=a[3], uncertain=a[4], device="cpu")


def _same(gj, gt):
    np.testing.assert_allclose(np.asarray(gj.poses), gt.poses.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(gj.confidence), gt.confidence.numpy(), atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(gj.edge_valid), gt.edge_valid.numpy())


def test_residuals_and_jacobians(graphs):
    gj, gt = graphs
    s, t = np.asarray(gj.edges[:, 0]), np.asarray(gj.edges[:, 1])
    rj = jax.vmap(jpg._edge_residual)(gj.poses[s], gj.poses[t], gj.transformations)
    np.testing.assert_allclose(np.asarray(rj), tpg._residuals(gt).numpy(), atol=1e-5, rtol=0)
    Jj = jpg._edge_jac(gj.poses[s], gj.poses[t], gj.transformations)
    Jt = tpg._edge_jac(gt.poses[s], gt.poses[t], gt.transformations)
    np.testing.assert_allclose(np.asarray(Jj), Jt.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("two_pass", [False, True])
def test_global_optimization(graphs, two_pass):
    gj, gt = graphs
    opt = dict(max_correspondence_distance=0.3, preference_loop_closure=1.0)
    if two_pass:
        oj = jpg.global_optimization_two_pass(gj, jpg.GlobalOptimizationOption(**opt))
        ot = tpg.global_optimization_two_pass(gt, tpg.GlobalOptimizationOption(**opt))
    else:
        oj = jpg.global_optimization(gj, jpg.GlobalOptimizationOption(**opt))
        ot = tpg.global_optimization(gt, tpg.GlobalOptimizationOption(**opt))
    _same(oj, ot)
    assert not bool(ot.edge_valid[-1])  # the outlier loop is pruned
    assert bool(ot.edge_valid[:7].all())
    dj = jpg.to_json_dict(oj)
    dt = tpg.to_json_dict(ot)
    assert json.dumps(dj, sort_keys=True).count(":") == json.dumps(dt, sort_keys=True).count(":")
    assert [e["source_node_id"] for e in dj["edges"]] == [e["source_node_id"] for e in dt["edges"]]
    for a, b in zip(dj["nodes"], dt["nodes"]):
        np.testing.assert_allclose(a["pose"], b["pose"], atol=TOL)


def test_json_dict_and_io(graphs, tmp_path):
    gj, gt = graphs
    dj, dt = jpg.to_json_dict(gj), tpg.to_json_dict(gt)
    assert dj.keys() == dt.keys() and len(dj["edges"]) == len(dt["edges"]) == 12
    for key in ("nodes", "edges"):
        for a, b in zip(dj[key], dt[key]):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], list):
                    np.testing.assert_allclose(a[k], b[k], atol=JSON_TOL, rtol=0)
                else:
                    assert a[k] == b[k], k
    p = str(tmp_path / "pg.json")
    tpg.write_pose_graph(p, gt)
    back = tpg.read_pose_graph(p, device="cpu")
    for f in ("poses", "edges", "transformations", "informations", "uncertain", "edge_valid"):
        assert torch.equal(getattr(back, f), getattr(gt, f)), f
    # a file written by the JAX package reads back through the port
    jpg.write_pose_graph(p, gj)
    assert torch.equal(tpg.read_pose_graph(p, device="cpu").poses, gt.poses)


def test_pose_graph_carried_across(graphs):
    """JAX -> numpy -> port -> numpy, bit-identical."""
    gj, _ = graphs
    arrays = {f: np.asarray(getattr(gj, f)) for f in convert.POSE_GRAPH_FIELDS}
    back = convert.pose_graph_to_numpy(convert.pose_graph_from_numpy(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for f in arrays:
        assert back[f].dtype == arrays[f].dtype and np.array_equal(back[f], arrays[f]), f


def test_distributed_solve_raises(graphs):
    """global_optimization(mesh=) takes the edge-sharded solve (held against
    the JAX package on 4 gloo ranks in tests/test_torch_parallel.py); a
    mesh that is not a DeviceMesh is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpg.global_optimization(graphs[1], mesh=object())


def test_singular_system_gives_nan_as_the_reference_does():
    """A damped system singular in float32 (a rank-one block whose damping
    rounds away) solves to NaN in both packages, so the LM step counts as
    not improved; the port does not raise."""
    H = np.zeros((2, 2, 6, 6), np.float32)
    H[1, 1] = 1e4
    b = np.ones((2, 6), np.float32)
    dj = np.asarray(jpg._solve(jnp.asarray(H), jnp.asarray(b), jnp.float32(0.0), 0))
    dt = tpg._solve(torch.from_numpy(H), torch.from_numpy(b), torch.tensor(0.0), 0).numpy()
    assert np.isnan(dj).all() and np.isnan(dt).all()
    ok = tpg._solve(torch.from_numpy(H), torch.from_numpy(b), torch.tensor(1e-4), 0).numpy()
    assert np.isfinite(ok).all()
