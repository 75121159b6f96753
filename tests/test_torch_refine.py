"""Port parity for stage 3 of the offline system, refine_registration, on
tests/test_torch_reconstruction.py's three fragments (written once by the
port, `write_fragments`), from one scene graph: the true fragment poses,
each edge's transform nudged by 0.01 rad and 5 mm.

Bars: the same edges kept; refined transforms and optimised poses within
1e-3, information matrices within 1e-3 of their largest entry. The
multi-scale ICP estimates normals at every scale, and a handful of points
with a near-degenerate neighbourhood get different smallest-eigenvalue
directions from the two eigensolvers, which moves an edge by ~1.4e-4
(tests/test_torch_reconstruction.py holds the ICP itself to 1e-4 on the
JAX package's own normals). The poses within 0.02 of the truth.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu.pipelines import reconstruction as jrc
from open3d_tpu_torch.pipelines import pose_graph as tpg
from open3d_tpu_torch.pipelines import reconstruction as trc
from test_torch_reconstruction import N_FRAG, config, write_fragments

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Fragments under <root>/jax and <root>/port (one write, copied), and
    the scene graph JSON both packages read."""
    root = tmp_path_factory.mktemp("scene")
    truth = write_fragments(str(root / "port"))[4]
    shutil.copytree(root / "port" / "fragments", root / "jax" / "fragments")
    rng = np.random.default_rng(0)
    edges = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    X = []
    for s, t in edges:
        nudge = np.eye(4)
        nudge[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
        nudge[:3, 3] = rng.normal(0, 0.005, 3)
        X.append(np.linalg.inv(truth[s]) @ truth[t] @ nudge)
    graph = tpg.PoseGraph.create(truth.astype(np.float32), edges, np.stack(X).astype(np.float32),
                                 informations=np.tile(np.eye(6, dtype=np.float32) * 500, (3, 1, 1)),
                                 uncertain=np.array([False, True, False]), device="cpu")
    graph_path = str(root / "scene_graph.json")
    tpg.write_pose_graph(graph_path, graph)
    return root, truth, graph_path


def _paths(root, pkg):
    return [str(root / pkg / "fragments" / f"fragment_{f:03d}.ply") for f in range(N_FRAG)]


def test_refine_registration_matches_reference(scene):
    root, truth, graph_path = scene
    cj = jrc.ReconstructionConfig(**config(str(root / "jax")))
    ct = trc.ReconstructionConfig(**config(str(root / "port")))
    rj = jrc.refine_registration(_paths(root, "jax"), jpg.read_pose_graph(graph_path), cj)
    rt = trc.refine_registration(_paths(root, "port"), tpg.read_pose_graph(graph_path, device="cpu"),
                                 ct, device="cpu")
    assert rt.edges.tolist() == np.asarray(rj.edges).tolist()
    np.testing.assert_array_equal(rt.edge_valid.numpy(), np.asarray(rj.edge_valid))
    for k in range(rt.edges.shape[0]):
        np.testing.assert_allclose(rt.transformations[k].numpy(), np.asarray(rj.transformations[k]),
                                   atol=1e-3, rtol=0)
        info_j = np.asarray(rj.informations[k])
        assert np.abs(rt.informations[k].numpy() - info_j).max() < 1e-3 * np.abs(info_j).max()
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.poses.numpy(), truth, atol=0.02, rtol=0)
    back = tpg.read_pose_graph(os.path.join(ct.path_output, "scene", "refined_registration.json"),
                               device="cpu")
    assert torch.equal(back.transformations, rt.transformations)
