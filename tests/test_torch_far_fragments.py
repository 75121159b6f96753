"""Port parity for register_fragments where adjacent fragments lie far
apart (ROADMAP.md §3 fault 11): tests/test_torch_reconstruction.py's three
fragments, written once by the port, over a 1.2 rad orbit (0.4 rad between
adjacent fragments, where that file's 0.4 rad orbit puts 0.13). Each
package starts an adjacent pair's ICP from the identity, so the overlap
gate, the identity fallback and the loop edge's fate turn on how far that
ICP gets. The port must decide as the JAX package does: the same edges and
the same uncertain and kept masks; the identity exactly where the JAX
package fell back to it; and each other adjacent edge within 0.05 of the
truth in both packages or in neither. Where ICP stops in a local minimum
its pose is not compared between the packages: the few normals the two
eigensolvers pick differently (tests/test_torch_reconstruction.py) move
that minimum by centimetres.
"""

import numpy as np
import torch

from open3d_tpu.pipelines import reconstruction as jrc
from open3d_tpu_torch.core import lie
from open3d_tpu_torch.pipelines import reconstruction as trc
from test_torch_reconstruction import config, write_fragments

torch.set_num_threads(2)


def test_far_adjacent_fragments_register_in_neither_package(tmp_path):
    paths, truth = write_fragments(str(tmp_path / "fragments"), span=1.2)[3:]
    gj = jrc.register_fragments(paths, jrc.ReconstructionConfig(**config(str(tmp_path / "j"))))
    gt = trc.register_fragments(paths, trc.ReconstructionConfig(**config(str(tmp_path / "p"))),
                                device="cpu")
    edges = gt.edges.tolist()
    assert edges == np.asarray(gj.edges).tolist()
    assert gt.uncertain.tolist() == np.asarray(gj.uncertain).tolist()
    assert gt.edge_valid.tolist() == np.asarray(gj.edge_valid).tolist()
    eye = np.eye(4, dtype=np.float32)
    for k, (s, t) in enumerate(edges):
        if t != s + 1:
            continue  # RANSAC's draws differ between the packages
        Xt, Xj = gt.transformations[k].numpy(), np.asarray(gj.transformations[k])
        assert np.array_equal(Xt, eye) == np.array_equal(Xj, eye), (s, t)
        X_true = torch.from_numpy((np.linalg.inv(truth[s]) @ truth[t]).astype(np.float32))
        near = [max(float(v) for v in lie.pose_distance(torch.from_numpy(X), X_true)) < 0.05
                for X in (Xt, Xj)]
        assert near[0] == near[1], (s, t)
