"""Pose-graph optimisation (port of open3d_tpu/pipelines/pose_graph.py):
robust Levenberg-Marquardt with line-process weights on the loop-closure
edges, and the Open3D pose-graph JSON.

- The edge residual is zeta = log(X^-1 T_s^-1 T_t); the exact 6x12 edge
  Jacobians come from torch.func.vmap(torch.func.jacfwd(...)) of that
  residual under left perturbations of both poses, as the JAX package takes
  them from jax.vmap(jax.jacfwd(...)).
- The Hessian is assembled as (F, F, 6, 6) blocks and solved densely
  (torch.linalg.solve); a fragment has tens of nodes. With a mesh, the
  inner solve is parallel/solver.py's edge-sharded matrix-free PCG.
- The JAX package runs the LM loop in lax.while_loop; here it is a Python
  loop that reads its stop flag once per iteration (one host sync), with
  the same state updates, so the iterates are the same.

Convention: node pose T_i maps node-local -> world; edge (s, t) stores X
with T_t ~= T_s @ X. This module has no kernel.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.masking import _scatter_add
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.parallel import multihost
from open3d_tpu_torch.parallel import solver as dsolver


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph.

    poses (F, 4, 4) f32; edges (E, 2) int32 [source, target];
    transformations (E, 4, 4); informations (E, 6, 6); uncertain (E,) bool
    (True = loop closure, subject to the line process); confidence (E,)
    f32; edge_valid (E,) bool marks live rows (pruned or padded rows
    False)."""

    poses: torch.Tensor
    edges: torch.Tensor
    transformations: torch.Tensor
    informations: torch.Tensor
    uncertain: torch.Tensor
    confidence: torch.Tensor
    edge_valid: torch.Tensor

    @staticmethod
    def create(poses, edges, transformations, informations=None, uncertain=None,
               edge_valid=None, device=None) -> "PoseGraph":
        """From host or device arrays; `device` defaults to that of `poses`
        when it is a tensor, else to the card."""
        if device is None and isinstance(poses, torch.Tensor):
            dev = poses.device
        else:
            dev = default_device(device)

        def arr(x, dtype):
            return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                                   dtype=dtype, device=dev)

        poses = arr(poses, torch.float32)
        edges = arr(edges, torch.int32)
        transformations = arr(transformations, torch.float32)
        E = edges.shape[0]
        if informations is None:
            informations = torch.eye(6, dtype=torch.float32, device=dev).expand(E, 6, 6).clone()
        else:
            informations = arr(informations, torch.float32)
        uncertain = (torch.zeros(E, dtype=torch.bool, device=dev) if uncertain is None
                     else arr(uncertain, torch.bool))
        edge_valid = (torch.ones(E, dtype=torch.bool, device=dev) if edge_valid is None
                      else arr(edge_valid, torch.bool))
        return PoseGraph(poses=poses, edges=edges, transformations=transformations,
                         informations=informations, uncertain=uncertain,
                         confidence=torch.ones(E, dtype=torch.float32, device=dev),
                         edge_valid=edge_valid)


@dataclasses.dataclass(frozen=True)
class GlobalOptimizationOption:
    max_correspondence_distance: float = 0.075
    edge_prune_threshold: float = 0.25
    preference_loop_closure: float = 1.0
    reference_node: int = 0


@dataclasses.dataclass(frozen=True)
class GlobalOptimizationConvergenceCriteria:
    max_iteration: int = 100
    min_relative_increment: float = 1e-6
    max_iteration_lm: int = 20


def _edge_residual(T_s, T_t, X):
    """zeta = log(X^-1 T_s^-1 T_t)."""
    return lie.se3_log(lie.invert_se3(X) @ lie.invert_se3(T_s) @ T_t)


def _edge_residual_perturbed(delta, T_s, T_t, X):
    """The residual under left perturbations exp(d_s) T_s, exp(d_t) T_t.
    The poses carry a leading axis of one: torch's forward AD gives the
    product of a 0-d tensor and a Python float a float64 tangent, and the
    rotation angle of a single unbatched pose is 0-d."""
    d_s, d_t = delta[None, :6], delta[None, 6:]
    return _edge_residual(lie.se3_exp(d_s) @ T_s, lie.se3_exp(d_t) @ T_t, X)[0]


def _edge_jac(T_s, T_t, X):
    """(E, 6, 12) Jacobians of every edge's residual at delta = 0."""
    jac = torch.func.vmap(torch.func.jacfwd(_edge_residual_perturbed), in_dims=(None, 0, 0, 0))
    return jac(torch.zeros(12, dtype=torch.float32, device=T_s.device),
               T_s[:, None], T_t[:, None], X[:, None])


def _residuals(graph: PoseGraph):
    s, t = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    return _edge_residual(graph.poses[s], graph.poses[t], graph.transformations)


def _line_process_weights(r, Lambda, uncertain, valid, mu):
    """Closed-form line-process update."""
    quad = torch.einsum("ei,eij,ej->e", r, Lambda, r)
    l = (mu / (mu + quad)) ** 2
    w = torch.where(uncertain, l, 1.0)
    return torch.where(valid, w, 0.0)


def _cost(r, Lam):
    return torch.sum(torch.einsum("ea,eab,eb->e", r, Lam, r))


def _build_system(graph: PoseGraph, weights):
    """H (F, F, 6, 6), b (F, 6) and the weighted cost, from all edges at once."""
    F = graph.poses.shape[0]
    s, t = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    T_s = graph.poses[s]
    T_t = graph.poses[t]
    r = _edge_residual(T_s, T_t, graph.transformations)  # (E, 6)
    J = _edge_jac(T_s, T_t, graph.transformations)  # (E, 6, 12)
    Js, Jt = J[:, :, :6], J[:, :, 6:]
    Lam = graph.informations * weights[:, None, None]
    JsL = torch.einsum("eai,eab->ebi", Js, Lam)  # Js^T Lambda
    JtL = torch.einsum("eai,eab->ebi", Jt, Lam)
    blocks = torch.cat([
        torch.einsum("ebi,ebj->eij", JsL, Js),
        torch.einsum("ebi,ebj->eij", JsL, Jt),
        torch.einsum("ebi,ebj->eij", JtL, Js),
        torch.einsum("ebi,ebj->eij", JtL, Jt),
    ])
    cells = torch.cat([s * F + s, s * F + t, t * F + s, t * F + t])
    H = _scatter_add(blocks, cells, F * F).reshape(F, F, 6, 6)
    b = _scatter_add(torch.cat([torch.einsum("ebi,eb->ei", JsL, r),
                                torch.einsum("ebi,eb->ei", JtL, r)]), torch.cat([s, t]), F)
    return H, b, _cost(r, Lam)


def _solve(H, b, lam, anchor: int):
    """(H + lam diag(H)) dx = -b with the reference node pinned."""
    F = H.shape[0]
    Hd = H.permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    bd = b.reshape(6 * F)
    diag = torch.diagonal(Hd)
    Hd = Hd + torch.diag(lam * diag + 1e-9)
    # pin the anchor block: a huge diagonal forces dx_anchor ~ 0
    a = anchor * 6 + torch.arange(6, device=H.device)
    Hd = Hd.index_put((a, a), Hd[a, a] + 1e12)
    # a system singular in float32 (a rank-deficient block once the damping
    # rounds away) gives NaN, as the reference's solve does: the step then
    # counts as not improved and the damping grows, where a raise would end
    # the optimisation
    dx, info = torch.linalg.solve_ex(Hd, -bd)
    return torch.where(info == 0, dx, float("nan")).reshape(F, 6)


def _solve_distributed(graph: PoseGraph, weights, lam, anchor: int, mesh, axis):
    """The dense solve's edge-sharded matrix-free replacement
    (parallel/solver.py): block-Jacobi PCG, one all_reduce over the
    `axis` of `mesh` a Hessian apply; without a mesh, the same CG on one
    device."""
    F = graph.poses.shape[0]
    s, t = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    T_s = graph.poses[s]
    T_t = graph.poses[t]
    r = _edge_residual(T_s, T_t, graph.transformations)
    J = _edge_jac(T_s, T_t, graph.transformations)
    Lam = graph.informations * weights[:, None, None]
    sys = dsolver.EdgeSystem(J[:, :, :6], J[:, :, 6:], Lam, r, graph.edges[:, 0],
                             graph.edges[:, 1])
    return dsolver.solve_pose_graph_cg(sys, F, lam, anchor, mesh=mesh, axis=axis)


def global_optimization(
    graph: PoseGraph,
    option: GlobalOptimizationOption = GlobalOptimizationOption(),
    criteria: GlobalOptimizationConvergenceCriteria = GlobalOptimizationConvergenceCriteria(),
    mesh=None,
    mesh_axis: str = "edges",
) -> PoseGraph:
    """Robust LM pose-graph optimisation with line-process edge weights,
    then pruning of loop closures whose confidence falls below
    `option.edge_prune_threshold`.

    With `mesh` (a DeviceMesh; every rank passes the whole graph), the
    inner solve is the edge-sharded matrix-free PCG over its `mesh_axis`
    (`_solve_distributed`) in place of the dense 6F x 6F solve; the result
    is equal on every rank."""
    if mesh is not None:
        multihost._check_mesh(mesh, mesh_axis, graph.poses.device)
    # mu = preference * dmax^2 * mean(info[5, 5]) over the live edges
    valid = graph.edge_valid
    n_edges = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
    avg_corr = torch.sum(torch.where(valid, graph.informations[:, 5, 5], 0.0)) / n_edges
    mu = (option.preference_loop_closure * option.max_correspondence_distance**2) * avg_corr
    anchor = option.reference_node

    def weights(conf):
        return torch.where(valid, torch.where(graph.uncertain, conf, 1.0), 0.0)

    poses = graph.poses
    conf = graph.confidence
    lam = torch.tensor(1e-4, dtype=torch.float32, device=poses.device)
    for _ in range(criteria.max_iteration):
        g = dataclasses.replace(graph, poses=poses)
        w = weights(conf)
        H, b, cost = _build_system(g, w)
        if mesh is not None:
            dx = _solve_distributed(g, w, lam, anchor, mesh, mesh_axis)
        else:
            dx = _solve(H, b, lam, anchor)
        new_poses = lie.se3_exp(dx) @ poses
        new_cost = _cost(_residuals(dataclasses.replace(graph, poses=new_poses)),
                         graph.informations * w[:, None, None])
        improved = new_cost < cost
        poses = torch.where(improved, new_poses, poses)
        lam = torch.where(improved, torch.clamp(lam / 3.0, min=1e-7), torch.clamp(lam * 3.0, max=1e4))
        # closed-form line-process update after the step; weights start at 1
        r = _residuals(dataclasses.replace(graph, poses=poses))
        conf = torch.where(
            improved,
            _line_process_weights(r, graph.informations, graph.uncertain, valid, mu),
            conf,
        )
        rel = torch.abs(cost - new_cost) / torch.clamp(cost, min=1e-12)
        # the host reads the stop flag: the loop's one sync per iteration
        if bool(improved & (rel < criteria.min_relative_increment)):
            break

    keep = valid & (~graph.uncertain | (conf > option.edge_prune_threshold))
    return dataclasses.replace(graph, poses=poses, confidence=conf, edge_valid=keep)


def global_optimization_two_pass(
    graph: PoseGraph,
    option: GlobalOptimizationOption = GlobalOptimizationOption(),
    criteria: GlobalOptimizationConvergenceCriteria = GlobalOptimizationConvergenceCriteria(),
    mesh=None,
    mesh_axis: str = "edges",
) -> PoseGraph:
    """Optimise, prune the invalid loop closures, optimise again."""
    g1 = global_optimization(graph, option, criteria, mesh=mesh, mesh_axis=mesh_axis)
    return global_optimization(g1, option, criteria, mesh=mesh, mesh_axis=mesh_axis)


# ---------------------------------------------------------------------------
# JSON IO (the schema of Open3D's io/PoseGraphIO.cpp)
# ---------------------------------------------------------------------------


def to_json_dict(graph: PoseGraph) -> dict:
    """Open3D pose-graph JSON: class_name PoseGraph, nodes [{pose}], edges
    [{source_node_id, target_node_id, transformation, information,
    uncertain, confidence}], matrices flattened column-major. Pruned edges
    are left out."""
    ev = graph.edge_valid.cpu().numpy()
    edges = graph.edges.cpu().numpy()
    trans = graph.transformations.cpu().numpy()
    infos = graph.informations.cpu().numpy()
    unc = graph.uncertain.cpu().numpy()
    conf = graph.confidence.cpu().numpy()
    nodes = [
        {"class_name": "PoseGraphNode", "pose": np.asarray(p, np.float64).flatten(order="F").tolist()}
        for p in graph.poses.cpu().numpy()
    ]
    out_edges = []
    for e in range(edges.shape[0]):
        if not ev[e]:
            continue
        out_edges.append({
            "class_name": "PoseGraphEdge",
            "source_node_id": int(edges[e, 0]),
            "target_node_id": int(edges[e, 1]),
            "transformation": np.asarray(trans[e], np.float64).flatten(order="F").tolist(),
            "information": np.asarray(infos[e], np.float64).flatten(order="F").tolist(),
            "uncertain": bool(unc[e]),
            "confidence": float(conf[e]),
        })
    return {"class_name": "PoseGraph", "version_major": 1, "version_minor": 0,
            "nodes": nodes, "edges": out_edges}


def from_json_dict(d: dict, device=None) -> PoseGraph:
    dev = default_device(device)
    poses = np.stack([np.asarray(n["pose"], np.float32).reshape(4, 4, order="F") for n in d["nodes"]])
    E = max(len(d["edges"]), 1)
    edges = np.zeros((E, 2), np.int32)
    trans = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    infos = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    unc = np.zeros((E,), bool)
    valid = np.zeros((E,), bool)
    conf = np.ones((E,), np.float32)
    for i, e in enumerate(d["edges"]):
        edges[i] = (e["source_node_id"], e["target_node_id"])
        trans[i] = np.asarray(e["transformation"], np.float32).reshape(4, 4, order="F")
        infos[i] = np.asarray(e["information"], np.float32).reshape(6, 6, order="F")
        unc[i] = bool(e.get("uncertain", False))
        conf[i] = float(e.get("confidence", 1.0))
        valid[i] = True
    return PoseGraph(
        poses=torch.from_numpy(poses).to(dev),
        edges=torch.from_numpy(edges).to(dev),
        transformations=torch.from_numpy(trans).to(dev),
        informations=torch.from_numpy(infos).to(dev),
        uncertain=torch.from_numpy(unc).to(dev),
        confidence=torch.from_numpy(conf).to(dev),
        edge_valid=torch.from_numpy(valid).to(dev),
    )


def write_pose_graph(path: str, graph: PoseGraph) -> None:
    with open(path, "w") as f:
        json.dump(to_json_dict(graph), f, indent=1)


def read_pose_graph(path: str, device=None) -> PoseGraph:
    with open(path) as f:
        return from_json_dict(json.load(f), device=device)
