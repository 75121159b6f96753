"""SLAC: simultaneous localisation and calibration, non-rigid multiway
alignment of fragments over a deformable control grid (port of
open3d_tpu/pipelines/slac.py).

- The control grid is a core.hashmap table of cell keys and a dense
  (C + 1, 3) position buffer whose row is the key's slot; row C is the
  miss row. parameterize is one 8-corner lookup with trilinear ratios,
  deform_points one gather and weighted sum.
- The optimiser alternates, as the JAX package's does: a rigid
  Gauss-Newton pass over the fragment poses, then non-rigid steps on the
  grid positions with the poses held, each solved by Jacobi-preconditioned
  CG on the normal equations. Both residuals are linear in the positions
  once the cell rotations R_a are re-estimated for the step:
    data  r = sqrt(w) n . (T_i sum_c a_c x_c - T_j sum_c b_c x'_c)
    rigid r = sqrt(w_reg) ((x_b - x_a) - R_a (init_b - init_a)),
  so J v is gathers and J^T u one deterministic scatter-add (the same sort
  order reused by every product of a step), in closed form where the JAX
  package linearises with jax.linearize and jax.vjp.
- The diagonal preconditioner is Hutchinson's estimate with eight
  Rademacher probes. The JAX package draws them from jax.random; the port
  cannot draw those bits and draws them from a host torch.Generator seeded
  0 (`_rademacher_probes`), so the card and a CPU copy use the same probes.
- The CG runs a fixed `n_cg` steps with no host read.

No module here holds a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core import lie, nns
from open3d_tpu_torch.core.masking import _div, _scatter_apply, _scatter_plan, compact_indices
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.pipelines import pose_graph as pg_mod

GRID_SIZE_DEFAULT = 0.375  # fixed in the reference (SLACOptimizer.h:29)


@dataclasses.dataclass(frozen=True)
class ControlGrid:
    """positions row C (capacity) is the miss row."""

    table: torch.Tensor  # (C, 2) packed cell keys
    positions: torch.Tensor  # (C + 1, 3) f32 current (deformed) positions
    grid_size: float

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    def init_positions(self) -> torch.Tensor:
        """Original (undeformed) cell positions from the keys (C, 3)."""
        return hm.unpack_coords(self.table).to(torch.float32) * self.grid_size

    def size(self) -> torch.Tensor:
        return hm.occupied_mask(self.table).to(torch.int32).sum()


def create_control_grid(grid_size: float = GRID_SIZE_DEFAULT, capacity: int = 4096,
                        device=None) -> ControlGrid:
    """An empty grid on the card unless `device` names another."""
    dev = default_device(device)
    return ControlGrid(table=hm.make_table(capacity, device=dev),
                       positions=torch.zeros((capacity + 1, 3), dtype=torch.float32, device=dev),
                       grid_size=float(grid_size))


def _corners(dev) -> torch.Tensor:
    return torch.tensor([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                        dtype=torch.int32, device=dev)


def _nb6(dev) -> torch.Tensor:
    return torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                        dtype=torch.int32, device=dev)


def touch(cg: ControlGrid, points: torch.Tensor, mask=None) -> ControlGrid:
    """Activate the 8 cells around every point; only newly activated cells
    take their undeformed positions, so re-touching keeps a deformation."""
    g0 = torch.floor(_div(points, cg.grid_size)).to(torch.int32)
    cells = (g0[:, None, :] + _corners(points.device)[None]).reshape(-1, 3)
    keys = hm.pack_coords(cells)
    if mask is not None:
        keys = torch.where(mask.repeat_interleave(8)[:, None], keys, 0)
    keys, _ = hm.unique_keys(keys, min(cg.capacity, keys.shape[0]))
    _, was_there = hm.find(cg.table, keys)
    table, slot, ok = hm.activate(cg.table, keys)
    pos = hm.unpack_coords(keys).to(torch.float32) * cg.grid_size
    rows = torch.where(ok & ~was_there, slot, cg.capacity).long()
    positions = cg.positions.clone()
    positions[rows] = pos
    positions[cg.capacity] = 0.0
    return dataclasses.replace(cg, table=table, positions=positions)


class Parameterized(NamedTuple):
    rows: torch.Tensor  # (N, 8) int32 control-point buffer rows (C = miss)
    ratios: torch.Tensor  # (N, 8) f32 trilinear weights
    valid: torch.Tensor  # (N,) bool: all 8 corners found


def parameterize(cg: ControlGrid, points: torch.Tensor) -> Parameterized:
    g = _div(points, cg.grid_size)
    g0 = torch.floor(g).to(torch.int32)
    f = g - g0.to(torch.float32)
    corners = _corners(points.device)
    cells = g0[:, None, :] + corners[None]  # (N, 8, 3)
    slot, found = hm.find(cg.table, hm.pack_coords(cells.reshape(-1, 3)))
    n = points.shape[0]
    rows = torch.where(found, slot, cg.capacity).reshape(n, 8)
    w = torch.where(corners[None] == 1, f[:, None, :], 1.0 - f[:, None, :]).prod(-1)
    return Parameterized(rows=rows, ratios=w, valid=found.reshape(n, 8).all(-1))


def deform_points(cg: ControlGrid, param: Parameterized) -> torch.Tensor:
    corners = cg.positions[param.rows.long()]  # (N, 8, 3)
    return (corners * param.ratios[..., None]).sum(1)


def neighbor_grid_map(cg: ControlGrid, capacity: Optional[int] = None):
    """6-neighbour map over the active cells. Returns (rows (A,), nb_rows
    (A, 6), nb_mask (A, 6), count)."""
    A = capacity or cg.capacity
    C = cg.capacity
    slots, count = hm.active_slots(cg.table, A)
    live = torch.arange(A, device=slots.device) < count
    coords = hm.unpack_coords(cg.table[torch.clamp(slots, min=0).long()])
    nb = coords[:, None, :] + _nb6(slots.device)[None]
    nb_slot, nb_found = hm.find(cg.table, hm.pack_coords(nb.reshape(-1, 3)))
    nb_rows = torch.where(nb_found, nb_slot, C).reshape(A, 6)
    nb_mask = nb_found.reshape(A, 6) & live[:, None]
    return torch.where(live, slots, C), nb_rows, nb_mask, count


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLACOptimizerParams:
    """Open3D's SLACOptimizerParams knobs and defaults, plus the grid's
    size and capacities."""

    max_iterations: int = 5
    voxel_size: float = 0.05
    distance_threshold: float = 0.07
    fitness_threshold: float = 0.3
    regularizer_weight: float = 1.0
    grid_size: float = GRID_SIZE_DEFAULT
    grid_capacity: int = 4096
    corres_capacity: int = 4096
    # rigid pose passes before the non-rigid loop (0: the poses are already
    # optimised, e.g. by the global pose-graph optimisation)
    rigid_iterations: int = 1


class _EdgeCorres(NamedTuple):
    src_frag: int
    tgt_frag: int
    src_idx: torch.Tensor  # (K,) into source fragment points
    tgt_idx: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,) bool


def _find_correspondences(fragments, graph: pg_mod.PoseGraph, params) -> List[_EdgeCorres]:
    """For each valid edge: the nearest neighbours of the source fragment's
    points in the target's, both in the current world frame, within
    `distance_threshold`, stably compacted into `corres_capacity` rows."""
    out = []
    edges = graph.edges.cpu().tolist()
    ev = graph.edge_valid.cpu().tolist()
    K = params.corres_capacity
    for e, (i, j) in enumerate(edges):
        if not ev[e]:
            continue
        ps = lie.transform_points(graph.poses[i], fragments[i].positions)
        pt = lie.transform_points(graph.poses[j], fragments[j].positions)
        idx, _, _ = nns.hybrid_search(ps, pt, params.distance_threshold, 1)
        idx = idx[:, 0]
        sidx, c = compact_indices((idx >= 0) & fragments[i].mask, K)
        live = torch.arange(K, device=idx.device) < c
        sidx = torch.clamp(sidx, min=0).long()
        out.append(_EdgeCorres(src_frag=i, tgt_frag=j, src_idx=torch.where(live, sidx, 0),
                               tgt_idx=torch.where(live, idx[sidx].long(), 0), valid=live))
    return out


def run_rigid_optimizer_for_fragments(
    fragments: List[PointCloud],
    graph: pg_mod.PoseGraph,
    params: SLACOptimizerParams = SLACOptimizerParams(),
) -> pg_mod.PoseGraph:
    """Joint multiway dense point-to-plane refinement of the fragment poses
    (Open3D's RunRigidOptimizerForFragments): `max_iterations` Gauss-Newton
    steps over every valid edge's correspondences."""
    F = graph.poses.shape[0]
    poses = graph.poses
    dev = poses.device
    for _ in range(params.max_iterations):
        corres = _find_correspondences(fragments, dataclasses.replace(graph, poses=poses), params)
        H = torch.zeros((F, F, 6, 6), dtype=torch.float32, device=dev)
        b = torch.zeros((F, 6), dtype=torch.float32, device=dev)
        for ec in corres:
            i, j = ec.src_frag, ec.tgt_frag
            p = lie.transform_points(poses[i], fragments[i].positions[ec.src_idx])
            q = lie.transform_points(poses[j], fragments[j].positions[ec.tgt_idx])
            nrm = fragments[j].attrs["normals"][ec.tgt_idx] @ poses[j][:3, :3].T
            r = ((p - q) * nrm).sum(-1)
            w = ec.valid.to(torch.float32)
            Ji = torch.cat([torch.linalg.cross(p, nrm, dim=-1), nrm], dim=-1)  # (K, 6)
            Jw = Ji * w[:, None]
            JtJ = Jw.T @ Ji
            H[i, i] += JtJ
            H[i, j] -= JtJ
            H[j, i] -= JtJ
            H[j, j] += JtJ
            Jtr = Jw.T @ r
            b[i] += Jtr
            b[j] -= Jtr
        dx = pg_mod._solve(H, b, 1e-6, 0)
        poses = lie.se3_exp(dx) @ poses
    return dataclasses.replace(graph, poses=poses)


def _estimate_cell_rotations(cg: ControlGrid, rows, nb_rows, nb_mask):
    """Each cell's Procrustes rotation R_a taking its undeformed neighbour
    offsets to the current ones (the rigidity term's rotation)."""
    C = cg.capacity
    init = torch.cat([cg.init_positions(), cg.positions.new_zeros((1, 3))])
    curr = cg.positions
    a = torch.clamp(rows, max=C).long()
    nb = nb_rows.long()
    m = nb_mask[..., None].to(torch.float32)
    d_init = (init[nb] - init[a][:, None, :]) * m  # (A, 6, 3)
    d_curr = (curr[nb] - curr[a][:, None, :]) * m
    M = torch.einsum("aki,akj->aij", d_curr, d_init)
    U, _, Vt = torch.linalg.svd(M + 1e-8 * torch.eye(3, device=M.device))
    det = torch.linalg.det(U @ Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return U @ (S[:, :, None] * Vt)  # (A, 3, 3)


def _rademacher_probes(shape, n: int, device) -> torch.Tensor:
    """(n, *shape) float32 signs +-1 from a host generator seeded 0, moved
    to `device`."""
    g = torch.Generator().manual_seed(0)
    z = torch.randint(0, 2, (n,) + tuple(shape), generator=g).to(torch.float32)
    return (2.0 * z - 1.0).to(device)


class _NormalEquations(NamedTuple):
    """The step's linear residual r(x) = J x + r_const in closed form: the
    data rows' corner rows, trilinear ratios and signed rotated normals
    (the source halves of every edge's correspondences first, then the
    target halves), the rigidity rows' cells and neighbours, and the
    scatter plan of J^T's rows."""

    rows: torch.Tensor  # (2K, 8) int64
    ratios: torch.Tensor  # (2K, 8)
    nrm: torch.Tensor  # (2K, 3): +-sqrt(w) R^T n
    a: torch.Tensor  # (A,) int64
    nb: torch.Tensor  # (A, 6) int64
    reg_w: torch.Tensor  # (A, 6, 1): sqrt(w_reg) on live neighbours
    plan: tuple


def _normal_equations(cg: ControlGrid, terms, rows_a, nb_rows, nb_mask, w_reg) -> _NormalEquations:
    C = cg.capacity
    rows, ratios, nrm, live = [], [], [], []
    for side in (0, 1):
        for pp, pq, n_w, w, Ti, Tj in terms:
            par, T, sign = (pp, Ti, 1.0) if side == 0 else (pq, Tj, -1.0)
            rows.append(par.rows.long())
            ratios.append(par.ratios)
            nrm.append(sign * torch.sqrt(w)[:, None] * (n_w @ T[:3, :3]))
            live.append(w > 0)
    dev = cg.positions.device
    if rows:
        rows, ratios, nrm, live = (torch.cat(rows), torch.cat(ratios), torch.cat(nrm),
                                   torch.cat(live))
    else:
        rows = torch.zeros((0, 8), dtype=torch.int64, device=dev)
        ratios = torch.zeros((0, 8), device=dev)
        nrm = torch.zeros((0, 3), device=dev)
        live = torch.zeros(0, dtype=torch.bool, device=dev)
    a = torch.clamp(rows_a, max=C).long()
    nb = nb_rows.long()
    sw = torch.sqrt(torch.tensor(w_reg, dtype=torch.float32, device=dev))
    reg_w = (nb_mask.to(torch.float32) * sw)[..., None]
    A = a.shape[0]
    # rows of zero weight add exact zeros: J^T drops them (the capacity's
    # dead cells and unmatched correspondences would pile onto one row)
    idx = torch.cat([torch.where(live[:, None], rows, -1).reshape(-1),
                     torch.where(nb_mask, nb, -1).reshape(-1),
                     torch.where(nb_mask, a[:, None], -1).reshape(-1)])
    return _NormalEquations(rows, ratios, nrm, a, nb, reg_w, _scatter_plan(idx, C + 1))


def _jv(ne: _NormalEquations, v: torch.Tensor):
    """J v: (K,) data rows and (A, 6, 3) rigidity rows."""
    s = ((v[ne.rows] * ne.ratios[..., None]).sum(1) * ne.nrm).sum(-1)
    K = s.shape[0] // 2
    return s[:K] + s[K:], ne.reg_w * (v[ne.nb] - v[ne.a][:, None, :])


def _jtu(ne: _NormalEquations, u_data: torch.Tensor, u_reg: torch.Tensor) -> torch.Tensor:
    """J^T u as one deterministic scatter-add into the (C + 1, 3) rows."""
    g = torch.cat([u_data, u_data])[:, None] * ne.nrm  # (2K, 3)
    ur = ne.reg_w * u_reg  # (A, 6, 3)
    vals = torch.cat([(ne.ratios[..., None] * g[:, None, :]).reshape(-1, 3),
                      ur.reshape(-1, 3), -ur.reshape(-1, 3)])
    return _scatter_apply(vals, ne.plan)


def run_slac_optimizer_for_fragments(
    fragments: List[PointCloud],
    graph: pg_mod.PoseGraph,
    params: SLACOptimizerParams = SLACOptimizerParams(),
    n_cg: int = 48,
) -> Tuple[pg_mod.PoseGraph, ControlGrid]:
    """Alternating SLAC (Open3D's RunSLACOptimizerForFragments): rigid pose
    refinement up front, then `max_iterations` non-rigid grid steps with the
    rigidity regulariser. The fragment clouds are FRAGMENT-LOCAL: the grid
    lives in the shared camera space, modelling a calibration distortion
    applied before each fragment's pose, so the data residual is
    r = n . (T_i D(p_local) - T_j D(q_local))."""
    C = params.grid_capacity
    dev = graph.poses.device
    cg = create_control_grid(params.grid_size, C, device=dev)
    for pc in fragments:
        cg = touch(cg, pc.positions, pc.mask)

    # the rigid pass only before the non-rigid loop: on distorted fragments
    # a repeated rigid step trades calibration error for pose error
    if params.rigid_iterations > 0:
        graph = run_rigid_optimizer_for_fragments(
            fragments, graph, dataclasses.replace(params, max_iterations=params.rigid_iterations))

    for _ in range(params.max_iterations):
        corres = _find_correspondences(fragments, graph, params)
        rows_a, nb_rows, nb_mask, _ = neighbor_grid_map(cg)
        R = _estimate_cell_rotations(cg, rows_a, nb_rows, nb_mask)
        init_all = torch.cat([cg.init_positions(), cg.positions.new_zeros((1, 3))])

        terms = []
        for ec in corres:
            i, j = ec.src_frag, ec.tgt_frag
            pp = parameterize(cg, fragments[i].positions[ec.src_idx])
            pq = parameterize(cg, fragments[j].positions[ec.tgt_idx])
            n_w = fragments[j].attrs["normals"][ec.tgt_idx] @ graph.poses[j][:3, :3].T
            w = (ec.valid & pp.valid & pq.valid).to(torch.float32)
            terms.append((pp, pq, n_w, w, graph.poses[i], graph.poses[j]))
        ne = _normal_equations(cg, terms, rows_a, nb_rows, nb_mask, params.regularizer_weight)

        # the residual at the current positions
        x0 = cg.positions
        r_data = torch.cat([
            torch.sqrt(w) * ((lie.transform_points(Ti, deform_points(cg, pp))
                              - lie.transform_points(Tj, deform_points(cg, pq))) * n_w).sum(-1)
            for pp, pq, n_w, w, Ti, Tj in terms]) if terms else x0.new_zeros((0,))
        a = ne.a
        d_init = init_all[ne.nb] - init_all[a][:, None, :]
        target = torch.einsum("aij,akj->aki", R, d_init)
        r_reg = ne.reg_w * ((x0[ne.nb] - x0[a][:, None, :]) - target)
        g = _jtu(ne, r_data, r_reg)

        def hv(v):
            return _jtu(ne, *_jv(ne, v))

        # Jacobi preconditioner: diag(J^T J) ~ E[z * (H z)] over Rademacher z
        probes = _rademacher_probes(x0.shape, 8, dev)
        diag_est = torch.zeros_like(x0)
        for z in probes:
            diag_est = diag_est + z * hv(z)
        M_inv = 1.0 / torch.clamp(diag_est / 8, min=1e-4)

        x = torch.zeros_like(x0)
        r = -g
        z = M_inv * r
        p = z
        rz = (r * z).sum()
        for _ in range(n_cg):
            Ap = hv(p) + 1e-6 * p
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M_inv * r
            rz2 = (r * z).sum()
            p = z + (rz2 / torch.clamp(rz, min=1e-30)) * p
            rz = rz2
        new_pos = x0 + x
        new_pos[C] = 0.0
        cg = dataclasses.replace(cg, positions=new_pos)

    return graph, cg


def deform_fragment(cg: ControlGrid, graph: pg_mod.PoseGraph, frag_id: int,
                    pc: PointCloud) -> PointCloud:
    """Fragment-local cloud -> calibration-deformed, world-frame cloud:
    deformed in the shared camera space, then moved by the fragment pose."""
    param = parameterize(cg, pc.positions)
    warped = torch.where(param.valid[:, None], deform_points(cg, param), pc.positions)
    return dataclasses.replace(pc, positions=lie.transform_points(graph.poses[frag_id], warped))
