"""Distributed multiway fragment alignment (port of
open3d_tpu/parallel/fragments.py) over a 2-D DeviceMesh ("edges", "points").

Pose-graph edges (fragment pairs) are data-parallel over "edges"; each
edge's source points are split over "points". One joint Gauss-Newton step
over all fragment poses: per edge, the point-to-plane residual
    r = n_t . (T_s p_s - T_t q_t)
with Jacobians [+(T_s p) x n, n] for xi_s and -[(T_t q) x n, n] for xi_t
(left-multiplied se(3) perturbations) accumulated into 6x6 blocks; the
partial blocks are all-reduced over "points", every edge's blocks
all-gathered over "edges", and the dense (6F, 6F) system is solved on
every rank (F is the fragment count). Edge and point counts need not
divide the mesh: edges are padded with invalid rows and points with
masked-out ones, which add zero to every sum.

No module here holds a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3d_tpu_torch.core import lie, nns
from open3d_tpu_torch.core.masking import _scatter_add
from open3d_tpu_torch.core.platform import default_device
from open3d_tpu_torch.parallel import multihost
from open3d_tpu_torch.parallel.multihost import _all_gather, _axis_size, _psum


def make_mesh(n_devices: Optional[int] = None, devices=None, device=None):
    """2-D ("edges", "points") mesh over `n_devices` of the group's ranks
    (`devices`, default: all), on `device` (default: the card): two along
    "points" when the count is even, else one."""
    dev = default_device(device)
    ranks = multihost._mesh_ranks(n_devices, devices, dev)
    pts = 2 if len(ranks) % 2 == 0 else 1
    return multihost.make_mesh(("edges", "points"), (len(ranks) // pts, pts), devices=ranks,
                               device=dev)


def _edge_system(src_pos, src_nrm_unused, src_valid, tgt_pos, tgt_nrm, tgt_mask, T_s, T_t, dmax):
    """Point-to-plane JtJ/Jtr blocks for one edge over a chunk of source
    points. Returns (H_ss, H_st, H_tt, b_s, b_t, n_inlier, sq_err)."""
    p = lie.transform_points(T_s, src_pos)
    q_all = lie.transform_points(T_t, tgt_pos)
    idx, d2 = nns.one_nn_search(p, q_all, target_mask=tgt_mask)
    valid = src_valid & (idx >= 0) & (d2 <= dmax * dmax)
    idx = torch.clamp(idx, min=0).long()
    q = q_all[idx]
    n = lie.rotate_vectors(T_t, tgt_nrm[idx])

    r = torch.sum((p - q) * n, dim=-1)
    w = valid.to(torch.float32)
    J_s = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)  # (N, 6)
    J_t = -torch.cat([torch.linalg.cross(q, n, dim=-1), n], dim=-1)
    Jw_s = J_s * w[:, None]
    Jw_t = J_t * w[:, None]
    return (Jw_s.T @ J_s, Jw_s.T @ J_t, Jw_t.T @ J_t, Jw_s.T @ r, Jw_t.T @ r,
            torch.sum(w), torch.sum(w * r * r))


def _assemble_and_solve(H_blocks, b_blocks, counts, sq_errs, edges, n_frags, damping, anchor_first):
    """Scatter per-edge 6x6 blocks into the dense (6F, 6F) system and solve
    (on every rank; F is the fragment count)."""
    dev = counts.device
    F6 = 6 * n_frags
    H_ss, H_st, H_tt = H_blocks
    b_s, b_t = b_blocks
    s_idx, t_idx = edges[:, 0].long(), edges[:, 1].long()
    ar = torch.arange(6, device=dev)

    def cells(rows_frag, cols_frag):
        return ((rows_frag * 6)[:, None, None] + ar[None, :, None]) * F6 + (
            (cols_frag * 6)[:, None, None] + ar[None, None, :])

    # every block into its cells with one deterministic scatter-add, so
    # each rank and each repeat sums them in one order
    H = _scatter_add(
        torch.cat([H_ss, H_st, H_st.transpose(-1, -2), H_tt]).reshape(-1),
        torch.cat([cells(s_idx, s_idx), cells(s_idx, t_idx), cells(t_idx, s_idx),
                   cells(t_idx, t_idx)]).reshape(-1), F6 * F6).reshape(F6, F6)
    b = _scatter_add(torch.cat([b_s, b_t]).reshape(-1),
                     torch.cat([s_idx[:, None] * 6 + ar, t_idx[:, None] * 6 + ar]).reshape(-1), F6)
    if anchor_first:  # gauge-fix fragment 0 (reference_node convention)
        H[ar, ar] += 1e12
    H = H + damping * torch.eye(F6, dtype=torch.float32, device=dev)
    xi = torch.linalg.solve(H, -b)  # small dense: F fragments -> 6F x 6F
    return xi.reshape(n_frags, 6), torch.sum(counts), torch.sum(sq_errs)


def _edges_blocks(frag_pos, frag_mask, frag_nrm, poses, edges, edge_valid, dmax, lo=0, hi=None):
    """Every edge's blocks over source rows [lo, hi), stacked: the seven
    outputs of _edge_system, each with a leading edge axis."""
    outs = []
    for e in range(edges.shape[0]):
        s, t = int(edges[e, 0]), int(edges[e, 1])
        outs.append(_edge_system(
            frag_pos[s, lo:hi], None, frag_mask[s, lo:hi] & edge_valid[e],
            frag_pos[t], frag_nrm[t], frag_mask[t], poses[s], poses[t], dmax,
        ))
    return [torch.stack(x) for x in zip(*outs)]


def multiway_gn_step(
    frag_pos: torch.Tensor,  # (F, N, 3)
    frag_nrm: torch.Tensor,  # (F, N, 3)
    frag_mask: torch.Tensor,  # (F, N) bool
    poses: torch.Tensor,  # (F, 4, 4) fragment -> world
    edges: torch.Tensor,  # (E, 2) int32 (src_frag, tgt_frag)
    edge_valid: torch.Tensor,  # (E,) bool
    max_correspondence_distance: float,
    mesh=None,
    damping: float = 1e-4,
    anchor_first: bool = True,
):
    """One joint Gauss-Newton step over all fragment poses. Returns
    (new_poses (F, 4, 4), rmse, n_inliers), equal on every rank.

    With `mesh` (axes "edges" and "points"; every rank passes the whole
    input): the edges are padded with invalid rows to a multiple of the
    "edges" size and each rank takes its contiguous slice; the source
    points are padded with masked-out rows to a multiple of the "points"
    size and each rank takes its chunk of every source; the partial blocks
    are all-reduced over "points" and all-gathered over "edges", and the
    solve and the pose update run on every rank."""
    F = frag_pos.shape[0]
    dmax = max_correspondence_distance
    if mesh is None:
        outs = _edges_blocks(frag_pos, frag_mask, frag_nrm, poses, edges, edge_valid, dmax)
        edges_all = edges
    else:
        ne, npts = _axis_size(mesh, "edges"), _axis_size(mesh, "points")
        pad = (-edges.shape[0]) % ne
        if pad:
            edges = torch.cat([edges, torch.zeros((pad, 2), dtype=edges.dtype,
                                                  device=edges.device)])
            edge_valid = torch.cat([edge_valid, torch.zeros(pad, dtype=torch.bool,
                                                            device=edge_valid.device)])
        pad = (-frag_pos.shape[1]) % npts
        if pad:
            frag_pos = torch.cat([frag_pos, frag_pos.new_zeros((F, pad, 3))], dim=1)
            frag_nrm = torch.cat([frag_nrm, frag_nrm.new_zeros((F, pad, 3))], dim=1)
            frag_mask = torch.cat([frag_mask, frag_mask.new_zeros((F, pad))], dim=1)
        chunk = frag_pos.shape[1] // npts
        lo = mesh.get_local_rank("points") * chunk
        el = multihost._shard(edges, mesh, "edges")
        outs = _edges_blocks(frag_pos, frag_mask, frag_nrm, poses, el,
                             multihost._shard(edge_valid, mesh, "edges"), dmax, lo, lo + chunk)
        # combine the point chunks' partial systems per edge, then gather
        # every edge's blocks for the replicated solve
        outs = [_all_gather(x, mesh, "edges") for x in _psum(outs, mesh, "points")]
        edges_all = _all_gather(el, mesh, "edges")
    H_ss, H_st, H_tt, b_s, b_t, cnt, sq = outs
    xi, n_in, sq_sum = _assemble_and_solve(
        (H_ss, H_st, H_tt), (b_s, b_t), cnt, sq, edges_all, F, damping, anchor_first
    )
    new_poses = lie.se3_exp(xi) @ poses
    rmse = torch.sqrt(sq_sum / torch.clamp(n_in, min=1.0))
    return new_poses, rmse, n_in


def multiway_align(
    frag_pos, frag_nrm, frag_mask, poses, edges, edge_valid,
    max_correspondence_distance: float,
    n_iterations: int = 10,
    mesh=None,
    **kw,
):
    """`n_iterations` joint Gauss-Newton steps."""
    rmse = torch.zeros((), dtype=torch.float32, device=poses.device)
    n_in = torch.zeros((), dtype=torch.float32, device=poses.device)
    for _ in range(n_iterations):
        poses, rmse, n_in = multiway_gn_step(
            frag_pos, frag_nrm, frag_mask, poses, edges, edge_valid,
            max_correspondence_distance, mesh=mesh, **kw,
        )
    return poses, rmse, n_in
