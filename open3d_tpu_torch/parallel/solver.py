"""Distributed second-order solvers (port of open3d_tpu/parallel/solver.py):
the edge-sharded pose-graph PCG and the observation-sharded Schur-complement
bundle adjustment.

Reference math: GlobalOptimization.cpp:190-230 (per edge, H += J^T Lambda J
in 6x6 blocks, b += J^T Lambda e). The Hessian is never formed as
6F x 6F: every Hessian-vector product is a per-rank scatter-add of 6x6
block contributions over the rank's edges (or observations), then one
`dist.all_reduce` over the mesh axis.

The JAX package runs the whole CG loop (and the whole Gauss-Newton scan)
inside one shard_map, so the shards stay put and each product costs one
psum. Here every rank receives the whole input, pads it as the JAX package
pads it and keeps its own contiguous shard; the loops then run in the
rank's one call with one all_reduce a product. The CG's while_loop is a
loop of at most `n_iter` steps whose state stops changing once the
residual is under the threshold (torch.where), as the while_loop's does;
the host reads the stop flag every `_READ_EVERY` steps only. Without a
mesh the all_reduce is the identity and the same code runs on one device.

No module here holds a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.core.masking import _scatter_add
from open3d_tpu_torch.parallel.multihost import _psum, _shard, _axis_size

_READ_EVERY = 8  # CG steps between two host reads of the stop flag


def _reducer(mesh, axis):
    """psum over `axis` of a tuple of tensors, or the identity without a mesh."""
    if mesh is None:
        return lambda *xs: list(xs)
    return lambda *xs: _psum(xs, mesh, axis)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)])


# ---------------------------------------------------------------------------
# Sharded pose-graph PCG
# ---------------------------------------------------------------------------


class EdgeSystem(NamedTuple):
    """Per-edge linearized system, shardable along the leading (edge) axis."""

    Js: torch.Tensor  # (E, 6, 6) d r / d xi_source
    Jt: torch.Tensor  # (E, 6, 6) d r / d xi_target
    Lam: torch.Tensor  # (E, 6, 6) weighted information (0 for invalid edges)
    r: torch.Tensor  # (E, 6) residuals
    s: torch.Tensor  # (E,) int32 source node
    t: torch.Tensor  # (E,) int32 target node


def _pad_edges(sys: EdgeSystem, multiple: int) -> EdgeSystem:
    pad = (-sys.r.shape[0]) % multiple
    if pad == 0:
        return sys
    return EdgeSystem(*(_pad_rows(a, pad) for a in sys))


def _scatter(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    # deterministic: the sharded and the local solve sum in one order
    return _scatter_add(vals.to(torch.float32), idx, n)


def _local_gradient(sys: EdgeSystem, F: int):
    """Per-shard b = sum_e J^T Lam r scattered to (F, 6)."""
    JsL = torch.einsum("eai,eab->ebi", sys.Js, sys.Lam)
    JtL = torch.einsum("eai,eab->ebi", sys.Jt, sys.Lam)
    return (_scatter(F, sys.s, torch.einsum("ebi,eb->ei", JsL, sys.r))
            + _scatter(F, sys.t, torch.einsum("ebi,eb->ei", JtL, sys.r)))


def _local_diag_blocks(sys: EdgeSystem, F: int):
    """Per-shard block-diagonal of H scattered to (F, 6, 6)."""
    JsL = torch.einsum("eai,eab->ebi", sys.Js, sys.Lam)
    JtL = torch.einsum("eai,eab->ebi", sys.Jt, sys.Lam)
    return (_scatter(F, sys.s, torch.einsum("ebi,ebj->eij", JsL, sys.Js))
            + _scatter(F, sys.t, torch.einsum("ebi,ebj->eij", JtL, sys.Jt)))


def _local_hv(sys: EdgeSystem, v: torch.Tensor):
    """Per-shard H v: for each edge, u = Js v_s + Jt v_t; scatter J^T Lam u."""
    F = v.shape[0]
    u = (torch.einsum("eab,eb->ea", sys.Js, v[sys.s.long()])
         + torch.einsum("eab,eb->ea", sys.Jt, v[sys.t.long()]))
    w = torch.einsum("eab,eb->ea", sys.Lam, u)
    return (_scatter(F, sys.s, torch.einsum("eab,ea->eb", sys.Js, w))
            + _scatter(F, sys.t, torch.einsum("eab,ea->eb", sys.Jt, w)))


def _dot(a, c):
    return torch.sum(a * c)


def _cg_core(sys: EdgeSystem, F: int, lam: torch.Tensor, anchor: int, psum, n_iter: int,
             tol: float):
    dev = sys.r.device
    b, D = psum(_local_gradient(sys, F), _local_diag_blocks(sys, F))
    # damping + anchor pin on the diagonal blocks
    dvec = torch.diagonal(D, dim1=1, dim2=2)  # (F, 6)
    pin = torch.zeros(F, dtype=torch.float32, device=dev)
    pin[anchor] = 1e12
    damp = lam * dvec + 1e-9 + pin[:, None]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    # block-Jacobi preconditioner (replicated; F is tiny next to E)
    M_inv = torch.linalg.inv(D + torch.diag_embed(damp) + 1e-6 * eye6)

    def hv(v):
        return psum(_local_hv(sys, v))[0] + damp * v

    x = torch.zeros((F, 6), dtype=torch.float32, device=dev)
    r = -b - hv(x)
    p = torch.einsum("fij,fj->fi", M_inv, r)
    rz = _dot(r, p)
    thresh = tol * torch.clamp(_dot(b, b), min=1e-30)
    for i in range(n_iter):
        active = _dot(r, r) > thresh
        if i % _READ_EVERY == 0 and not bool(active):
            break
        Ap = hv(p)
        alpha = rz / torch.clamp(_dot(p, Ap), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = torch.einsum("fij,fj->fi", M_inv, r_new)
        rz_new = _dot(r_new, z)
        p_new = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        # a converged loop has stopped: its state no longer changes
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def solve_pose_graph_cg(
    sys: EdgeSystem,
    F: int,
    lam: torch.Tensor,
    anchor: int,
    mesh=None,
    axis: str = "edges",
    n_iter: int = 64,
    tol: float = 1e-8,
):
    """Solve (H + lam diag(H) + anchor pin) dx = -b matrix-free by CG with a
    block-Jacobi preconditioner. Returns dx (F, 6), equal on every rank.

    With `mesh` (a DeviceMesh with axis `axis`), every rank passes the whole
    system; the edges are padded to a multiple of the axis size and each
    rank keeps its contiguous shard, so each H-apply is a scatter over the
    rank's edges and one all_reduce over `axis`."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=sys.r.device)
    if mesh is not None:
        sys = EdgeSystem(*(_shard(a, mesh, axis)
                           for a in _pad_edges(sys, _axis_size(mesh, axis))))
    return _cg_core(sys, F, lam, anchor, _reducer(mesh, axis), n_iter, tol)


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment (observation-sharded)
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    """3D-3D bundle adjustment: fragment poses + world landmarks.

    Residual per observation o: r_o = T_c(o)^-1 X_l(o) - p_o (the world
    landmark mapped into the observing fragment's frame against the locally
    measured point; SLAC's data term has the same shape).
    """

    cam: torch.Tensor  # (O,) int32 observing fragment
    lm: torch.Tensor  # (O,) int32 landmark id
    p: torch.Tensor  # (O, 3) measured point, fragment-local frame
    w: torch.Tensor  # (O,) weight (0 = invalid/padding)


def _ba_residual_jac(poses, points, prob: BAProblem):
    """Per-observation residual (O, 3) + Jacobians Jc (O, 3, 6), Jp (O, 3, 3).

    The world->fragment map W_c = T_c^-1 is perturbed as exp(xi) W_c, so
    r = W_c X - p,  dr/dxi = [-[W_c X]_x | I],  dr/dX = R(W_c)."""
    Wr = poses[:, :3, :3].transpose(1, 2)  # R^T per camera
    Wt = -torch.einsum("fij,fj->fi", Wr, poses[:, :3, 3])
    cam, lm = prob.cam.long(), prob.lm.long()
    R = Wr[cam]  # (O, 3, 3)
    y = torch.einsum("oij,oj->oi", R, points[lm]) + Wt[cam]  # W_c X
    r = y - prob.p
    eye3 = torch.eye(3, dtype=torch.float32, device=y.device).expand(y.shape[0], 3, 3)
    Jc = torch.cat([-lie.hat(y), eye3], dim=-1)  # (O, 3, 6) wrt xi of W_c
    return r, Jc, R


def _ba_locals(r, Jc, Jp, prob: BAProblem, F: int, L: int):
    """Per-shard BA system pieces: bc (F, 6), bp (L, 3), Hcc_diag (F, 6, 6),
    Hpp (L, 3, 3), cost."""
    w = prob.w[:, None, None]
    JcT = Jc.transpose(1, 2) * w  # (O, 6, 3)
    JpT = Jp.transpose(1, 2) * w  # (O, 3, 3)
    bc = _scatter(F, prob.cam, torch.einsum("oij,oj->oi", JcT, r))
    bp = _scatter(L, prob.lm, torch.einsum("oij,oj->oi", JpT, r))
    Hcc = _scatter(F, prob.cam, torch.einsum("oia,oaj->oij", JcT, Jc))
    Hpp = _scatter(L, prob.lm, torch.einsum("oia,oaj->oij", JpT, Jp))
    cost = torch.sum(prob.w * torch.sum(r * r, dim=-1))
    return bc, bp, Hcc, Hpp, cost


def _ba_hcp_apply(Jc, Jp, prob: BAProblem, vp, F: int):
    """Per-shard Hcp vp: (L, 3) -> (F, 6)."""
    u = torch.einsum("oij,oj->oi", Jp, vp[prob.lm.long()]) * prob.w[:, None]
    return _scatter(F, prob.cam, torch.einsum("oji,oj->oi", Jc, u))


def _ba_hpc_apply(Jc, Jp, prob: BAProblem, vc, L: int):
    """Per-shard Hpc vc: (F, 6) -> (L, 3)."""
    u = torch.einsum("oij,oj->oi", Jc, vc[prob.cam.long()]) * prob.w[:, None]
    return _scatter(L, prob.lm, torch.einsum("oji,oj->oi", Jp, u))


def _ba_hcc_apply(Jc, prob: BAProblem, vc, F: int):
    u = torch.einsum("oij,oj->oi", Jc, vc[prob.cam.long()]) * prob.w[:, None]
    return _scatter(F, prob.cam, torch.einsum("oji,oj->oi", Jc, u))


def ba_gauss_newton(
    poses: torch.Tensor,  # (F, 4, 4) fragment->world
    points: torch.Tensor,  # (L, 3) world landmarks
    prob: BAProblem,
    mesh=None,
    axis: str = "obs",
    n_outer: int = 5,
    n_cg: int = 32,
    lam: float = 1e-6,
    anchor: int = 0,
):
    """Schur-complement BA over collectives.

    Each Gauss-Newton step solves the reduced camera system
      S dxc = -(bc - Hcp Hpp^-1 bp),   S = Hcc - Hcp Hpp^-1 Hpc
    by `n_cg` steps of preconditioned CG, every S-apply two observation
    sweeps and one all_reduce; then back-substitutes
    dxp = -Hpp^-1 (bp + Hpc dxc). With `mesh`, every rank passes the whole
    problem; the observations are padded (weight 0) to a multiple of the
    `axis` size and each rank keeps its shard; poses and landmarks stay
    replicated. Returns (poses', points', the cost at the last step's
    start), equal on every rank."""
    F = poses.shape[0]
    L = points.shape[0]
    if mesh is not None:
        pad = (-prob.p.shape[0]) % _axis_size(mesh, axis)
        if pad:
            prob = BAProblem(*(_pad_rows(a, pad) for a in prob))
        prob = BAProblem(*(_shard(a, mesh, axis) for a in prob))
    return _ba_gn_core(poses, points, prob, F, L, n_outer, n_cg, lam, anchor,
                       _reducer(mesh, axis))


def _ba_gn_core(poses, points, prob, F, L, n_outer, n_cg, lam, anchor, psum):
    """The Gauss-Newton steps shared by the local and sharded paths. `psum`
    reduces observation-sharded partials (the identity on one device)."""
    dev = poses.device
    pin = torch.zeros(F, dtype=torch.float32, device=dev)
    pin[anchor] = 1e12
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(n_outer):
        # the residuals and Jacobians hold still for the step's CG sweeps
        r, Jc, Jp = _ba_residual_jac(poses, points, prob)
        bc, bp, Hcc_d, Hpp, cost = psum(*_ba_locals(r, Jc, Jp, prob, F, L))
        Hpp_inv = torch.linalg.inv(Hpp + (lam + 1e-6) * eye3)  # (L, 3, 3)
        damp_c = lam * torch.diagonal(Hcc_d, dim1=1, dim2=2) + 1e-9 + pin[:, None]
        M_inv = torch.linalg.inv(Hcc_d + torch.diag_embed(damp_c) + 1e-6 * eye6)

        def hcp(v):
            return psum(_ba_hcp_apply(Jc, Jp, prob, v, F))[0]

        def hpc(v):
            return psum(_ba_hpc_apply(Jc, Jp, prob, v, L))[0]

        def s_apply(vc):
            # S vc = Hcc vc + damp - Hcp Hpp^-1 Hpc vc
            t1 = psum(_ba_hcc_apply(Jc, prob, vc, F))[0] + damp_c * vc
            t3 = torch.einsum("lij,lj->li", Hpp_inv, hpc(vc))
            return t1 - hcp(t3)

        rhs = -(bc - hcp(torch.einsum("lij,lj->li", Hpp_inv, bp)))
        x = torch.zeros((F, 6), dtype=torch.float32, device=dev)
        res = rhs - s_apply(x)
        p = torch.einsum("fij,fj->fi", M_inv, res)
        rz = _dot(res, p)
        for _ in range(n_cg):
            Ap = s_apply(p)
            alpha = rz / torch.clamp(_dot(p, Ap), min=1e-30)
            x = x + alpha * p
            res = res - alpha * Ap
            z = torch.einsum("fij,fj->fi", M_inv, res)
            rz2 = _dot(res, z)
            p = z + (rz2 / torch.clamp(rz, min=1e-30)) * p
            rz = rz2
        dxp = -torch.einsum("lij,lj->li", Hpp_inv, bp + hpc(x))
        # W_c <- exp(xi) W_c  =>  T_c <- T_c exp(-xi)
        poses = poses @ lie.invert_se3(lie.se3_exp(x))
        points = points + dxp
    return poses, points, cost
