"""Port parity: pipelines/slac.py of open3d_tpu_torch against open3d_tpu,
on tests/test_slac.py's seeded plane clouds and its bent fragments.

Bars: touch's tables and positions, parameterize's rows and validity and
neighbor_grid_map's maps equal, the trilinear ratios within 1e-6;
deform_points and deform_fragment within 1e-5; the rigid optimiser's poses
within 1e-5. The bent 4-fragment case of tests/test_slac.py with the JAX
package's Rademacher probes put in through the port's `_rademacher_probes`
seam: control positions within 1e-4 m, poses within 1e-5; with the port's
own probes, the JAX test's bar (surface error after < 0.8 x before). The
closed-form J v and J^T u against torch.func.jvp / vjp of the plain
residual: within 1e-5 of the largest entry. The convert.py control-grid
round trip exact. Both packages get the JAX package's normals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.ops import pointcloud as jops
from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu.pipelines import slac as jslac
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.pipelines import slac as tslac

torch.set_num_threads(2)


def _plane_cloud(n=10, extent=0.8, seed=0):
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-extent, extent, n), np.linspace(-extent, extent, n))
    pts = np.stack([X.ravel(), Y.ravel(), 0.1 * np.sin(3 * X.ravel())], axis=-1)
    return (pts + rng.normal(0, 1e-4, pts.shape)).astype(np.float32)


def _grids(pts, mask=None, grid_size=0.375, capacity=512):
    jg = jslac.touch(jslac.create_control_grid(grid_size, capacity), jnp.asarray(pts),
                     None if mask is None else jnp.asarray(mask))
    tg = tslac.touch(tslac.create_control_grid(grid_size, capacity, device="cpu"),
                     torch.from_numpy(pts), None if mask is None else torch.from_numpy(mask))
    return jg, tg


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


def test_control_grid_ops():
    pts = _plane_cloud()
    mask = np.random.default_rng(1).uniform(size=len(pts)) > 0.1
    jg, tg = _grids(pts, mask)
    _eq(tg.table, jg.table)
    _eq(tg.positions, jg.positions)
    _eq(tg.init_positions(), jg.init_positions())
    assert int(tg.size()) == int(jg.size()) > 8
    query = pts + np.float32(0.01)
    jp = jslac.parameterize(jg, jnp.asarray(query))
    tp = tslac.parameterize(tg, torch.from_numpy(query))
    _eq(tp.rows, jp.rows)
    _eq(tp.valid, jp.valid)
    _close(tp.ratios, jp.ratios, 1e-6)
    # a moved grid deforms the points alike; re-touching keeps it
    moved = np.asarray(jg.positions) + np.float32(0.05)
    jg2 = dataclasses.replace(jg, positions=jnp.asarray(moved))
    tg2 = dataclasses.replace(tg, positions=torch.from_numpy(moved))
    _close(tslac.deform_points(tg2, tp), jslac.deform_points(jg2, jp), 1e-5)
    _eq(tslac.touch(tg2, torch.from_numpy(pts)).positions,
        jslac.touch(jg2, jnp.asarray(pts)).positions)
    for cap in (None, 64):
        for x, y in zip(tslac.neighbor_grid_map(tg, cap), jslac.neighbor_grid_map(jg, cap)):
            _eq(x, y)


def _bend(pts, curvature):
    out = pts.copy()
    out[:, 2] += curvature * pts[:, 0] ** 2
    return out


def _fragments(curvature=0.08, offsets=(0.0, 0.5)):
    """tests/test_slac.py's fragments: overlapping views of one bumpy world
    surface, each bent in its local frame; both packages' clouds and graphs."""
    rng = np.random.default_rng(0)
    jf, tf, Ts = [], [], []
    for off in offsets:
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = off
        X, Y = np.meshgrid(np.linspace(-1.0, 1.0, 20) + off, np.linspace(-1.0, 1.0, 20))
        xy = np.stack([X.ravel(), Y.ravel()], -1)
        world = np.concatenate(
            [xy, (0.15 * np.sin(3.0 * xy[:, 0]) * np.cos(2.0 * xy[:, 1]))[:, None]], -1)
        world = (world + rng.normal(0, 1e-4, world.shape)).astype(np.float32)
        bent = _bend(world - T[:3, 3], curvature).astype(np.float32)
        pc = jops.estimate_normals(JPointCloud.create(jnp.asarray(bent)), max_nn=16)
        jf.append(pc)
        tf.append(convert.point_cloud_from_numpy(
            {"positions": np.asarray(pc.positions), "mask": np.asarray(pc.mask),
             "normals": np.asarray(pc.attrs["normals"])}, device="cpu"))
        Ts.append(T)
    F = len(Ts)
    edges = np.asarray([(i, j) for i in range(F) for j in range(i + 1, F)
                        if abs(offsets[i] - offsets[j]) < 1.2], np.int32)
    trans = np.stack([np.linalg.inv(Ts[i]) @ Ts[j] for i, j in edges]).astype(np.float32)
    jg = jpg.PoseGraph.create(np.stack(Ts), edges, trans)
    tg = convert.pose_graph_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in convert.POSE_GRAPH_FIELDS}, device="cpu")
    return jf, tf, jg, tg


def test_rigid_optimizer():
    jf, tf, jg, tg = _fragments(curvature=0.0)
    bad = np.asarray(jg.poses).copy()
    bad[1] = bad[1] @ np.asarray(jlie.se3_exp(
        jnp.asarray([0.0, 0.0, 0.02, 0.01, -0.01, 0.02], jnp.float32)))
    params = dict(max_iterations=8, distance_threshold=0.2, corres_capacity=512)
    a = jslac.run_rigid_optimizer_for_fragments(
        jf, dataclasses.replace(jg, poses=jnp.asarray(bad)), jslac.SLACOptimizerParams(**params))
    b = tslac.run_rigid_optimizer_for_fragments(
        tf, dataclasses.replace(tg, poses=torch.from_numpy(bad)),
        tslac.SLACOptimizerParams(**params))
    _close(b.poses, a.poses, 1e-5)
    truth = np.asarray(jg.poses[1])
    assert np.linalg.norm(b.poses[1].numpy() - truth) < 0.35 * np.linalg.norm(bad[1] - truth)


def _jax_probes(shape, n, device):
    key = jax.random.PRNGKey(0)
    z = [np.asarray(jax.random.rademacher(jax.random.fold_in(key, pi), shape, jnp.float32))
         for pi in range(n)]
    return torch.from_numpy(np.stack(z)).to(device)


def _surface_err(p):
    p = np.asarray(p)
    true_z = 0.15 * np.sin(3.0 * p[:, 0]) * np.cos(2.0 * p[:, 1])
    return float(np.sqrt(np.mean((p[:, 2] - true_z) ** 2)))


BENT = dict(max_iterations=2, distance_threshold=0.25, regularizer_weight=0.1, grid_size=0.5,
            grid_capacity=1024, corres_capacity=1024, rigid_iterations=0)


@pytest.fixture(scope="module")
def bent():
    jf, tf, jg, tg = _fragments(offsets=(0.0, 0.3, 0.75, 1.1))
    a_graph, a_cg = jslac.run_slac_optimizer_for_fragments(
        jf, jg, jslac.SLACOptimizerParams(**BENT), n_cg=96)
    return jf, tf, jg, tg, a_graph, a_cg


def test_slac_with_jax_probes(bent, monkeypatch):
    jf, tf, jg, tg, a_graph, a_cg = bent
    monkeypatch.setattr(tslac, "_rademacher_probes", _jax_probes)
    b_graph, b_cg = tslac.run_slac_optimizer_for_fragments(
        tf, tg, tslac.SLACOptimizerParams(**BENT), n_cg=96)
    _eq(b_cg.table, a_cg.table)
    _close(b_cg.positions, a_cg.positions, 1e-4)
    _close(b_graph.poses, a_graph.poses, 1e-5)
    for f in range(len(tf)):
        _close(tslac.deform_fragment(b_cg, b_graph, f, tf[f]).positions,
               jslac.deform_fragment(a_cg, a_graph, f, jf[f]).positions, 1e-4)
        # on the same grid, deform_fragment itself within 1e-5
        same = convert.control_grid_from_numpy(
            {"table": np.asarray(a_cg.table), "positions": np.asarray(a_cg.positions),
             "grid_size": a_cg.grid_size}, device="cpu")
        _close(tslac.deform_fragment(same, b_graph, f, tf[f]).positions,
               jslac.deform_fragment(a_cg, a_graph, f, jf[f]).positions, 1e-5)


def test_slac_straightens_with_own_probes(bent):
    _, tf, _, tg, _, _ = bent
    b_graph, b_cg = tslac.run_slac_optimizer_for_fragments(
        tf, tg, tslac.SLACOptimizerParams(**BENT), n_cg=96)
    F = len(tf)
    before = max(_surface_err(tlie.transform_points(tg.poses[f], tf[f].positions))
                 for f in range(F))
    after = max(_surface_err(tslac.deform_fragment(b_cg, b_graph, f, tf[f]).positions)
                for f in range(F))
    assert after < 0.8 * before, (before, after)


def test_closed_form_products_against_autodiff(bent):
    """J v and J^T u of one non-rigid step in closed form against
    torch.func.jvp / vjp of the residual written as the JAX package writes
    it, at a deformed grid (so the cell rotations are not the identity)."""
    _, tf, _, tg, _, _ = bent
    params = tslac.SLACOptimizerParams(**BENT)
    cg = tslac.create_control_grid(params.grid_size, params.grid_capacity, device="cpu")
    for pc in tf:
        cg = tslac.touch(cg, pc.positions, pc.mask)
    rng = np.random.default_rng(7)
    C = cg.capacity
    pos = cg.positions + torch.from_numpy(rng.normal(0, 0.02, (C + 1, 3)).astype(np.float32))
    pos[C] = 0.0
    cg = dataclasses.replace(cg, positions=pos)
    corres = tslac._find_correspondences(tf, tg, params)
    rows_a, nb_rows, nb_mask, _ = tslac.neighbor_grid_map(cg)
    R = tslac._estimate_cell_rotations(cg, rows_a, nb_rows, nb_mask)
    init_all = torch.cat([cg.init_positions(), torch.zeros(1, 3)])
    terms = []
    for ec in corres:
        i, j = ec.src_frag, ec.tgt_frag
        pp = tslac.parameterize(cg, tf[i].positions[ec.src_idx])
        pq = tslac.parameterize(cg, tf[j].positions[ec.tgt_idx])
        n_w = tf[j].attrs["normals"][ec.tgt_idx] @ tg.poses[j][:3, :3].T
        w = (ec.valid & pp.valid & pq.valid).to(torch.float32)
        terms.append((pp, pq, n_w, w, tg.poses[i], tg.poses[j]))
    ne = tslac._normal_equations(cg, terms, rows_a, nb_rows, nb_mask, params.regularizer_weight)
    a = torch.clamp(rows_a, max=C).long()
    nb = nb_rows.long()
    m = nb_mask[..., None].to(torch.float32)
    target = torch.einsum("aij,akj->aki", R, init_all[nb] - init_all[a][:, None, :])

    def plain(x):
        g = dataclasses.replace(cg, positions=x)
        data = torch.cat([torch.sqrt(w) * ((tlie.transform_points(Ti, tslac.deform_points(g, pp))
                                            - tlie.transform_points(Tj, tslac.deform_points(g, pq)))
                                           * n_w).sum(-1) for pp, pq, n_w, w, Ti, Tj in terms])
        reg = np.sqrt(params.regularizer_weight) * ((x[nb] - x[a][:, None, :]) - target) * m
        return data, reg

    v = torch.from_numpy(rng.normal(size=(C + 1, 3)).astype(np.float32))
    _, (jd, jr) = torch.func.jvp(plain, (cg.positions,), (v,))
    cd, cr = tslac._jv(ne, v)
    for got, want in ((cd, jd), (cr, jr)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ud = torch.from_numpy(rng.normal(size=cd.shape).astype(np.float32))
    ur = torch.from_numpy(rng.normal(size=cr.shape).astype(np.float32))
    _, pullback = torch.func.vjp(plain, cg.positions)
    (want,) = pullback((ud, ur))
    got = tslac._jtu(ne, ud, ur)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_control_grid_convert_round_trip():
    _, tg = _grids(_plane_cloud())
    back = convert.control_grid_from_numpy(convert.control_grid_to_numpy(tg), device="cpu")
    assert torch.equal(back.table, tg.table) and torch.equal(back.positions, tg.positions)
    assert back.grid_size == tg.grid_size
