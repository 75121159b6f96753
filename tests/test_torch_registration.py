"""Port parity: pipelines/robust_kernels.py and pipelines/registration.py
of open3d_tpu_torch against open3d_tpu, on the same seeded numpy clouds
built for both packages from one numpy dict.

Bars: the robust kernels' weights within 1e-3 of Open3D's literal goldens
(tests/test_reference_goldens.py's ten cases) and within 1e-6 of the JAX
package's; a Gauss-Newton or Umeyama update within 1e-5; ICP's pose within
1e-4 elementwise of the JAX package's for every estimation, its fitness
within 2/N; the information matrix within 1e-4 relative. The port's ICP
runs a fixed number of iterations, later ones frozen once converged: its
pose and iteration count equal those of the early-exit loop the JAX
package runs, transcribed here with a host read an iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.pipelines import registration as jreg
from open3d_tpu.pipelines import robust_kernels as jrk
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.pipelines import registration as treg
from open3d_tpu_torch.pipelines import robust_kernels as trk

torch.set_num_threads(2)

# (kind, scale, shape, expected weight at r = 0.98): Open3D's literals
# (cpp/tests/t/pipelines/registration/Registration.cpp:415-423, 460-488)
GOLDENS = [
    (trk.L2, 1.0, 1.0, 1.0),
    (trk.L1, 1.0, 1.0, 1.0204),
    (trk.HUBER, 1.0, 1.0, 1.0),
    (trk.CAUCHY, 1.0, 1.0, 0.5101),
    (trk.GM, 1.0, 1.0, 0.260202),
    (trk.TUKEY, 1.0, 1.0, 0.00156816),
    (trk.GENERALIZED, 1.0, 1.0, 0.714213),
    (trk.GENERALIZED, 1.0, 2.0, 1.0),
    (trk.GENERALIZED, 1.0, 0.0, 0.675584),
    (trk.GENERALIZED, 1.0, -2.0, 0.650259),
]


@pytest.mark.parametrize("kind,scale,shape,expected", GOLDENS)
def test_robust_kernel_goldens(kind, scale, shape, expected):
    k = trk.RobustKernel(kind=kind, scaling_parameter=scale, shape_parameter=shape)
    w = float(k.weight(torch.tensor(0.98)))
    assert abs(w - expected) < 1e-3, f"{kind}: {w} vs {expected}"
    # and the JAX package's weights over a range of residuals
    r = np.linspace(-2.0, 2.0, 41, dtype=np.float32)
    ref = jrk.RobustKernel(kind=kind, scaling_parameter=scale, shape_parameter=shape).weight(jnp.asarray(r))
    np.testing.assert_allclose(k.weight(torch.from_numpy(r)).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_robust_kernel_welsch_and_unknown():
    r = np.linspace(-1.0, 1.0, 9, dtype=np.float32)
    a = trk.RobustKernel(trk.GENERALIZED, 0.5, -1e8).weight(torch.from_numpy(r))
    b = jrk.RobustKernel(jrk.GENERALIZED, 0.5, -1e8).weight(jnp.asarray(r))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown"):
        trk.RobustKernel("nope").weight(torch.zeros(2))


# ---- _weighted_umeyama ------------------------------------------------------


def _rigid(xi):
    return np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))


@pytest.mark.parametrize("planar,with_scaling,weighted", [
    (False, False, False), (True, False, False), (False, True, False), (False, False, True),
])
def test_weighted_umeyama(planar, with_scaling, weighted):
    rng = np.random.default_rng(3)
    p = rng.normal(size=(300, 3)).astype(np.float32)
    if planar:
        p[:, 2] = 0.0
    T = _rigid([0.4, -0.2, 0.7, 0.3, -0.1, 0.5])
    q = p @ T[:3, :3].T * (1.3 if with_scaling else 1.0) + T[:3, 3]
    w = rng.uniform(0.2, 1.0, 300).astype(np.float32) if weighted else np.ones(300, np.float32)
    q[:30] += rng.normal(size=(30, 3)).astype(np.float32) * (0.5 if weighted else 0.0)
    w[:30] = 0.0 if weighted else w[:30]
    a = np.asarray(jreg._weighted_umeyama(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), with_scaling))
    b = treg._weighted_umeyama(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(w),
                               with_scaling).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_allclose(b[:3, 3], T[:3, 3], atol=1e-4)
    R = b[:3, :3] / (1.3 if with_scaling else 1.0)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    # batched over leading dimensions: each batch item as alone
    pb = torch.from_numpy(np.stack([p[:100], p[100:200]]))
    qb = torch.from_numpy(np.stack([q[:100], q[100:200]]))
    wb = torch.from_numpy(np.stack([w[:100], w[100:200]]))
    Tb = treg._weighted_umeyama(pb, qb, wb, with_scaling)
    for i in range(2):
        torch.testing.assert_close(Tb[i], treg._weighted_umeyama(pb[i], qb[i], wb[i], with_scaling),
                                   rtol=0, atol=1e-6)


# ---- clouds -------------------------------------------------------------------

N = 1200
XI = [0.02, -0.015, 0.01, 0.01, -0.02, 0.015]


def _bumpy(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    z = 0.25 * np.sin(2.5 * xy[:, 0]) * np.cos(2.0 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32), rng


def _pair(arrays):
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jp = JPointCloud(positions=j.pop("positions"), mask=j.pop("mask"), attrs=j)
    return jp, convert.point_cloud_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def clouds():
    """Target: a bumpy surface with normals, colours, colour gradients and
    covariances (computed once by the JAX package, so both packages read the
    same attributes); source: an independent sample of it moved by the
    inverse of T_true, with covariances, Dopplers and ray directions."""
    from open3d_tpu.ops import pointcloud as jops

    tgt, rng = _bumpy(N, 0)
    src, _ = _bumpy(N, 1)
    T = _rigid(XI)
    src = ((src - T[:3, 3]) @ T[:3, :3]).astype(np.float32)  # T^-1 applied
    mask = np.ones(N, bool)
    mask[rng.uniform(size=N) < 0.05] = False
    colors = (0.5 + 0.4 * np.sin(3.0 * tgt[:, :1] + np.arange(3))).astype(np.float32)
    jt, _ = _pair({"positions": np.where(mask[:, None], tgt, 3e8).astype(np.float32), "mask": mask,
                   "colors": colors})
    jt = jops.estimate_color_gradients(jops.estimate_covariances(jops.estimate_normals(jt, 16), 16), 16)
    js, _ = _pair({"positions": src, "mask": np.ones(N, bool)})
    js = jops.estimate_covariances(js, 16)
    dirs = src / np.linalg.norm(src, axis=1, keepdims=True)
    xi = np.asarray(jlie.se3_log(jnp.asarray(T)))
    v_pt = np.cross(np.broadcast_to(xi[:3], src.shape), src) + xi[3:]
    src_colors = (0.5 + 0.4 * np.sin(3.0 * (src @ T[:3, :3].T + T[:3, 3])[:, :1] + np.arange(3)))
    tgt_np = {"positions": np.asarray(jt.positions), "mask": mask,
              **{k: np.asarray(v) for k, v in jt.attrs.items()}}
    src_np = {"positions": src, "mask": np.ones(N, bool),
              "covariances": np.asarray(js.attrs["covariances"]),
              "colors": src_colors.astype(np.float32),
              "dopplers": ((dirs * v_pt).sum(1) / 0.1).astype(np.float32),
              "directions": dirs.astype(np.float32)}
    return _pair(src_np), _pair(tgt_np), T


ESTIMATIONS = {
    "point_to_point": lambda m: m.TransformationEstimationPointToPoint(),
    "point_to_plane": lambda m: m.TransformationEstimationPointToPlane(),
    "point_to_plane_tukey": lambda m: m.TransformationEstimationPointToPlane(
        kernel=(jrk if m is jreg else trk).RobustKernel("tukey", 0.05)),
    "colored": lambda m: m.TransformationEstimationForColoredICP(),
    "generalized": lambda m: m.TransformationEstimationForGeneralizedICP(),
    "doppler": lambda m: m.TransformationEstimationForDopplerICP(period=0.1, lambda_doppler=0.05),
}


@pytest.mark.parametrize("name", sorted(ESTIMATIONS))
def test_estimation_compute(clouds, name):
    """One update from the same correspondences, gathered by index and
    handed over as rows (the banded path's form)."""
    (js, ts), (jt, tt), T = clouds
    je, te = ESTIMATIONS[name](jreg), ESTIMATIONS[name](treg)
    pos = np.asarray(js.positions)
    idx, d2 = treg.nns.one_nn_search(ts.positions, tt.positions, tt.mask)
    valid = (d2 <= 0.2**2) & (idx >= 0)
    Tcur = _rigid([0.001, 0.0, -0.002, 0.003, 0.0, 0.001])
    extras = te.corr_extras(tt)
    rows = torch.cat([tt.positions] + ([] if extras is None else [extras.reshape(N, -1)]), 1)
    rows = rows[torch.clamp(idx, min=0).long()]
    for corr_rows in (None, rows):
        b = te.compute(ts.positions, ts.attrs, tt, idx, valid, torch.from_numpy(Tcur), corr_rows=corr_rows)
        a = je.compute(jnp.asarray(pos), js.attrs, jt, jnp.asarray(idx.numpy()), jnp.asarray(valid.numpy()),
                       jnp.asarray(Tcur), corr_rows=None if corr_rows is None else jnp.asarray(rows.numpy()))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    assert (extras is None) == (name == "point_to_point")


@pytest.mark.parametrize("name,backend", [
    ("point_to_point", "exact"), ("point_to_plane", "banded"), ("point_to_plane", "exact"),
    ("colored", "exact"), ("generalized", "banded"), ("doppler", "exact"),
])
def test_icp(clouds, name, backend):
    (js, ts), (jt, tt), T = clouds
    crit_j, crit_t = jreg.ICPConvergenceCriteria(max_iteration=15), treg.ICPConvergenceCriteria(max_iteration=15)
    a = jreg.icp(js, jt, 0.2, estimation=ESTIMATIONS[name](jreg), criteria=crit_j, nns_backend=backend)
    b = treg.icp(ts, tt, 0.2, estimation=ESTIMATIONS[name](treg), criteria=crit_t, nns_backend=backend)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), atol=1e-4)
    assert abs(float(b.fitness) - float(a.fitness)) <= 2.0 / N
    assert abs(float(b.inlier_rmse) - float(a.inlier_rmse)) < 1e-4
    assert b.num_iterations.dtype == torch.int32 and 1 <= int(b.num_iterations) <= 15
    rot, trans = tlie.pose_distance(b.transformation, torch.from_numpy(T))
    assert float(rot) < 0.02 and float(trans) < 0.02


def test_icp_init_and_grid_backend(clouds):
    (js, ts), (jt, tt), T = clouds
    init = _rigid([0.01, -0.01, 0.005, 0.01, -0.01, 0.01])
    kw = dict(criteria=treg.ICPConvergenceCriteria(max_iteration=10), nns_backend="grid")
    a = jreg.icp(js, jt, 0.2, jnp.asarray(init), jreg.TransformationEstimationPointToPlane(),
                 jreg.ICPConvergenceCriteria(max_iteration=10), nns_backend="grid")
    b = treg.icp(ts, tt, 0.2, torch.from_numpy(init), treg.TransformationEstimationPointToPlane(), **kw)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), atol=1e-4)
    assert abs(float(b.fitness) - float(a.fitness)) <= 2.0 / N


def _icp_early_exit(source, target, dmax, estimation, criteria):
    """The JAX package's while_loop, transcribed with a host read an
    iteration: stop after the iteration whose fitness and rmse moved less
    than the criteria (not the first)."""
    T = torch.eye(4)
    fit = rmse = torch.zeros(())
    it = 0
    while it < criteria.max_iteration:
        pos = torch.where(source.mask[:, None], tlie.transform_points(T, source.positions), source.positions)
        idx, d2, valid = treg._correspondences(pos, source.mask, target, dmax)
        new_f, new_r = treg._fitness_rmse(source.mask, d2, valid)
        T = estimation.compute(pos, source.attrs, target, idx, valid, T) @ T
        conv = it > 0 and bool((abs(fit - new_f) < criteria.relative_fitness)
                               & (abs(rmse - new_r) < criteria.relative_rmse))
        fit, rmse, it = new_f, new_r, it + 1
        if conv:
            break
    return T, it


@pytest.mark.parametrize("name,rel", [("point_to_plane", 1e-6), ("point_to_point", 1e-4),
                                      ("colored", 1e-5)])
def test_fixed_iteration_icp_equals_early_exit(clouds, name, rel):
    (_, ts), (_, tt), _ = clouds
    crit = treg.ICPConvergenceCriteria(relative_fitness=rel, relative_rmse=rel, max_iteration=25)
    est = ESTIMATIONS[name](treg)
    T_early, taken = _icp_early_exit(ts, tt, 0.2, est, crit)
    r = treg.icp(ts, tt, 0.2, estimation=est, criteria=crit, nns_backend="exact")
    assert taken < 25  # converged before the iteration budget
    assert int(r.num_iterations) == taken
    assert torch.equal(r.transformation, T_early)


def _only(pair, *names):
    """The clouds with only the named attributes (the JAX package's
    voxel_down_sample averages (N,) and (N, 3) attributes only)."""
    j, t = pair
    return (JPointCloud(j.positions, j.mask, {k: j.attrs[k] for k in names}),
            t.with_attrs(**{k: None for k in t.attrs if k not in names}))


def test_multi_scale_icp(clouds):
    (js, ts), (jt, tt), T = clouds
    (js, ts), (jt, tt) = _only((js, ts)), _only((jt, tt), "normals")
    kw = dict(voxel_sizes=[0.08, 0.04, -1.0], max_correspondence_distances=[0.3, 0.15, 0.08])
    a = jreg.multi_scale_icp(js, jt, criteria_list=[jreg.ICPConvergenceCriteria(max_iteration=8)] * 3, **kw)
    b = treg.multi_scale_icp(ts, tt, criteria_list=[treg.ICPConvergenceCriteria(max_iteration=8)] * 3, **kw)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), atol=1e-4)
    assert abs(float(b.fitness) - float(a.fitness)) <= 2.0 / N
    rot, trans = tlie.pose_distance(b.transformation, torch.from_numpy(T))
    assert float(rot) < 0.02 and float(trans) < 0.02
    with pytest.raises(ValueError):
        treg.multi_scale_icp(ts, tt, [0.1], [], [0.2])


def test_evaluate_registration_and_information_matrix(clouds):
    (js, ts), (jt, tt), T = clouds
    for Tx in (None, T):
        a = jreg.evaluate_registration(js, jt, 0.05, None if Tx is None else jnp.asarray(Tx))
        b = treg.evaluate_registration(ts, tt, 0.05, None if Tx is None else torch.from_numpy(Tx))
        assert abs(float(b.fitness) - float(a.fitness)) <= 2.0 / N
        assert abs(float(b.inlier_rmse) - float(a.inlier_rmse)) < 1e-5
        assert int(b.num_iterations) == 0
    same = treg.evaluate_registration(tt, tt, 0.05)
    assert float(same.fitness) == 1.0 and float(same.inlier_rmse) < 1e-3
    info_a = np.asarray(jreg.get_information_matrix(js, jt, 0.05, jnp.asarray(T)))
    info_b = treg.get_information_matrix(ts, tt, 0.05, torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(info_b, info_a, rtol=1e-4, atol=1e-3)
    assert np.linalg.eigvalsh(info_b.astype(np.float64)).min() > 0
