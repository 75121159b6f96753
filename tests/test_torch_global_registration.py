"""Port parity: pipelines/features.py and pipelines/global_registration.py
of open3d_tpu_torch against open3d_tpu, on tests/test_global_registration.py's
structured corner scene made from a numpy seed (normals from the JAX
package, handed to both).

Bars:
- FPFH: both packages' SPFH bin choices compared pair by pair; at least
  99.99 % of the valid pairs fall in the same bins (a pair whose angle lies
  on a bin edge can round into the neighbouring bin in the other framework),
  and every FPFH row that no differing pair touches agrees within 1e-3 (the
  features run from 0 to 200) on one shared neighbour table, and on each
  package's own table where it comes from the hash grid's difference form.
  The brute force's expanded-form d2 rounds differently in the two
  frameworks, and the aggregation weighs by 1/d2: there a row agrees within
  1e-3 plus the most that its weights' measured difference can move it
  (_fpfh_bar).
- Feature matching: equal correspondences and masks, but where the two
  winners' float64 feature distances lie within 1e-5 (relative) of each
  other.
- The edge-length check equal on the same sampled ids, and the batched
  3-point Umeyama within 1e-2 of the JAX package's and of the truth on
  well-shaped triangles (see the test); FGR without the tuple test (no
  sampling) within 1e-4.
- Sampled RANSAC and FGR draw from a torch generator, not JAX's stream, so
  the outcomes are compared, not the bits: both packages within
  tests/test_global_registration.py's bars.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.core import nns as jnns
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.ops import pointcloud as jops
from open3d_tpu.pipelines import features as jfeat
from open3d_tpu.pipelines import global_registration as jgr
from open3d_tpu.pipelines import registration as jreg
from open3d_tpu_torch import convert
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.core import nns as tnns
from open3d_tpu_torch.pipelines import features as tfeat
from open3d_tpu_torch.pipelines import global_registration as tgr

torch.set_num_threads(2)


def _corner_scene(n, seed):
    """tests/test_global_registration.py's cloud: three noisy orthogonal
    planes and a diagonal ridge."""
    rng = np.random.RandomState(seed)
    per = n // 4
    xy = rng.uniform(-1, 1, (per, 2))
    pts = [np.c_[xy, 0.05 * np.sin(3 * xy[:, :1])]]
    xy = rng.uniform(-1, 1, (per, 2))
    pts.append(np.c_[xy[:, :1], 0.05 * np.cos(3 * xy[:, 1:]), xy[:, 1:]])
    xy = rng.uniform(-1, 1, (per, 2))
    pts.append(np.c_[0.05 * np.sin(2 * xy[:, :1]), xy])
    xy = rng.uniform(-1, 1, (n - 3 * per, 2))
    pts.append(np.c_[xy[:, :1], xy[:, 1:], 0.4 * xy[:, :1] + 0.3 * xy[:, 1:]])
    pos = np.concatenate(pts).astype(np.float32)
    return pos + rng.normal(0, 0.005, pos.shape).astype(np.float32)


def _rigid(angle=0.4, t=(0.3, -0.2, 0.5)):
    T = np.array(jlie.se3_exp(jnp.asarray([0.0, 0.0, 0.0, 0.1, angle, 0.2], jnp.float32)))
    T[:3, 3] = t
    return T


def _pair(arrays):
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    jp = JPointCloud(positions=j.pop("positions"), mask=j.pop("mask"), attrs=j)
    return jp, convert.point_cloud_from_numpy(arrays, device="cpu")


@functools.lru_cache(maxsize=None)
def _cloud(n, seed, move=None, drop=0):
    """A corner scene (moved by _rigid(*move)) with the JAX package's
    normals, as both packages' clouds; the first `drop` rows masked out.
    Made once per argument set for the whole file."""
    pos = _corner_scene(n, seed)
    if move is not None:
        T = _rigid(*move)
        pos = (pos @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    mask = np.arange(n) >= drop
    pos = np.where(mask[:, None], pos, np.float32(3e8))
    jp, _ = _pair({"positions": pos, "mask": mask})
    nrm = np.asarray(jops.estimate_normals(jp, max_nn=20).attrs["normals"])
    return _pair({"positions": pos, "mask": mask, "normals": nrm})


@functools.lru_cache(maxsize=None)
def _jax_fpfh(*cloud_args):
    """The JAX package's FPFH of _cloud(*cloud_args) (radius 0.5, 30
    neighbours), handed to both packages' matching."""
    return np.asarray(jfeat.compute_fpfh_feature(_cloud(*cloud_args)[0], radius=0.5, max_nn=30))


PATHS = {"brute": 65536, "grid": 1}  # hybrid_search's grid threshold


def _fpfh_bar(idx_a, d2_a, idx_b, d2_b):
    """(N,) float64: how far two FPFH rows may lie apart when their SPFHs
    agree and only the neighbour tables' d2 differ, plus 1e-3. The
    aggregated part is 100 N / D, N = sum_k s_k w_k <= D = sum_k S_k w_k
    with w_k = 1 / d2_k; weights off by a factor within 1 +- e move N and D
    each by at most e D, so 100 N / D moves by at most 200 e / (1 - e). e is
    a row's largest |d2_a / d2_b - 1| over the neighbours both tables weigh
    (rows with the same neighbour set); inf where one table weighs a
    neighbour the other does not."""
    n = idx_a.shape[0]
    ia, oa = torch.sort(idx_a, 1)
    ib, ob = torch.sort(idx_b, 1)
    da, db = torch.gather(d2_a, 1, oa).double(), torch.gather(d2_b, 1, ob).double()
    nbr = (ia >= 0) & (ia != torch.arange(n)[:, None])
    wa, wb = da > 1e-12, db > 1e-12
    e = torch.where(nbr & wa & wb, (da / torch.where(wb, db, 1.0) - 1.0).abs(), 0.0)
    e = torch.where(nbr & (wa != wb), torch.inf, e).amax(1)
    return torch.where(e < 1.0, 1e-3 + 200.0 * e / (1.0 - e), torch.inf)


@pytest.mark.parametrize("n,drop,path", [(512, 0, "brute"), (512, 40, "brute"), (512, 40, "grid")])
def test_fpfh_bins_pair_by_pair(n, drop, path, monkeypatch):
    jp, tp = _cloud(n, 1, None, drop)
    radius, max_nn = 0.5, 30
    threshold = PATHS[path]
    grid = dict(grid_threshold=threshold, max_per_cell=256)  # no cell capped
    ja, jd2, jc = jnns.hybrid_search(jp.positions, jp.positions, radius, max_nn, target_mask=jp.mask, **grid)
    ta, td2, _ = tnns.hybrid_search(tp.positions, tp.positions, radius, max_nn, target_mask=tp.mask, **grid)
    idx = np.asarray(ja)
    same_nbrs = np.all(np.sort(idx, 1) == np.sort(ta.numpy(), 1), axis=1)
    assert same_nbrs.mean() > 0.999

    # each package's pair features and bins on the JAX package's neighbour table
    pos, nrm = np.asarray(jp.positions), np.asarray(jp.attrs["normals"])
    safe = np.maximum(idx, 0)
    jf = jfeat._pair_features(jnp.asarray(pos[:, None]), jnp.asarray(nrm[:, None]),
                              jnp.asarray(pos[safe]), jnp.asarray(nrm[safe]))
    tf = tfeat._pair_features(torch.from_numpy(pos[:, None]), torch.from_numpy(nrm[:, None]),
                              torch.from_numpy(pos[safe]), torch.from_numpy(nrm[safe]))
    pair_ok = (idx >= 0) & (idx != np.arange(n)[:, None]) & np.asarray(jf[4])
    np.testing.assert_array_equal(tf[4].numpy(), np.asarray(jf[4]))
    differ = np.zeros_like(pair_ok)
    for f_j, f_t, lo, hi in ((jf[0], tf[0], -np.pi, np.pi), (jf[1], tf[1], -1.0, 1.0), (jf[2], tf[2], -1.0, 1.0)):
        np.testing.assert_allclose(f_t.numpy()[pair_ok], np.asarray(f_j)[pair_ok], atol=1e-5)
        bj = np.argmax(np.asarray(jfeat._bin11(f_j, lo, hi)), -1)
        bt = tfeat._bin11(f_t, lo, hi).argmax(-1).numpy()
        differ |= pair_ok & (bj != bt)
    assert differ.sum() <= 1e-4 * pair_ok.sum(), (int(differ.sum()), int(pair_ok.sum()))

    # SPFH on the same table: equal on every row with no differing pair
    sj, cj = jfeat._spfh(jp.positions, jp.attrs["normals"], ja, jnp.arange(n, dtype=jnp.int32))
    st, ct = tfeat._spfh(tp.positions, tp.attrs["normals"], torch.from_numpy(idx),
                         torch.arange(n, dtype=torch.int32))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    own = differ.any(1)
    np.testing.assert_allclose(st.numpy()[~own], np.asarray(sj)[~own], rtol=1e-6, atol=0)

    # FPFH: rows untouched by a differing pair (own or a neighbour's SPFH)
    # and, on each package's own table, by a differing neighbour set
    kw = dict(radius=radius, max_nn=max_nn, nns_grid_threshold=threshold, nns_max_per_cell=256)
    fj = np.asarray(jfeat.compute_fpfh_feature(jp, **kw))
    ft = tfeat.compute_fpfh_feature(tp, **kw)
    spfh_touched = own | np.any(own[safe] & (idx >= 0), axis=1)
    touched = spfh_touched | ~same_nbrs | np.any(~same_nbrs[safe] & (idx >= 0), axis=1)
    assert (~touched).mean() > 0.9
    if path == "grid":
        bar = np.full(n, 1e-3)
    else:
        bar = _fpfh_bar(torch.from_numpy(idx), torch.from_numpy(np.asarray(jd2)), ta, td2).numpy()
    row_err = np.abs(ft.numpy() - fj).max(1)
    assert np.all(row_err[~touched] <= bar[~touched]), (row_err[~touched].max(), bar[~touched].min())
    if drop:
        assert float(ft[~tp.mask].abs().max()) == 0.0
    assert tuple(ft.shape) == (n, 33) and bool(torch.isfinite(ft).all())
    # each group of the neighbour sum renormalised to 100, plus the SPFH
    assert float(ft.max()) <= 200.0 + 1e-3

    # both packages aggregating over one table, the JAX package's: within 1e-3
    table = tuple(torch.from_numpy(np.asarray(x)) for x in (ja, jd2, jc))
    monkeypatch.setattr(tnns, "hybrid_search", lambda *a, **k: table)
    fs = tfeat.compute_fpfh_feature(tp, **kw)
    np.testing.assert_allclose(fs.numpy()[~spfh_touched], fj[~spfh_touched], rtol=0, atol=1e-3)


def test_fpfh_plane_mass_in_middle_bins():
    """tests/test_reference_goldens.py's analytic case: coplanar points with
    one normal put every pair in bin 5 of each group."""
    g = np.linspace(0.0, 1.0, 12, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    pts = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size, np.float32)], -1)
    nrm = np.tile(np.float32([0, 0, 1]), (len(pts), 1))
    _, tp = _pair({"positions": pts, "mask": np.ones(len(pts), bool), "normals": nrm})
    f = tfeat.compute_fpfh_feature(tp, radius=0.25, max_nn=30).numpy()
    for gidx in range(3):
        grp = f[:, 11 * gidx:11 * (gidx + 1)]
        np.testing.assert_allclose(grp[:, 5], 200.0, rtol=1e-5)
        assert np.abs(np.delete(grp, 5, axis=1)).max() == 0.0


@pytest.mark.parametrize("mutual", [False, True])
def test_correspondences_from_features(mutual):
    src, tgt = _cloud(512, 1, None, 20), _cloud(512, 1, (0.4, (0.3, -0.2, 0.5)), 10)
    fs, ft = _jax_fpfh(512, 1, None, 20), _jax_fpfh(512, 1, (0.4, (0.3, -0.2, 0.5)), 10)
    a = jfeat.correspondences_from_features(jnp.asarray(fs), jnp.asarray(ft), mutual, src[0].mask, tgt[0].mask)
    b = tfeat.correspondences_from_features(torch.from_numpy(fs), torch.from_numpy(ft), mutual,
                                            src[1].mask, tgt[1].mask)
    ca, va, cb, vb = np.asarray(a[0]), np.asarray(a[1]), b[0].numpy(), b[1].numpy()
    assert cb.dtype == np.int32 and vb.dtype == bool
    d64 = np.sum((fs.astype(np.float64)[:, None] - ft.astype(np.float64)[None]) ** 2, -1)
    d64[:, ~tgt[1].mask.numpy()] = np.inf

    def tie(rows):  # the best two targets of each row within 1e-5 (relative)
        two = np.sort(d64[rows], axis=1)[:, :2]
        return np.abs(two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1]

    rows = np.nonzero((ca != cb) | (va != vb))[0]
    if mutual and len(rows):  # a mutual check also turns on the target's best source
        dts = d64.T.copy()
        dts[:, ~src[1].mask.numpy()] = np.inf
        back = np.sort(dts[np.maximum(cb[rows], 0)], axis=1)[:, :2]
        assert np.all(tie(rows) | (np.abs(back[:, 1] - back[:, 0]) <= 1e-5 * back[:, 1]))
    else:
        assert np.all(tie(rows)), rows
    assert len(rows) <= 0.01 * len(ca)
    assert not vb[:20].any()
    # the matches of a cloud and its moved copy: most are the true row
    assert float(((cb == np.arange(512)) & vb).mean()) > (0.6 if mutual else 0.5)


def test_edge_length_check_and_umeyama_on_the_same_samples():
    T = _rigid()
    src = _corner_scene(400, 2)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    rng = np.random.default_rng(4)
    cid = rng.integers(0, 400, (256, 3))
    # half the hypotheses sample true matches, half a row's match moved
    wrong = rng.uniform(size=(256, 1)) < 0.5
    ps, qs = src[cid], tgt[np.where(wrong, np.roll(cid, 1, axis=1), cid)]
    passed = {}
    for sim in (0.9, 0.5):
        a = np.asarray(jgr._check_edge_length(jnp.asarray(ps), jnp.asarray(qs), sim))
        passed[sim] = tgr._check_edge_length(torch.from_numpy(ps), torch.from_numpy(qs), sim).numpy()
        np.testing.assert_array_equal(passed[sim], a)
        assert 0 < passed[sim].sum() < len(a)
    w = np.ones(cid.shape, np.float32)
    Ta = np.asarray(jax.vmap(lambda p, q, ww: jreg._weighted_umeyama(p, q, ww))(
        jnp.asarray(ps), jnp.asarray(qs), jnp.asarray(w)))
    Tb = tgr._weighted_umeyama(torch.from_numpy(ps), torch.from_numpy(qs), torch.from_numpy(w)).numpy()
    # the hypotheses of true matches that pass, on triangles of area > 0.5:
    # both packages take W's SVD from the closed-form eigendecomposition of
    # W^T W, which squares the condition number of a 3-point W, so float32
    # rounding moves the rotation by up to 1e-2 in either package (thinner
    # triangles by far more); both against the truth as well
    area = np.linalg.norm(np.cross(ps[:, 1] - ps[:, 0], ps[:, 2] - ps[:, 0]), axis=-1)
    ok = passed[0.9] & ~wrong[:, 0] & (area > 0.5)
    assert ok.sum() > 50
    np.testing.assert_allclose(Tb[ok], Ta[ok], atol=1e-2)
    np.testing.assert_allclose(Tb[ok], np.broadcast_to(T, Tb[ok].shape), atol=1e-2)


def test_tuple_test_keeps_any_passing_tuple():
    """A row drawn by several tuples stays if any of them passed: the draws
    replayed from the same generator, checked in numpy."""
    T = _rigid(0.2, (0.1, 0.2, -0.1))
    src = _corner_scene(300, 3)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    rng = np.random.RandomState(0)
    corres = np.where(rng.rand(300) < 0.4, rng.permutation(300), np.arange(300)).astype(np.int32)
    valid = rng.rand(300) < 0.9
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(corres), torch.from_numpy(valid),
            0.95, 500)
    keep = tgr._tuple_test(*args, torch.Generator().manual_seed(7)).numpy()
    order = np.argsort(~valid, kind="stable")
    ids = torch.randint(0, int(valid.sum()), (500, 3), generator=torch.Generator().manual_seed(7)).numpy()
    cid = order[ids]
    p, q = src[cid], tgt[corres[cid]]

    def edge(a, b):
        r = np.linalg.norm(p[:, a] - p[:, b], axis=-1) / np.maximum(np.linalg.norm(q[:, a] - q[:, b], axis=-1), 1e-12)
        return (r > 0.95) & (r < 1 / 0.95)

    passed = edge(0, 1) & edge(1, 2) & edge(2, 0)
    expect = np.zeros(300, bool)
    expect[cid[passed].ravel()] = True
    np.testing.assert_array_equal(keep, valid & expect)
    # some row was drawn by a failing tuple after a passing one
    assert passed.any() and (~passed).any()


def test_fgr_without_tuple_test_matches_jax():
    move = (0.3, (0.2, 0.1, -0.3))
    T = _rigid(*move)
    src, tgt = _cloud(512, 4), _cloud(512, 4, move)
    fs, ft = _jax_fpfh(512, 4), _jax_fpfh(512, 4, move)
    a = jgr.registration_fgr_based_on_feature_matching(
        src[0], tgt[0], jnp.asarray(fs), jnp.asarray(ft),
        jgr.FGROption(maximum_correspondence_distance=0.05, tuple_test=False))
    b = tgr.registration_fgr_based_on_feature_matching(
        src[1], tgt[1], torch.from_numpy(fs), torch.from_numpy(ft),
        tgr.FGROption(maximum_correspondence_distance=0.05, tuple_test=False))
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), atol=1e-4)
    assert abs(float(b.fitness) - float(a.fitness)) < 1e-3
    assert int(b.num_iterations) == 64
    rot, trans = tlie.pose_distance(b.transformation, torch.from_numpy(T))
    assert float(rot) < 0.05 and float(trans) < 0.05


def _within(result, T, bar):
    rot, trans = (float(x) for x in tlie.pose_distance(torch.as_tensor(np.asarray(result.transformation)),
                                                      torch.from_numpy(T)))
    return rot < bar and trans < bar


def test_ransac_on_feature_matching():
    move = (0.4, (0.3, -0.2, 0.5))
    T = _rigid(*move)
    src, tgt = _cloud(512, 1), _cloud(512, 1, move)
    fs, ft = _jax_fpfh(512, 1), _jax_fpfh(512, 1, move)
    crit = dict(max_iteration=4096)
    a = jgr.registration_ransac_based_on_feature_matching(
        src[0], tgt[0], jnp.asarray(fs), jnp.asarray(ft), 0.05,
        criteria=jgr.RANSACConvergenceCriteria(**crit), key=jax.random.PRNGKey(3))
    b = tgr.registration_ransac_based_on_feature_matching(
        src[1], tgt[1], torch.from_numpy(fs), torch.from_numpy(ft), 0.05,
        criteria=tgr.RANSACConvergenceCriteria(**crit), key=torch.Generator().manual_seed(3))
    for r in (a, b):
        assert float(r.fitness) > 0.7 and _within(r, T, 0.05)
    # the default generator (seeded 0) gives the same result on every call
    c = tgr.registration_ransac_based_on_feature_matching(
        src[1], tgt[1], torch.from_numpy(fs), torch.from_numpy(ft), 0.05,
        criteria=tgr.RANSACConvergenceCriteria(**crit))
    d = tgr.registration_ransac_based_on_feature_matching(
        src[1], tgt[1], torch.from_numpy(fs), torch.from_numpy(ft), 0.05,
        criteria=tgr.RANSACConvergenceCriteria(**crit))
    assert torch.equal(c.transformation, d.transformation) and _within(c, T, 0.05)


def test_ransac_from_correspondences_with_outliers():
    move = (0.2, (0.1, 0.2, -0.1))
    T = _rigid(*move)
    src, tgt = _cloud(256, 2), _cloud(256, 2, move)
    rng = np.random.RandomState(0)
    bad, perm = rng.rand(256) < 0.4, rng.permutation(256)
    corres = np.where(bad, perm, np.arange(256)).astype(np.int32)
    a = jgr.registration_ransac_from_correspondences(
        src[0], tgt[0], jnp.asarray(corres), jnp.ones(256, bool), 0.05,
        criteria=jgr.RANSACConvergenceCriteria(max_iteration=2048))
    b = tgr.registration_ransac_from_correspondences(
        src[1], tgt[1], torch.from_numpy(corres), torch.ones(256, dtype=torch.bool), 0.05,
        criteria=tgr.RANSACConvergenceCriteria(max_iteration=2048))
    for r in (a, b):
        assert _within(r, T, 0.03)
    assert abs(float(b.fitness) - float(a.fitness)) < 0.05 and float(b.fitness) > 0.5
    assert int(b.num_iterations) == 0


def test_fgr_on_feature_matching():
    move = (0.3, (0.2, 0.1, -0.3))
    T = _rigid(*move)
    src, tgt = _cloud(512, 4), _cloud(512, 4, move)
    fs, ft = _jax_fpfh(512, 4), _jax_fpfh(512, 4, move)
    a = jgr.registration_fgr_based_on_feature_matching(
        src[0], tgt[0], jnp.asarray(fs), jnp.asarray(ft), jgr.FGROption(maximum_correspondence_distance=0.05))
    b = tgr.registration_fgr_based_on_feature_matching(
        src[1], tgt[1], torch.from_numpy(fs), torch.from_numpy(ft),
        tgr.FGROption(maximum_correspondence_distance=0.05), key=torch.Generator().manual_seed(1))
    for r in (a, b):
        assert _within(r, T, 0.05)
