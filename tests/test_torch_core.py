"""Port parity: core (lie, linalg, masking, hashmap) of open3d_tpu_torch
against open3d_tpu on the same numpy inputs.

Tolerances: float32 atol 1e-5 for lie/linalg (the two packages round the
same formulas in float32, in possibly different summation orders). The
hash map is a deterministic integer algorithm, so tables, slots, `ok`,
unique keys and counts must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import hashmap as jhm
from open3d_tpu.core import lie as jlie
from open3d_tpu.core import linalg as jlinalg
from open3d_tpu.core import masking as jmasking
from open3d_tpu_torch.core import hashmap as thm
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.core import linalg as tlinalg
from open3d_tpu_torch.core import masking as tmasking

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def xis(rng):
    xi = rng.normal(size=(64, 6)).astype(np.float32) * 0.7
    xi[0] = 0.0  # identity
    xi[1, :3] = [1e-6, -2e-6, 0.0]  # tiny angle (Taylor branch)
    xi[2, :3] = [0.0, 3.1, 0.0]  # near pi
    return xi


def test_hat_and_so3_exp(xis):
    w = xis[:, :3]
    _close(jlie.hat(w), tlie.hat(_t(w)))
    _close(jlie.so3_exp(w), tlie.so3_exp(_t(w)))


@pytest.mark.parametrize("fn", ["se3_exp", "invert_se3", "so3_log", "se3_log"])
def test_lie_maps(fn, xis):
    T = np.asarray(jlie.se3_exp(xis))
    if fn == "se3_exp":
        _close(jlie.se3_exp(xis), tlie.se3_exp(_t(xis)))
    elif fn == "invert_se3":
        _close(jlie.invert_se3(T), tlie.invert_se3(_t(T)))
    elif fn == "so3_log":
        _close(jlie.so3_log(T[:, :3, :3]), tlie.so3_log(_t(T[:, :3, :3])), atol=1e-4)
    else:
        _close(jlie.se3_log(T), tlie.se3_log(_t(T)), atol=1e-4)


def test_transform_points_and_pose_distance(rng, xis):
    T = np.asarray(jlie.se3_exp(xis))
    pts = rng.normal(size=(64, 100, 3)).astype(np.float32)
    _close(jlie.transform_points(T[:, None], pts), tlie.transform_points(_t(T)[:, None], _t(pts)), 1e-4)
    Tb = np.asarray(jlie.se3_exp(xis[::-1].copy()))
    rj, tj = jlie.pose_distance(T, Tb)
    rt, tt = tlie.pose_distance(_t(T), _t(Tb))
    _close(rj, rt, 1e-4)
    _close(tj, tt, 1e-4)


def test_linalg_gn_solve(rng):
    J = rng.normal(size=(16, 200, 6)).astype(np.float32)
    JtJ = np.einsum("bni,bnj->bij", J, J).astype(np.float32)
    Jtr = rng.normal(size=(16, 6)).astype(np.float32)
    L = jlinalg.cholesky6x6(JtJ)
    _close(L, tlinalg.cholesky6x6(_t(JtJ)), 1e-4)
    xj = jlinalg.solve_gn_6x6(JtJ, Jtr)
    xt = tlinalg.solve_gn_6x6(_t(JtJ), _t(Jtr))
    _close(xj, xt, ATOL)
    _close(jlinalg.solve_cholesky6x6(JtJ, Jtr), tlinalg.solve_cholesky6x6(_t(JtJ), _t(Jtr)), ATOL)


@pytest.mark.parametrize("n,cap", [(100, 40), (30, 64), (50, 50)])
def test_compact_indices(rng, n, cap):
    mask = rng.random(n) < 0.4
    ij, cj = jmasking.compact_indices(jnp.asarray(mask), cap)
    it, ct = tmasking.compact_indices(_t(mask), cap)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert int(cj) == int(ct)
    assert tmasking.FAR_COORD == jmasking.FAR_COORD


def _random_coords(rng, n, lo=-2000, hi=2000):
    c = rng.integers(lo, hi, size=(n, 3)).astype(np.int32)
    c[:4] = [[-(1 << 20), 0, 5], [(1 << 20) - 1, -7, 0], [0, 0, 0], [-1, -1, -1]]
    return c


def test_pack_unpack_and_hash(rng):
    c = _random_coords(rng, 5000)
    kj = np.asarray(jhm.pack_coords(jnp.asarray(c)))
    kt = thm.pack_coords(_t(c))
    np.testing.assert_array_equal(kj, kt.numpy())
    np.testing.assert_array_equal(np.asarray(jhm.unpack_coords(kj)), thm.unpack_coords(kt).numpy())
    np.testing.assert_array_equal(
        np.asarray(jhm._hash(jnp.asarray(kj))).astype(np.int64), thm._hash(kt).numpy()
    )
    np.testing.assert_array_equal(np.asarray(jhm.is_valid(kj)), thm.is_valid(kt).numpy())


@pytest.mark.parametrize("capacity,n_keys", [(512, 200), (256, 250)], ids=["normal", "high_load"])
def test_activate_and_find(rng, capacity, n_keys):
    """Insert two batches (the second overlapping the first) and look up a
    mix of present and absent keys; the high-load case fills the table to
    ~98 % so probe chains collide and some inserts fail within max_rounds."""
    c = np.unique(_random_coords(rng, 3 * n_keys, -30, 30), axis=0)[: 2 * n_keys]
    rng.shuffle(c)
    keys = np.asarray(jhm.pack_coords(jnp.asarray(c)))
    b1 = keys[:n_keys].copy()
    b1[::17] = 0  # invalid rows are ignored
    b2 = keys[n_keys // 2 : n_keys // 2 + n_keys].copy()
    tj, tt = jhm.make_table(capacity), thm.make_table(capacity, device="cpu")
    for batch in (b1, b2):
        tj, sj, oj = jhm.activate(tj, jnp.asarray(batch))
        tt, st, ot = thm.activate(tt, _t(batch))
        np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
        np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
        okn = np.asarray(oj)
        np.testing.assert_array_equal(np.asarray(sj)[okn], st.numpy()[okn])
    q = keys[rng.permutation(len(keys))[: 2 * n_keys]]
    fj, fjok = jhm.find(tj, jnp.asarray(q))
    ft, ftok = thm.find(tt, _t(q))
    np.testing.assert_array_equal(np.asarray(fjok), ftok.numpy())
    np.testing.assert_array_equal(np.asarray(fj)[np.asarray(fjok)], ft.numpy()[ftok.numpy()])
    np.testing.assert_array_equal(np.asarray(jhm.occupied_mask(tj)), thm.occupied_mask(tt).numpy())


@pytest.mark.parametrize("n,cap", [(3000, 512), (300, 512), (2000, 2000)])
def test_unique_keys(rng, n, cap):
    c = _random_coords(rng, n, -6, 6)  # many duplicates
    keys = np.array(jhm.pack_coords(jnp.asarray(c)))
    keys[::11] = 0
    uj, cj = jhm.unique_keys(jnp.asarray(keys), cap)
    ut, ct = thm.unique_keys(_t(keys), cap)
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    assert int(cj) == int(ct)


# ---- the deterministic scatter-add (core.masking._scatter_add) -------------


@pytest.mark.parametrize("shape", [(), (3,), (6, 6)], ids=["scalar", "vec3", "block6"])
def test_scatter_add_matches_a_float64_sum(rng, shape):
    """Within 1e-6 relative of numpy's float64 sum; out-of-range rows
    (negative, n and beyond) are dropped, as JAX's mode="drop" drops them;
    two calls give the same bits."""
    n, m = 37, 4000
    idx = rng.integers(-5, n + 5, m)
    vals = rng.normal(size=(m,) + shape).astype(np.float32)
    out = tmasking._scatter_add(_t(vals), _t(idx), n)
    ref = np.zeros((n,) + shape)
    keep = (idx >= 0) & (idx < n)
    np.add.at(ref, idx[keep], vals[keep].astype(np.float64))
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,) + shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    again = tmasking._scatter_add(_t(vals), _t(idx), n)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_scatter_add_empty_and_unhit_rows():
    out = tmasking._scatter_add(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int64), 4)
    assert torch.equal(out, torch.zeros(4, 3))
    out = tmasking._scatter_add(torch.ones(3), torch.tensor([1, 1, 9]), 4)
    assert out.tolist() == [0.0, 2.0, 0.0, 0.0]
