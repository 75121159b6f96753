"""Port parity: core/nns.py and core/nns_grid.py of open3d_tpu_torch
against open3d_tpu on the same seeded numpy inputs.

Bars: squared distances to rtol 1e-5 / atol 1e-6 (both packages form the
brute-force distance as |q|^2 + |t|^2 - 2 q.t from one float32 matmul,
whose additions the two libraries order differently); indices equal except
where the two winners' float64 distances lie within 1e-5 (relative) of each
other, a tie the two top-k / argmin orders may break apart; counts equal.
The grid's table and segments are equal. The banded 1-NN: the principal
axis equal up to sign (1e-6), the shortfall equal to the JAX package's, and
wherever no window was truncated the result is the exact 1-NN under
tests/test_nns.py's conditions, with `sel` equal to the gathered rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import nns as jnns
from open3d_tpu.core import nns_grid as jgrid
from open3d_tpu_torch.core import nns as tnns
from open3d_tpu_torch.core import nns_grid as tgrid

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _clouds(seed, n=1500, m=2000, scale=(1.0, 1.0, 1.0), drop=0.2):
    rng = np.random.default_rng(seed)
    s = np.asarray(scale, np.float32)
    q = (rng.uniform(-1, 1, (n, 3)) * s).astype(np.float32)
    t = (rng.uniform(-1, 1, (m, 3)) * s).astype(np.float32)
    mask = rng.uniform(size=m) > drop
    return q, t, mask


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def _d64(q, t, idx):
    """float64 squared distances of each query to its listed targets."""
    safe = np.maximum(idx, 0)
    return np.sum((q.astype(np.float64)[:, None, :] - t.astype(np.float64)[safe]) ** 2, axis=-1)


def _check_neighbours(q, t, ji, jd, ti, td):
    """Distances within the bars; indices equal but on near-ties."""
    ji, jd, ti, td = (np.asarray(x) for x in (ji, jd, ti.numpy(), td.numpy()))
    if ji.ndim == 1:
        ji, jd, ti, td = ji[:, None], jd[:, None], ti[:, None], td[:, None]
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    diff = (ti != ji) & (ji >= 0)
    dj, dt = _d64(q, t, ji), _d64(q, t, ti)
    tie = np.abs(dj - dt) <= 1e-5 * np.maximum(dj, dt) + 1e-12
    assert np.all(tie[diff]), f"{int((diff & ~tie).sum())} index mismatches off a tie"
    return int(diff.sum())


@pytest.mark.parametrize("k,chunks", [
    (1, {}), (8, {}), (8, dict(query_chunk=256, target_chunk=512)), (40, dict(target_chunk=300)),
])
def test_knn_search(k, chunks):
    q, t, m = _clouds(0)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    ji, jd = jnns.knn_search(jq, jt, k, jm, **chunks)
    ti, td = tnns.knn_search(tq, tt, k, tm, **chunks)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (len(q), k)
    # sorted ascending, invalid slots -1 with BIG (none here: k < valid count)
    assert bool((td[:, 1:] >= td[:, :-1]).all())
    _check_neighbours(q, t, ji, jd, ti, td)


def test_knn_search_more_neighbours_than_targets():
    q, t, m = _clouds(1, n=40, m=6, drop=0.4)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    ji, jd = jnns.knn_search(jq, jt, 10, jm)
    ti, td = tnns.knn_search(tq, tt, 10, tm)
    assert tuple(ti.shape) == (40, 6)
    np.testing.assert_array_equal(ti.numpy() < 0, np.asarray(ji) < 0)
    assert int((ti >= 0).sum(1).max()) == int(m.sum())
    ok = ti.numpy() >= 0
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunks", [{}, dict(query_chunk=128, target_chunk=256), dict(target_chunk=1999)])
def test_one_nn_search(chunks):
    q, t, m = _clouds(2)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    ji, jd = jnns.one_nn_search(jq, jt, jm, **chunks)
    ti, td = tnns.one_nn_search(tq, tt, tm, **chunks)
    assert ti.dtype == torch.int32 and tuple(td.shape) == (len(q),)
    _check_neighbours(q, t, ji, jd, ti, td)
    # the exact 1-NN by float64 brute force
    d64 = np.sum((q.astype(np.float64)[:, None] - t.astype(np.float64)[None]) ** 2, -1)
    d64[:, ~m] = np.inf
    np.testing.assert_allclose(_d64(q, t, ti.numpy()[:, None])[:, 0], d64.min(1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_knn", [1, 6])
def test_hybrid_search(max_knn):
    q, t, m = _clouds(3)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    a = jnns.hybrid_search(jq, jt, 0.12, max_knn, jm)
    b = tnns.hybrid_search(tq, tt, 0.12, max_knn, tm)
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    assert b[0].shape == (len(q), max_knn) and b[2].dtype == torch.int32
    _check_neighbours(q, t, a[0], a[1], b[0], b[1])
    assert bool((b[1][b[0] < 0] == 0).all())


def test_fixed_radius_search_and_facade():
    q, t, m = _clouds(4, n=600, m=900)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    a = jnns.fixed_radius_search(jq, jt, 0.15, 12, jm)
    b = tnns.fixed_radius_search(tq, tt, 0.15, 12, tm)
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    _check_neighbours(q, t, a[0], a[1], b[0], b[1])
    jf, tf = jnns.NearestNeighborSearch(jt, jm), tnns.NearestNeighborSearch(tt, tm)
    for ra, rb in [(jf.knn_search(jq, 5), tf.knn_search(tq, 5)),
                   (jf.hybrid_search(jq, 0.15, 5), tf.hybrid_search(tq, 0.15, 5)),
                   (jf.fixed_radius_search(jq, 0.15, 7), tf.fixed_radius_search(tq, 0.15, 7))]:
        _check_neighbours(q, t, ra[0], ra[1], rb[0], rb[1])
        if len(ra) == 3:
            np.testing.assert_array_equal(rb[2].numpy(), np.asarray(ra[2]))


def test_build_grid():
    _, t, m = _clouds(5)
    (jt, jm), (tt, tm) = _both(t, m)
    ga, gb = jgrid.build_grid(jt, 0.1, jm), tgrid.build_grid(tt, 0.1, tm)
    for f in ("table", "seg_start", "seg_count"):
        np.testing.assert_array_equal(getattr(gb, f).numpy(), np.asarray(getattr(ga, f)), err_msg=f)
    # each cell's rows, as a set (the JAX sort does not promise their order)
    live = gb.seg_count.numpy() > 0
    ja, tb = np.asarray(ga.order), gb.order.numpy()
    for s, c in zip(gb.seg_start.numpy()[live], gb.seg_count.numpy()[live]):
        assert sorted(ja[s:s + c]) == sorted(tb[s:s + c])
    np.testing.assert_array_equal(gb.points_sorted.numpy(), t[tb])
    assert gb.cell_size == 0.1 and int(gb.seg_count.sum()) == int(m.sum())


@pytest.mark.parametrize("max_nn,max_per_cell", [(1, 32), (8, 64), (8, 4)])
def test_query_grid(max_nn, max_per_cell):
    q, t, m = _clouds(6)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    ga, gb = jgrid.build_grid(jt, 0.1, jm), tgrid.build_grid(tt, 0.1, tm)
    a = jgrid.query_grid(ga, jq, 0.1, max_nn, max_per_cell, query_chunk=512)
    b = tgrid.query_grid(gb, tq, 0.1, max_nn, max_per_cell, query_chunk=512)
    if max_per_cell >= 32:  # no cell is capped: the order within a cell cannot matter
        np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
        _check_neighbours(q, t, a[0], a[1], b[0], b[1])
    else:  # capped cells: each package's neighbours are true ones, within the radius
        ok = b[0].numpy() >= 0
        np.testing.assert_allclose(_d64(q, t, b[0].numpy())[ok], b[1].numpy()[ok], rtol=1e-5, atol=1e-7)
        assert float(b[1].max()) <= 0.1**2 * (1 + 1e-6)
        assert abs(int(b[2].sum()) - int(np.asarray(a[2]).sum())) <= 0.05 * int(np.asarray(a[2]).sum())
    with pytest.raises(ValueError, match="cell size"):
        tgrid.query_grid(gb, tq, 0.2, max_nn)


def test_hybrid_search_grid_and_routing():
    q, t, m = _clouds(7)
    (jq, jt, jm), (tq, tt, tm) = _both(q, t, m)
    a = jgrid.hybrid_search_grid(jq, jt, 0.1, 8, jm, max_per_cell=64)
    b = tgrid.hybrid_search_grid(tq, tt, 0.1, 8, tm, max_per_cell=64)
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    _check_neighbours(q, t, a[0], a[1], b[0], b[1])
    # hybrid_search routes a target of grid_threshold points or more to the grid
    c = tnns.hybrid_search(tq, tt, 0.1, 8, tm, grid_threshold=len(t), max_per_cell=64)
    for x, y in zip(b, c):
        assert torch.equal(x, y)
    exact = tnns.hybrid_search(tq, tt, 0.1, 8, tm, grid_threshold=None)
    np.testing.assert_array_equal(exact[2].numpy(), b[2].numpy())


@pytest.mark.parametrize("window", [2048, 256])
def test_banded_one_nn(window):
    """An elongated cloud (a well-conditioned principal axis): both packages
    sort alike. At W = 2048 no window is truncated; at W = 256 most are, and
    the shortfall is the JAX package's."""
    q, t, m = _clouds(8, n=3000, m=4000, scale=(3.0, 1.0, 0.3))
    extras = np.random.default_rng(9).normal(size=(len(t), 3)).astype(np.float32)
    (jt, jm, je), (tt, tm, te) = _both(t, m, extras)
    bj = jnns.banded_build(jt, jm, je, window=window)
    bt = tnns.banded_build(tt, tm, te, window=window)
    assert set(bt) == {"axis", "kt", "A", "window"} and bt["window"] == window
    sign = float(np.sign(np.dot(np.asarray(bj["axis"]), bt["axis"].numpy())))
    np.testing.assert_allclose(sign * bt["axis"].numpy(), np.asarray(bj["axis"]), atol=1e-6)
    kt_t, kt_j = bt["kt"].numpy(), np.asarray(bj["kt"])
    assert int((kt_t < 1e38).sum()) == int((kt_j < 1e38).sum()) == int(m.sum())
    np.testing.assert_allclose(np.sort(sign * kt_t[kt_t < 1e38]), kt_j[kt_j < 1e38], rtol=0, atol=1e-5)
    assert tuple(bt["A"].shape) == (max(4096, window), 3 + 3 + 1)

    order = np.argsort(tnns.banded_query_key(bt, torch.from_numpy(q)).numpy(), kind="stable")
    qs = q[order]
    jq, tq = jnp.asarray(qs), torch.from_numpy(qs)
    a = jnns.banded_one_nn(bj, jq, 0.05)
    idx_b, d2_b, sel, short = tnns.banded_one_nn(bt, tq, 0.05)
    assert idx_b.dtype == torch.int32 and short.dtype == torch.int32
    assert int(short) == int(a[3])
    assert (int(short) == 0) == (window == 2048)

    ok = idx_b.numpy() >= 0
    ib = idx_b.numpy()[ok]
    # sel is the winner's row of A, exactly
    np.testing.assert_array_equal(sel.numpy()[ok, :3], t[ib])
    np.testing.assert_array_equal(sel.numpy()[ok, 3:6], extras[ib])
    np.testing.assert_array_equal(sel.numpy()[ok, 6].astype(np.int64), ib)
    np.testing.assert_array_equal(d2_b.numpy()[ok], np.sum((qs[ok] - t[ib]) ** 2, axis=1,
                                                           dtype=np.float32))
    if window == 2048:
        # no window truncated: the exact 1-NN, as tests/test_nns.py holds it
        idx_e, d2_e = tnns.one_nn_search(tq, tt, tm)
        valid_e = ((idx_e >= 0) & (d2_e <= 0.05**2)).numpy()
        assert np.array_equal(valid_e, ok)
        agree = np.where(valid_e, idx_e.numpy(), -1) == idx_b.numpy()
        d2_ok = d2_b.numpy() <= d2_e.numpy() * (1 + 1e-5) + 1e-12
        assert np.all(agree | (valid_e & d2_ok))
        # and the JAX package's banded winners, but on near-ties (its d2 is
        # taken from a bf16 hi/lo reconstruction of the row, so not compared)
        ja = np.asarray(a[0])
        np.testing.assert_array_equal(ja >= 0, ok)
        diff = ja != idx_b.numpy()
        dj, dt = _d64(qs, t, ja[:, None])[:, 0], _d64(qs, t, idx_b.numpy()[:, None])[:, 0]
        assert np.all((np.abs(dj - dt) <= 1e-5 * np.maximum(dj, dt) + 1e-12)[diff])
