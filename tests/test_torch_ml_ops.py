"""Port parity for ml/ops.py: the 18 cases of tests/test_ml_ops.py on the
port (their assertions, their inputs), then each op on the same numpy
inputs made from a seed through open3d_tpu and open3d_tpu_torch (voxelize
and sparse_conv under jax.jit, which compiles them in seconds where their
eager ops take 10-15 s).

Bars:
- integer outputs (voxelize, voxel_pooling's order and mask, ball_query,
  three_nn, invert_neighbors_list, nms, roi_pool's hits) equal; the inputs
  are drawn so that no two distances tie;
- float outputs within float32 rounding of a different summation order:
  voxel means, three_interpolate, the CSR sums and trilinear_devoxelize
  1e-6 relative; the IoUs 1e-5 absolute (the port adds a polygon's shoelace
  terms in vertex order); sparse_conv 1e-5 relative (cuBLAS-free float32
  products of 27 offsets);
- continuous_conv, which sums by filter cell before the contraction (the
  JAX package contracts a gathered filter slice per neighbour), within
  2e-5 of the output's largest magnitude, and so are its gradients for the
  features and the weights against jax.grad; trilinear_devoxelize's
  gradient 1e-6;
- the re-ordered continuous_conv against a literal port of the reference's
  (M, max_nn, Cin, Cout) gather at a small size, within 2e-5 likewise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.ml import ops as jops
from open3d_tpu_torch.core import nns as tnns
from open3d_tpu_torch.ml import ops

torch.set_num_threads(2)
T = torch.as_tensor


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---- tests/test_ml_ops.py's cases on the port ----------------------------

def test_voxelize_groups_points():
    pts = T([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [1.5, 0.1, 0.1], [9.9, 9.9, 9.9]])
    coords, vpi, counts, nv = ops.voxelize(pts, 1.0, [0, 0, 0], [3, 3, 3],
                                           max_points_per_voxel=8, max_voxels=16)
    nv = int(nv)
    assert nv == 2  # the far point is out of range
    c = coords[:nv].numpy()
    assert {tuple(r) for r in c.tolist()} == {(0, 0, 0), (1, 0, 0)}
    assert sorted(counts[:nv].tolist()) == [1, 2]
    row = int(np.nonzero((c == [0, 0, 0]).all(1))[0][0])
    assert set(vpi[row].tolist()) - {-1} == {0, 1}


def test_voxel_pooling_average():
    pts = T([[0.1, 0, 0], [0.3, 0, 0], [5.0, 0, 0]])
    feat = T([[1.0], [3.0], [10.0]])
    pos, f, valid = ops.voxel_pooling(pts, feat, 1.0, max_voxels=8)
    assert int(valid.sum()) == 2
    np.testing.assert_allclose(np.sort(f[valid].numpy().ravel()), [2.0, 10.0])


def test_ball_query_fill_convention():
    pts = T([[0, 0, 0], [0.1, 0, 0], [5, 5, 5]], dtype=torch.float32)
    q = T([[0.0, 0, 0], [9.0, 9, 9]])
    idx, cnt = ops.ball_query(pts, q, radius=0.5, nsample=4)
    assert int(cnt[0]) == 2
    assert set(idx[0].tolist()) == {0, 1}  # empty slots repeat the first found
    assert (idx[1] == -1).all() and int(cnt[1]) == 0


def test_three_nn_interpolate_exact_at_point():
    pts = T([[0, 0, 0], [1, 0, 0], [0, 1, 0], [4, 4, 4]], dtype=torch.float32)
    feat = T([[1.0], [2.0], [3.0], [9.0]])
    q = T([[0, 0, 0], [0.5, 0.5, 0]], dtype=torch.float32)
    idx, w = ops.three_nn(q, pts)
    out = ops.three_interpolate(feat, idx, w).numpy()
    assert abs(out[0, 0] - 1.0) < 1e-3  # coincident: the weight collapses to point 0
    assert 1.0 < out[1, 0] < 3.0


def test_reduce_subarrays_sum_and_ragged():
    vals = T([1.0, 2, 3, 4, 5, 6])
    rs = T([0, 2, 2, 6])
    np.testing.assert_allclose(ops.reduce_subarrays_sum(vals, rs).numpy(), [3.0, 0.0, 18.0])
    dense = ops.ragged_to_dense(vals, rs, 3, -1.0).numpy()
    np.testing.assert_allclose(dense[0], [1, 2, -1])
    np.testing.assert_allclose(dense[1], [-1, -1, -1])
    np.testing.assert_allclose(dense[2], [3, 4, 5])  # capped at 3


def test_invert_neighbors_list():
    # point0 -> [1, 2]; point1 -> [2]; point2 -> []
    inv, cnt = ops.invert_neighbors_list(3, T([1, 2, 2], dtype=torch.int32), T([0, 2, 3, 3]), k=4)
    assert set(inv[1].tolist()) - {-1} == {0}
    assert set(inv[2].tolist()) - {-1} == {0, 1}
    assert (inv[0] == -1).all()
    np.testing.assert_array_equal(cnt.numpy(), [0, 1, 2])


def test_iou_bev_axis_aligned():
    a = T([[0, 0, 2, 2, 0.0]])
    b = T([[1, 0, 2, 2, 0.0], [0, 0, 2, 2, 0.0], [10, 0, 2, 2, 0.0]])
    np.testing.assert_allclose(ops.iou_bev(a, b)[0].numpy(), [2.0 / 6.0, 1.0, 0.0], atol=1e-5)


def test_iou_bev_rotated():
    a = T([[0, 0, 1, 1, 0.0]])
    b = T([[0, 0, 1, 1, np.pi / 4]], dtype=torch.float32)
    inter = 2 * (np.sqrt(2) - 1)
    assert abs(float(ops.iou_bev(a, b)[0, 0]) - inter / (2 - inter)) < 1e-3


def test_iou_3d():
    a = T([[0, 0, 0, 2, 2, 2, 0.0]])
    b = T([[0, 1, 0, 2, 2, 2, 0.0]])
    np.testing.assert_allclose(float(ops.iou_3d(a, b)[0, 0]), 4.0 / 12.0, atol=1e-5)


def test_nms_suppresses_overlaps():
    boxes = T([[0, 0, 2, 2, 0.0], [0.1, 0, 2, 2, 0.0], [5, 5, 2, 2, 0.0]])
    keep = ops.nms(boxes, T([0.9, 0.8, 0.7]), iou_threshold=0.5)
    np.testing.assert_array_equal(keep.numpy(), [True, False, True])


def test_continuous_conv_constant_filter_is_masked_mean():
    rng = np.random.default_rng(0)
    pts = T(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    feat = T(rng.normal(size=(64, 2)).astype(np.float32))
    w = torch.ones((3, 3, 3, 2, 2)) * torch.eye(2)  # identity per tap
    out = ops.continuous_conv(feat, pts, pts[:8], w, extents=0.8, max_nn=32)
    assert tuple(out.shape) == (8, 2)
    assert torch.isfinite(out).all()
    assert out.abs().max() < 10.0


def test_continuous_conv_grad_flows():
    pts = T(np.random.default_rng(1).uniform(-1, 1, (32, 3)).astype(np.float32))
    feat = torch.ones((32, 1))
    w = (torch.ones((3, 3, 3, 1, 1)) * 0.1).requires_grad_()
    (ops.continuous_conv(feat, pts, pts[:4], w, extents=1.0, max_nn=16) ** 2).sum().backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


def test_sparse_conv_identity_kernel():
    coords = T([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=torch.int32)
    feat = T([[1.0, 2], [3, 4], [5, 6]])
    w = torch.zeros((3, 3, 3, 2, 2))
    w[1, 1, 1] = torch.eye(2)
    np.testing.assert_allclose(ops.sparse_conv(feat, coords, w).numpy(), feat.numpy(), atol=1e-6)


def test_sparse_conv_neighbor_sum():
    coords = T([[0, 0, 0], [1, 0, 0], [2, 0, 0]], dtype=torch.int32)
    out = ops.sparse_conv(torch.ones((3, 1)), coords, torch.ones((3, 3, 3, 1, 1)))
    np.testing.assert_allclose(out.numpy().ravel(), [2.0, 3.0, 2.0], atol=1e-6)


def test_roi_pool_inside_outside():
    pts = T([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 0.0, 0.9]])
    feats = torch.arange(4, dtype=torch.float32)[:, None]
    pooled, empty = ops.roi_pool(pts, feats, T([[0, 0, 0, 1.0, 1.0, 1.0, 0.0]]),
                                 num_sampled_points=8)
    assert not bool(empty[0])
    got = set(pooled[0, :, 3].tolist())
    assert 0.0 in got and 1.0 in got  # the two inside points
    assert 2.0 not in got and 3.0 not in got  # x = 2 outside, z = 0.9 above the half-height
    boxes_r = T([[0, 0, 0, 0.5, 5.0, 1.0, np.pi / 2]], dtype=torch.float32)
    pooled_r, _ = ops.roi_pool(pts, feats, boxes_r, num_sampled_points=8)
    assert 2.0 in set(pooled_r[0, :, 3].tolist())  # the long axis now covers x


def test_roi_pool_empty_box():
    pooled, empty = ops.roi_pool(torch.zeros((4, 3)), torch.zeros((4, 2)),
                                 T([[10, 10, 10, 1, 1, 1, 0.3]]), num_sampled_points=4)
    assert bool(empty[0]) and float(pooled.abs().max()) == 0.0


def test_trilinear_devoxelize_matches_manual():
    R, C = 4, 2
    vox = np.random.default_rng(0).normal(size=(C, R, R, R)).astype(np.float32)
    out, idx, w = ops.trilinear_devoxelize(T(vox), T([[1.25, 2.5, 0.75], [0.0, 0.0, 0.0]]), R)
    assert tuple(out.shape) == (2, C) and tuple(idx.shape) == (2, 8) and tuple(w.shape) == (2, 8)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    p = np.asarray([1.25, 2.5, 0.75])
    g0 = np.floor(p).astype(int)
    f = p - g0
    expect = np.zeros(C)
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        wt = (f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1]) * (f[2] if dz else 1 - f[2])
        expect += wt * vox[:, g0[0] + dx, g0[1] + dy, g0[2] + dz]
    np.testing.assert_allclose(out[0].numpy(), expect, rtol=1e-5)


def test_trilinear_devoxelize_grad_flows():
    vox = torch.ones((1, 3, 3, 3), requires_grad=True)
    out, _, _ = ops.trilinear_devoxelize(vox, T([[1.2, 1.3, 0.4]]), 3)
    (out**2).sum().backward()
    assert float(vox.grad.abs().sum()) > 0


# ---- the port against the JAX package on the same inputs ------------------

def _cloud(n, seed, scale=1.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


def test_voxelize_parity():
    pts = _cloud(3000, 1)
    pts[::7] *= 3.0  # some outside the range
    args = (0.25, [-1, -1, -1], [1, 1, 1])
    kw = dict(max_points_per_voxel=6, max_voxels=100)  # both caps bind
    got = ops.voxelize(T(pts), *args, **kw)
    want = jax.jit(lambda p: jops.voxelize(p, *args, **kw))(jnp.asarray(pts))
    assert int(want[3]) == 100 and int((want[2] == 6).sum()) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("position_fn,feature_fn", [("average", "average"), ("center", "max"),
                                                    ("nearest_neighbor", "min")])
def test_voxel_pooling_parity(position_fn, feature_fn):
    pts = _cloud(2000, 2)
    feat = np.random.default_rng(3).normal(size=(2000, 5)).astype(np.float32)
    for cap in (4096, 40):  # every voxel kept; the cap cuts the lexicographic order
        got = ops.voxel_pooling(T(pts), T(feat), 0.3, position_fn, feature_fn, max_voxels=cap)
        want = jops.voxel_pooling(jnp.asarray(pts), jnp.asarray(feat), 0.3, position_fn,
                                  feature_fn, max_voxels=cap)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_neighbourhood_parity():
    pts, q = _cloud(1500, 4), _cloud(200, 5)
    feat = np.random.default_rng(6).normal(size=(1500, 7)).astype(np.float32)
    for g, w in zip(ops.ball_query(T(pts), T(q), 0.3, 16),
                    jops.ball_query(jnp.asarray(pts), jnp.asarray(q), 0.3, 16)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # d2 is |q|^2 + |t|^2 - 2 q.t in float32 in both packages, each within
    # 1e-6 of the exact value here (|q|^2 + |t|^2 <= 6); three_nn's weights
    # 1/d2 magnify that by up to 2e-6 / d2 relative
    for g, w in zip(ops.knn_search(T(q), T(pts), 5), jops.knn_search(jnp.asarray(q),
                                                                       jnp.asarray(pts), 5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for g, w in zip(ops.fixed_radius_search(T(q), T(pts), 0.2, 12),
                    jops.fixed_radius_search(jnp.asarray(q), jnp.asarray(pts), 0.2, 12)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    idx, wt = ops.three_nn(T(q), T(pts))
    jidx, jwt = jops.three_nn(jnp.asarray(q), jnp.asarray(pts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    d2 = np.asarray(jops.knn_search(jnp.asarray(q), jnp.asarray(pts), 3)[1])
    np.testing.assert_allclose(wt.numpy(), np.asarray(jwt), rtol=2e-6 / d2.min())
    out = ops.three_interpolate(T(feat), idx, wt)  # on the same weights: the op alone
    assert _rel(out, jops.three_interpolate(jnp.asarray(feat), jnp.asarray(idx.numpy()),
                                            jnp.asarray(wt.numpy()))) < 1e-6


def _csr(seed, n_rows=40, n_points=60):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 9, n_rows)
    splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return rng.integers(0, n_points, splits[-1]).astype(np.int32), splits


def test_csr_helpers_parity():
    nbr, splits = _csr(7)
    vals = np.random.default_rng(8).normal(size=(nbr.shape[0], 3)).astype(np.float32)
    got = ops.reduce_subarrays_sum(T(vals), T(splits))
    assert _rel(got, jops.reduce_subarrays_sum(jnp.asarray(vals), jnp.asarray(splits))) < 1e-6
    for g, w in zip(ops.invert_neighbors_list(60, T(nbr), T(splits), k=3),
                    jops.invert_neighbors_list(60, jnp.asarray(nbr), jnp.asarray(splits), k=3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for v in (vals, nbr):
        np.testing.assert_array_equal(ops.ragged_to_dense(T(v), T(splits), 5, -7).numpy(),
                                      np.asarray(jops.ragged_to_dense(jnp.asarray(v),
                                                                      jnp.asarray(splits), 5, -7)))


def _boxes(n, seed, dims=5):
    """(x, z, dx, dz, yaw) boxes, or (x, y, z, dx, dy, dz, yaw) for dims 7."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-3, 3, (n, (dims - 1) // 2))
    size = rng.uniform(0.5, 2.0, (n, (dims - 1) // 2))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([centre, size, yaw], 1).astype(np.float32)


def test_boxes_parity():
    # one shape throughout, so the JAX package compiles its clip once
    a, b = _boxes(24, 9), _boxes(24, 10)
    a[3] = b[4]  # one identical pair, one contained pair
    a[5, :2], a[5, 2:4], a[5, 4] = b[6, :2], b[6, 2:4] * 0.5, b[6, 4]
    bev = ops.iou_bev(T(a), T(b))
    jbev = np.asarray(jops.iou_bev(jnp.asarray(a), jnp.asarray(b)))
    assert (jbev > 0).sum() > 20 and abs(float(bev[3, 4]) - 1.0) < 1e-5
    np.testing.assert_allclose(bev.numpy(), jbev, atol=1e-5, rtol=0)
    a3, b3 = _boxes(24, 11, 7), _boxes(24, 12, 7)
    np.testing.assert_allclose(ops.iou_3d(T(a3), T(b3)).numpy(),
                               np.asarray(jops.iou_3d(jnp.asarray(a3), jnp.asarray(b3))),
                               atol=1e-5, rtol=0)
    scores = np.random.default_rng(13).permutation(24).astype(np.float32)
    keep = ops.nms(T(a), T(scores), 0.1)
    jkeep = np.asarray(jops.nms(jnp.asarray(a), jnp.asarray(scores), 0.1))
    assert 0 < jkeep.sum() < 24
    np.testing.assert_array_equal(keep.numpy(), jkeep)


def _cconv_inputs(seed, n=160, m=48, cin=3, cout=4, k=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, cin)).astype(np.float32), _cloud(n, seed + 1),
            _cloud(m, seed + 2), rng.normal(size=(k, k, k, cin, cout)).astype(np.float32))


def _literal_cconv(features, points, queries, weights, extents, max_nn):
    """The reference's continuous_conv term for term, in torch: the
    (M, max_nn, Cin, Cout) filter gather of each corner."""
    kx, ky, kz, cin, cout = weights.shape
    ext = torch.full((3,), float(extents))
    idx, _, cnt = tnns.hybrid_search(queries, points, float(extents) * 0.5 * 3**0.5, max_nn)
    safe = idx.clamp(min=0).long()
    rel = (points[safe] - queries[:, None]) / (ext * 0.5)
    inbox = (rel.abs() <= 1).all(-1) & (idx >= 0)
    r = rel.norm(dim=-1, keepdim=True)
    scale = torch.where(r > 1e-8, rel.abs().amax(-1, keepdim=True) / r.clamp(min=1e-8), 1.0)
    grid = (rel * scale + 1) * 0.5 * torch.tensor([kx - 1, ky - 1, kz - 1], dtype=torch.float32)
    g0 = grid.floor().long()
    frac = grid - g0
    feat = torch.where(inbox[..., None], features[safe], 0.0)
    wflat = weights.reshape(-1, cin, cout)
    out = torch.zeros((queries.shape[0], cout))
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        gi = torch.minimum((g0 + torch.tensor([dx, dy, dz])).clamp(min=0),
                           torch.tensor([kx - 1, ky - 1, kz - 1]))
        w8 = ((frac[..., 0] if dx else 1 - frac[..., 0]) * (frac[..., 1] if dy else 1 - frac[..., 1])
              * (frac[..., 2] if dz else 1 - frac[..., 2]))
        wsel = wflat[(gi[..., 0] * ky + gi[..., 1]) * kz + gi[..., 2]]  # (M, k, Cin, Cout)
        assert tuple(wsel.shape) == (queries.shape[0], idx.shape[1], cin, cout)
        out = out + torch.einsum("mkc,mkco->mo", feat * w8[..., None], wsel)
    return out / cnt.clamp(min=1)[:, None]


def test_continuous_conv_reordered_against_the_literal_gather():
    f, p, q, w = _cconv_inputs(14)
    got = ops.continuous_conv(T(f), T(p), T(q), T(w), 0.9, max_nn=24)
    want = _literal_cconv(T(f), T(p), T(q), T(w), 0.9, 24)
    assert want.abs().max() > 0.1
    assert _rel(got, want) < 2e-5


def test_continuous_conv_parity_and_grads():
    f, p, q, w = _cconv_inputs(15, cin=4, cout=5, k=4)
    tf, tw = T(f).requires_grad_(), T(w).requires_grad_()
    out = ops.continuous_conv(tf, T(p), T(q), tw, 0.8, max_nn=20)
    jout = jops.continuous_conv(jnp.asarray(f), jnp.asarray(p), jnp.asarray(q), jnp.asarray(w),
                                0.8, max_nn=20)
    assert _rel(out, jout) < 2e-5
    (out**2).sum().backward()

    def loss(feat, wt):
        return jnp.sum(jops.continuous_conv(feat, jnp.asarray(p), jnp.asarray(q), wt, 0.8,
                                            max_nn=20) ** 2)

    gf, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(w))
    assert np.abs(np.asarray(gf)).max() > 0 and np.abs(np.asarray(gw)).max() > 0
    assert _rel(tf.grad, gf) < 2e-5 and _rel(tw.grad, gw) < 2e-5
    # repeats give the same bits (every scatter-add is the sorted one)
    tf2 = T(f).requires_grad_()
    (ops.continuous_conv(tf2, T(p), T(q), tw.detach(), 0.8, max_nn=20) ** 2).sum().backward()
    assert torch.equal(tf2.grad, tf.grad)


def test_sparse_conv_parity():
    rng = np.random.default_rng(16)
    coords = np.unique(rng.integers(-6, 6, (300, 3)), axis=0).astype(np.int32)
    feat = rng.normal(size=(coords.shape[0], 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4, 6)).astype(np.float32)
    # queries: the input coordinates and points off them
    queries = np.concatenate([coords, rng.integers(-7, 7, (50, 3))]).astype(np.int32)
    got = ops.sparse_conv(T(feat), T(coords), T(w), T(queries))
    want = jax.jit(jops.sparse_conv)(jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(w),
                                     jnp.asarray(queries))
    assert _rel(got, want) < 1e-5


def test_roi_pool_and_devoxelize_parity():
    pts = _cloud(800, 17, 2.0)
    feat = np.random.default_rng(18).normal(size=(800, 3)).astype(np.float32)
    boxes = np.concatenate([_cloud(10, 19), np.random.default_rng(20).uniform(0.5, 2, (10, 3)),
                            np.random.default_rng(21).uniform(-3, 3, (10, 1))], 1).astype(np.float32)
    boxes[0, :3] = 50.0  # an empty box
    got = ops.roi_pool(T(pts), T(feat), T(boxes), 16)
    want = jops.roi_pool(jnp.asarray(pts), jnp.asarray(feat), jnp.asarray(boxes), 16)
    hits = np.asarray(jnp.sum(jnp.any(want[0] != want[0][:, :1], -1), -1)) + 1
    assert (hits == 16).any() and ((hits > 1) & (hits < 16)).any()  # cut boxes and padded ones
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))

    R, C = 6, 5
    vox = np.random.default_rng(22).normal(size=(C, R, R, R)).astype(np.float32)
    xyz = np.random.default_rng(23).uniform(-0.5, R - 0.5, (300, 3)).astype(np.float32)
    tv = T(vox).requires_grad_()
    out, idx, wt = ops.trilinear_devoxelize(tv, T(xyz), R)
    jout, jidx, jwt = jops.trilinear_devoxelize(jnp.asarray(vox), jnp.asarray(xyz), R)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(jwt), rtol=1e-6, atol=1e-7)
    assert _rel(out, jout) < 1e-6
    (out**2).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jops.trilinear_devoxelize(v, jnp.asarray(xyz), R)[0] ** 2))(
        jnp.asarray(vox))
    assert _rel(tv.grad, g) < 1e-6
