"""Nearest-neighbour search (port of open3d_tpu/core/nns.py).

Open3D's NearestNeighborSearch (KnnSearch, FixedRadiusSearch, HybridSearch)
as tiled brute force: a (query chunk x target chunk) distance tile is
|q|^2 + |t|^2 - 2 q.t, the cross term one float32 matmul, and a running
top-k (or argmin) merges the tiles. Neither the tile nor the whole distance
matrix is ever larger than one chunk pair.

All functions take fixed-capacity inputs whose invalid rows are parked at
FAR_COORD, and return int32 indices, float32 squared distances and, for the
hybrid search, a per-query count, with idx = -1 where no neighbour
qualifies: Open3D's HybridSearch contract.

The expanded distance is exact to float32 only while the matmul is: the
port never enables TF32 (torch.backends.cuda.matmul.allow_tf32 stays
False), so the card's products round as float32 products.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.core import linalg

_BIG = 3.0e38


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _dot3(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """p (..., 3) . a (3,) as elementwise products and two adds, which round
    alike on every device (a matmul's order of additions does not)."""
    return p[..., 0] * a[0] + p[..., 1] * a[1] + p[..., 2] * a[2]


def _sq3(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over a last axis of 3, summed x, y, z in that order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _dist2_tile(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(Qc, D), (Tc, D) -> (Qc, Tc) squared distances by one float32 matmul."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    tn = torch.sum(t * t, dim=-1)[None, :]
    return torch.clamp(qn + tn - 2.0 * (q @ t.T), min=0.0)


def _target_tiles(target, target_mask, tc: int):
    """Target rows and mask padded to a multiple of tc (padding masked out)."""
    M = target.shape[0]
    m_pad = -(-M // tc) * tc
    tp = _pad_rows(target.to(torch.float32), m_pad, 0.0)
    tmask = torch.ones(M, dtype=torch.bool, device=target.device) if target_mask is None else target_mask
    return tp, _pad_rows(tmask, m_pad, False), m_pad


def knn_search(
    query: torch.Tensor,
    target: torch.Tensor,
    k: int,
    target_mask: torch.Tensor | None = None,
    query_chunk: int = 4096,
    target_chunk: int = 8192,
):
    """Exact k-NN. Returns (indices (N, k) int32, dist2 (N, k) f32) sorted
    ascending; slots beyond the number of valid targets get idx=-1,
    dist2=BIG. Equal distances may come in another order than the JAX
    package's top_k gives them."""
    N = query.shape[0]
    M = target.shape[0]
    k = int(min(k, M))
    qc = int(min(query_chunk, N))
    tc = int(min(target_chunk, M))
    tp, tmask, m_pad = _target_tiles(target, target_mask, tc)
    q = query.to(torch.float32)
    dev = query.device
    out_d, out_i = [], []
    for s in range(0, N, qc):
        qt = q[s:s + qc]
        best_d = torch.full((qt.shape[0], k), _BIG, dtype=torch.float32, device=dev)
        best_i = torch.full((qt.shape[0], k), -1, dtype=torch.int32, device=dev)
        for t0 in range(0, m_pad, tc):
            d2 = torch.where(tmask[None, t0:t0 + tc], _dist2_tile(qt, tp[t0:t0 + tc]), _BIG)
            idx = torch.arange(t0, t0 + tc, dtype=torch.int32, device=dev)
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, idx.expand(qt.shape[0], tc)], dim=1)
            best_d, sel = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cat_i, 1, sel)
        out_d.append(best_d)
        out_i.append(torch.where(best_d >= _BIG, -1, best_i))
    return torch.cat(out_i), torch.cat(out_d)


def one_nn_search(
    query: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    query_chunk: int = 8192,
    target_chunk: int = 8192,
):
    """1-NN (the ICP inner loop): a running argmin over target tiles, the
    lowest index winning a tie. Returns (idx (N,) int32, dist2 (N,) f32)."""
    N = query.shape[0]
    M = target.shape[0]
    qc = int(min(query_chunk, N))
    tc = int(min(target_chunk, M))
    tp, tmask, m_pad = _target_tiles(target, target_mask, tc)
    q = query.to(torch.float32)
    dev = query.device
    out_d, out_i = [], []
    for s in range(0, N, qc):
        qt = q[s:s + qc]
        best_d = torch.full((qt.shape[0],), _BIG, dtype=torch.float32, device=dev)
        best_i = torch.full((qt.shape[0],), -1, dtype=torch.int32, device=dev)
        for t0 in range(0, m_pad, tc):
            d2 = torch.where(tmask[None, t0:t0 + tc], _dist2_tile(qt, tp[t0:t0 + tc]), _BIG)
            dmin, imin = torch.min(d2, dim=1)
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, imin.to(torch.int32) + t0, best_i)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_i), torch.cat(out_d)


# ---------------------------------------------------------------------------
# Sorted-band 1-NN (the ICP correspondence search on large clouds)
# ---------------------------------------------------------------------------
#
# build: project the target onto its principal axis and sort it once,
#        carrying the attribute columns the caller needs (positions, normals,
#        original row, ...) in one sorted (Mp, C) matrix;
# query: queries come in tiles of Q spatially sorted rows. Every target
#        within dmax of a tile's queries lies in a contiguous run of the
#        sorted keys, found by two binary searches; a W-row window of the
#        matrix around that run is searched exhaustively, and the winner's
#        row is gathered exactly. `shortfall` is the largest number of run
#        rows a window left out (0: no tile was truncated).


def banded_build(
    target: torch.Tensor,
    target_mask: torch.Tensor | None,
    attrs: torch.Tensor | None = None,
    window: int = 4096,
):
    """Sort `target` along its principal axis; returns the banded index, a
    dict of the axis (3,), the sorted keys `kt` (Mp,), the sorted rows `A`
    (Mp, 3 + K + 1) = [positions | attrs | original row] and `window`.

    attrs: optional (M, K) extra columns (normals, intensities, ...). The
    original row is exact in float32 (M < 2^24). Masked rows sit at +1e9
    (a squared distance of ~1e18 never passes a dmax gate) and sort last;
    the rows are padded to a multiple of 256 and at least `window`."""
    M = target.shape[0]
    dev = target.device
    mask = torch.ones(M, dtype=torch.bool, device=dev) if target_mask is None else target_mask
    pos = torch.where(mask[:, None], target.to(torch.float32), 1e9)
    # the principal axis of the valid points: the covariance is summed in
    # float64, so the card and the CPU round it to the same float32 matrix
    p64 = pos.to(torch.float64)
    nv = torch.clamp(mask.to(torch.float64).sum(), min=1.0)
    mu = torch.where(mask[:, None], p64, 0.0).sum(0) / nv
    d = torch.where(mask[:, None], p64 - mu, 0.0)
    cov = (d.T @ d / nv).to(torch.float32)
    _, evecs = linalg.eigh3x3(cov)  # ascending eigenvalues
    axis = evecs[:, 2]
    key = torch.where(mask, _dot3(pos, axis), _BIG)
    perm = torch.argsort(key, stable=True)
    cols = [pos, torch.arange(M, dtype=torch.float32, device=dev)[:, None]]
    if attrs is not None:
        cols.insert(1, attrs.to(torch.float32).reshape(M, -1))
    A = torch.cat(cols, dim=1)[perm]
    kt = key[perm]
    Mp = max(-(-M // 256) * 256, int(window))
    if Mp > M:
        A = _pad_rows(A, Mp, 1e9)
        kt = _pad_rows(kt, Mp, _BIG)
    return {"axis": axis, "kt": kt, "A": A, "window": int(window)}


def banded_query_key(banded, query: torch.Tensor) -> torch.Tensor:
    return _dot3(query.to(torch.float32), banded["axis"])


def banded_one_nn(
    banded,
    query: torch.Tensor,
    dmax: float,
    tile: int = 512,
    qmask: torch.Tensor | None = None,
):
    """1-NN of each query against the banded target.

    Queries must come in spatially coherent order (sorted once by
    `banded_query_key`; the band stays valid across small pose updates).
    Returns (idx (N,) int32 original target rows, -1 where none lies within
    dmax; d2 (N,) f32 squared distance to the selected target; sel (N, C)
    the selected target's row of A; shortfall () int32, the largest window
    deficit, 0 when no tile's candidate run was truncated).

    The window starts on a multiple of 256 and is W rows wide, centred on
    the tile's run [lo, hi) as in the JAX package, so the same candidates
    are examined. The argmin is exact and takes the lowest window row on a
    tie; the JAX package packs the row into cleared low mantissa bits, so
    the two pick different winners only where two candidates' d2 lie within
    2^-12 of each other (relative)."""
    N = query.shape[0]
    W = banded["window"]
    A = banded["A"]
    C = A.shape[1]
    Q = int(min(tile, N))
    n_pad = -(-N // Q) * Q
    T = n_pad // Q
    dev = query.device
    qf = _pad_rows(query.to(torch.float32), n_pad, 1e9)
    qp = qf.reshape(T, Q, 3)
    kt = banded["kt"]
    Mp = kt.shape[0]
    kq = banded_query_key(banded, qf).reshape(T, Q)
    if qmask is None:
        qmask = torch.ones(N, dtype=torch.bool, device=dev)
    # padded and masked queries are left out of the span: their key is
    # 1e9 times the axis' component sum, which can land anywhere
    ok = _pad_rows(qmask, n_pad, False).reshape(T, Q)
    kmin = torch.where(ok, kq, _BIG).amin(1)
    kmax = torch.where(ok, kq, -_BIG).amax(1)
    lo = torch.searchsorted(kt, kmin - dmax, side="left")  # #(kt < kmin - dmax)
    hi = torch.searchsorted(kt, kmax + dmax, side="right")  # #(kt <= kmax + dmax)
    # the W-row window centred on [lo, hi), starting on a multiple of 256
    start = torch.clamp(((lo + hi - W) // 2) & ~255, 0, Mp - W)
    deficit = torch.clamp(start - lo, min=0) + torch.clamp(hi - (start + W), min=0)
    win = A[start[:, None] + torch.arange(W, device=dev)]  # (T, W, C)
    # exact float32 distances in the difference form, x, y, z in order
    d2 = ((qp[:, :, None, 0] - win[:, None, :, 0]) ** 2
          + (qp[:, :, None, 1] - win[:, None, :, 1]) ** 2
          + (qp[:, :, None, 2] - win[:, None, :, 2]) ** 2)  # (T, Q, W)
    j = torch.argmin(d2, dim=2)
    sel = torch.gather(win, 1, j[..., None].expand(T, Q, C)).reshape(n_pad, C)[:N]
    dmin = _sq3(query.to(torch.float32) - sel[:, :3])
    idx = torch.round(sel[:, -1]).to(torch.int32)
    valid = dmin <= dmax * dmax
    return torch.where(valid, idx, -1), dmin, sel, deficit.amax().to(torch.int32)


def hybrid_search(
    query: torch.Tensor,
    target: torch.Tensor,
    radius: float,
    max_knn: int,
    target_mask: torch.Tensor | None = None,
    grid_threshold: int | None = 65536,
    max_per_cell: int = 64,
    **chunks,
):
    """Radius-capped k-NN (Open3D's HybridSearch). Returns (idx (N, k),
    dist2 (N, k), counts (N,)) with idx=-1 / dist2=0 beyond the per-query
    count.

    Targets of `grid_threshold` points or more go through the hash-grid
    27-cell probe (core/nns_grid.py), whose `max_per_cell` cap can drop
    true neighbours in dense cells; grid_threshold=None keeps the exact
    brute-force path."""
    if grid_threshold is not None and target.shape[0] >= grid_threshold:
        from open3d_tpu_torch.core import nns_grid

        return nns_grid.hybrid_search_grid(
            query, target, radius, max_knn, target_mask, max_per_cell=max_per_cell
        )
    r2 = radius * radius
    if max_knn == 1:
        idx, d2 = one_nn_search(query, target, target_mask, **chunks)
        ok = d2 <= r2
        return (torch.where(ok, idx, -1)[:, None], torch.where(ok, d2, 0.0)[:, None],
                ok.to(torch.int32))
    idx, d2 = knn_search(query, target, max_knn, target_mask, **chunks)
    ok = (d2 <= r2) & (idx >= 0)
    counts = ok.to(torch.int32).sum(1, dtype=torch.int32)
    return torch.where(ok, idx, -1), torch.where(ok, d2, 0.0), counts


def fixed_radius_search(
    query: torch.Tensor,
    target: torch.Tensor,
    radius: float,
    max_nn: int,
    target_mask: torch.Tensor | None = None,
    **chunks,
):
    """All neighbours within radius, capped at max_nn (the fixed-shape
    stand-in for Open3D's FixedRadiusSearch)."""
    return hybrid_search(query, target, radius, max_nn, target_mask, **chunks)


class NearestNeighborSearch:
    """Open3D's facade: the target is fixed when the object is built, and
    there is no index to build."""

    def __init__(self, target: torch.Tensor, target_mask: torch.Tensor | None = None):
        self.target = target
        self.target_mask = target_mask

    def knn_search(self, query, k):
        return knn_search(query, self.target, k, self.target_mask)

    def hybrid_search(self, query, radius, max_knn):
        return hybrid_search(query, self.target, radius, max_knn, self.target_mask)

    def fixed_radius_search(self, query, radius, max_nn=64):
        return fixed_radius_search(query, self.target, radius, max_nn, self.target_mask)
