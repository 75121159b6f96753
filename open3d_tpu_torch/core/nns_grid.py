"""Hash-grid fixed-radius / hybrid nearest-neighbour search (port of
open3d_tpu/core/nns_grid.py).

Open3D's FixedRadiusIndex builds a spatial hash as count, prefix sum and
permute into bucket-contiguous order; here that is one sort:

- build: key every point by its grid cell (cell edge = search radius, so a
  radius ball lies in the 3x3x3 cell neighbourhood), sort the points by
  their packed cell key, mark segment boundaries, and activate the unique
  cell keys in a core/hashmap table whose slots index (segment start,
  segment count) into the sorted points;
- query: find() the 27 neighbour cells of each query, take up to
  `max_per_cell` consecutive sorted points from each hit segment, and keep
  the k nearest within the radius.

Cells denser than `max_per_cell` contribute only their first
`max_per_cell` sorted points; raise it for exact results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core.nns import _sq3

_BIG = 3.0e38
_U32 = 0xFFFFFFFF


class GridIndex(NamedTuple):
    """CSR-style spatial hash grid over a fixed target cloud."""

    table: torch.Tensor  # (C, 2) int32 hashmap of occupied cell keys
    seg_start: torch.Tensor  # (C + 1,) int32 segment start per slot (C = miss)
    seg_count: torch.Tensor  # (C + 1,) int32 segment length per slot
    order: torch.Tensor  # (N,) int32: sorted position -> original point index
    points_sorted: torch.Tensor  # (N, 3) f32 points in bucket-contiguous order
    cell_size: float


def build_grid(
    points: torch.Tensor,
    cell_size: float,
    mask: torch.Tensor | None = None,
    table_factor: int = 2,
) -> GridIndex:
    """Build the spatial hash index over `points` (N, 3). Masked-out rows
    never match a query.

    The JAX package sorts (w0, w1, row) with lax.sort on two int32 keys;
    here one stable sort runs on the int64 key w0 * 2^32 + (w1 + 2^31),
    which has the same signed lexicographic order, rows of one cell staying
    in their original order."""
    N = points.shape[0]
    dev = points.device
    pts = points.to(torch.float32)
    cell = torch.floor(pts * (1.0 / cell_size)).to(torch.int32)
    keys = hm.pack_coords(cell)
    if mask is not None:
        # invalid rows: clear the valid bit and sort them to the tail
        keys = torch.where(mask[:, None], keys, 0x7FFFFFFE)
    w0, w1 = keys[:, 0].to(torch.int64), keys[:, 1].to(torch.int64)
    k64 = (w0 << 32) + (w1 + (1 << 31))
    sk, order = torch.sort(k64, stable=True)
    skey = torch.stack([(sk >> 32).to(torch.int32), ((sk & _U32) - (1 << 31)).to(torch.int32)], -1)
    sval = hm.is_valid(skey)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    first = first & sval
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1  # per sorted row
    n_cells = first.to(torch.int64).sum()

    # compact the unique keys and their segment starts to the front
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    dst = torch.where(first, seg_id, N)
    uniq = torch.zeros((N + 1, 2), dtype=torch.int32, device=dev).index_copy_(0, dst, skey)[:N]
    starts = torch.zeros(N + 1, dtype=torch.int32, device=dev).index_copy_(0, dst, pos)[:N]
    # segment length = next start - start (the last ends at the valid count)
    n_valid = sval.to(torch.int32).sum()
    next_start = torch.cat([starts[1:], starts[-1:]])
    ends = torch.where(torch.arange(N, device=dev) == n_cells - 1, n_valid, next_start)
    counts = torch.clamp(ends - starts, min=0)
    live = torch.arange(N, device=dev) < n_cells
    uniq = torch.where(live[:, None], uniq, 0)

    C = int(table_factor) * N
    table, slot, ok = hm.activate(hm.make_table(C, device=dev), uniq, max_rounds=32)
    # a failed activation must not land in row C, the all-zero row every
    # missed lookup reads: it goes to row C + 1, which is dropped
    rows = torch.where(ok & live, slot, C + 1).to(torch.int64)
    seg_start = torch.zeros(C + 2, dtype=torch.int32, device=dev).index_copy_(
        0, rows, torch.where(live, starts, 0))[:C + 1]
    seg_count = torch.zeros(C + 2, dtype=torch.int32, device=dev).index_copy_(
        0, rows, torch.where(live, counts, 0))[:C + 1]
    return GridIndex(
        table=table,
        seg_start=seg_start,
        seg_count=seg_count,
        order=order.to(torch.int32),
        points_sorted=pts[order],
        cell_size=float(cell_size),
    )


def _offsets_27(device) -> torch.Tensor:
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)


def query_grid(
    grid: GridIndex,
    query: torch.Tensor,
    radius: float,
    max_nn: int,
    max_per_cell: int = 16,
    query_chunk: int = 8192,
):
    """Radius-capped kNN through the 27-cell probe.

    radius must be <= grid.cell_size (one-ring coverage). Returns
    (idx (Q, max_nn) int32 -1-padded, dist2 (Q, max_nn) f32 0-padded,
    counts (Q,) int32): the HybridSearch contract."""
    if radius > grid.cell_size * (1.0 + 1e-6):
        raise ValueError(
            f"radius {radius} exceeds grid cell size {grid.cell_size}; "
            "rebuild the grid with cell_size >= radius"
        )
    Q = query.shape[0]
    P = int(max_per_cell)
    k = int(max_nn)
    r2 = radius * radius
    N = grid.points_sorted.shape[0]
    dev = query.device
    qc = int(min(query_chunk, Q))
    # tail pad so start + P gathers stay in range
    pts_ext = torch.cat([grid.points_sorted, torch.full((P, 3), 1e18, dtype=torch.float32, device=dev)])
    ord_ext = torch.cat([grid.order, torch.full((P,), -1, dtype=torch.int32, device=dev)])
    offsets = _offsets_27(dev)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    C = grid.table.shape[0]
    out_i, out_d, out_n = [], [], []
    for s in range(0, Q, qc):
        q = query[s:s + qc].to(torch.float32)
        n = q.shape[0]
        cell = torch.floor(q * (1.0 / grid.cell_size)).to(torch.int32)
        nb = cell[:, None, :] + offsets[None, :, :]  # (n, 27, 3)
        slot, found = hm.find(grid.table, hm.pack_coords(nb.reshape(-1, 3)))
        rows = torch.where(found, slot, C).to(torch.int64).reshape(n, 27)
        start = grid.seg_start[rows]
        cnt = torch.clamp(grid.seg_count[rows], max=P)
        live = lanes[None, None, :] < cnt[..., None]  # (n, 27, P)
        cand = torch.where(live, start[..., None] + lanes, N).reshape(n, -1)  # dead lanes: pad rows
        d2 = _sq3(pts_ext[cand.to(torch.int64)] - q[:, None, :])
        d2 = torch.where(live.reshape(n, -1) & (d2 <= r2), d2, _BIG)
        bd, sel = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        bi = torch.gather(cand, 1, sel)
        ok = bd < _BIG
        out_i.append(torch.where(ok, ord_ext[torch.clamp(bi, max=N + P - 1).to(torch.int64)], -1))
        out_d.append(torch.where(ok, bd, 0.0))
        out_n.append(ok.to(torch.int32).sum(1, dtype=torch.int32))
    return torch.cat(out_i), torch.cat(out_d), torch.cat(out_n)


def hybrid_search_grid(
    query: torch.Tensor,
    target: torch.Tensor,
    radius: float,
    max_knn: int,
    target_mask: torch.Tensor | None = None,
    max_per_cell: int = 16,
    query_chunk: int = 8192,
):
    """One-shot build and query (HybridSearch through the hash grid)."""
    grid = build_grid(target, radius, target_mask)
    return query_grid(grid, query, radius, max_knn, max_per_cell, query_chunk)
