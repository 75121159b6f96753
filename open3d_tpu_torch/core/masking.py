"""Fixed-capacity buffer idiom (port of open3d_tpu/core/masking.py).

Containers keep a static capacity plus a validity mask, so shapes do not
depend on data and nothing syncs with the host to size an output. Invalid
point coordinates are parked at FAR_COORD.
"""

from __future__ import annotations

import math

import torch

# Padding coordinate for invalid points: far outside any plausible scene,
# but small enough that squared distances (~1e17) stay finite in float32.
FAR_COORD = 3.0e8


def round_up(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


def pad_axis0(x: torch.Tensor, capacity: int, fill_value) -> torch.Tensor:
    """Pad (or truncate) axis 0 to `capacity` with `fill_value`."""
    n = x.shape[0]
    if n == capacity:
        return x
    if n > capacity:
        return x[:capacity]
    pad = torch.full((capacity - n,) + tuple(x.shape[1:]), fill_value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, rounded once in float32 on every device. PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-number divisor while its
    CPU kernels divide, so a floor() of the quotient could differ between a
    tensor on the card and its CPU copy; a 0-d tensor divisor divides on both
    (as the JAX package does outside jit)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    return mask


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=0, keepdims=False):
    """Mean of x over `axis`, counting only the rows where mask is True."""
    m = _expand_mask(mask.to(x.dtype), x)
    total = torch.sum(x * m, dim=axis, keepdim=keepdims)
    count = torch.sum(m, dim=axis, keepdim=keepdims)
    return total / torch.clamp(count, min=1.0)


def masked_min(x: torch.Tensor, mask: torch.Tensor, axis=0, big=float("inf")):
    return torch.amin(torch.where(_expand_mask(mask, x), x, big), dim=axis)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis=0, small=float("-inf")):
    return torch.amax(torch.where(_expand_mask(mask, x), x, small), dim=axis)


def compact_indices(mask: torch.Tensor, capacity: int):
    """Stable-compact the True positions of `mask` (N,) into the first
    `count` slots. Returns (indices (capacity,) int32, count () int32).
    indices[i] for i >= count points at a harmless gather target (the same
    padding rule as the JAX package: the sort order, or N-1 past its end)."""
    n = mask.shape[0]
    # True (0) first; the stable sort keeps the original order among equals
    _, order = torch.sort((~mask).to(torch.int8), stable=True)
    count = mask.to(torch.int32).sum()
    if capacity <= n:
        idx = order[:capacity]
    else:
        pad = order.new_full((capacity - n,), n - 1)
        idx = torch.cat([order, pad])
    live = torch.arange(capacity, device=mask.device) < count
    idx = torch.where(live, idx, torch.clamp(idx, max=n - 1))
    return idx.to(torch.int32), torch.clamp(count, max=capacity).to(torch.int32)


def lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """The stable lexicographic order of the rows of (N, k) int32 keys,
    column 0 first (`jax.lax.sort` over k keys, or `jnp.lexsort` of the
    reversed columns): the columns packed two a word into int64, one
    stable argsort a word from the last to the first."""
    k = keys.to(torch.int64)
    if k.shape[1] % 2:
        k = torch.cat([k, torch.zeros_like(k[:, :1])], dim=1)
    words = [(k[:, j] << 32) + (k[:, j + 1] + 2**31) for j in range(0, k.shape[1], 2)]
    order = torch.argsort(words[-1], stable=True)
    for w in reversed(words[:-1]):
        order = order[torch.argsort(w[order], stable=True)]
    return order


def _scatter_plan(idx: torch.Tensor, n: int):
    """The order and segment lengths that `_scatter_add` sums `idx` (M,) by:
    a stable sort by index; indices outside [0, n) sort last, past the n
    segments, and are never read. Reusable for every `vals` over the same
    indices."""
    idx = idx.reshape(-1).to(torch.int64)
    key = torch.where((idx >= 0) & (idx < n), idx, n)
    return torch.argsort(key, stable=True), torch.bincount(key, minlength=n + 1)[:n]


def _scatter_apply(vals: torch.Tensor, plan) -> torch.Tensor:
    """Sum the rows of `vals` by a `_scatter_plan`: each index's rows in
    input order, one segmented sum (the dropped rows trail the segments)."""
    order, lengths = plan
    if order.numel() == 0:
        return vals.new_zeros((lengths.numel(),) + tuple(vals.shape[1:]))
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, unsafe=True)


def _scatter_add(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of `vals` (M, ...) into `n` rows by `idx` (M,), with the
    same bits on every run: for floats a stable sort by index, then one
    segmented sum of each index's rows in input order (no float atomics,
    whose order on the card is whatever order they land in); integer sums
    are exact in any order. Indices outside [0, n) are dropped, as JAX's
    scatter with mode="drop" drops them. Returns (n, ...) in the dtype of
    `vals`."""
    if not vals.is_floating_point():
        idx = idx.reshape(-1).to(torch.int64)
        ok = (idx >= 0) & (idx < n)
        out = vals.new_zeros((n + 1,) + tuple(vals.shape[1:]))
        return out.index_add_(0, torch.where(ok, idx, n), vals)[:n]
    return _scatter_apply(vals, _scatter_plan(idx, n))


def _unique_rows(keys: torch.Tensor, size: int, fill: int):
    """`jnp.unique(keys, axis=0, size=size, fill_value=fill,
    return_inverse=True)` for (N, k) int32 keys: the distinct rows in
    lexicographic order, the first `size` kept and the rest `fill`, and each
    input row's index among them (an index >= size for a row past the kept
    ones)."""
    order = lexsort_rows(keys)
    s = keys[order]
    first = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    first[1:] = (s[1:] != s[:-1]).any(-1)
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    inv = torch.empty_like(gid).scatter_(0, order, gid)
    rows = s[first][:size]
    uniq = torch.full((size, keys.shape[1]), fill, dtype=keys.dtype, device=keys.device)
    uniq[:rows.shape[0]] = rows
    return uniq, inv
