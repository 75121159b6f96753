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
