"""Helpers shared by the kernels' plain PyTorch versions and wrappers."""

from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (CUDA's
    fmaf): the product of two float32 values is exact in float64, and the
    sum is rounded to float32 from there (a double rounding that differs
    from a true FMA with probability about 2^-29). Python scalars are taken
    as float32, as the kernels receive them."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).double() for x in (a, b, c))
    return (a * b + c).float()


def shift2d(img: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """Shift an (H, W[, C]) image; vacated pixels get `fill`."""
    out = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
    H, W = img.shape[0], img.shape[1]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    valid = (yy >= dy) & (yy < H + dy) & (xx >= dx) & (xx < W + dx)
    if img.ndim == 3:
        valid = valid[..., None]
    return torch.where(valid, out, torch.as_tensor(fill, dtype=img.dtype, device=img.device))


def check_tensor(name: str, t: torch.Tensor, dtype, device, shape=None) -> None:
    """Raise unless `t` has the dtype, device, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    """Raise unless `t` starts on an `nbytes` boundary (a kernel that moves
    its rows as 16-byte words needs it; a fresh allocation always is)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected data aligned to {nbytes} bytes")
