"""The raycast march's inner loop on staged blocks, on dummy geometry (port
of scripts/micro_raymarch_kernel.py).

`march` launches the CUDA kernel in `csrc/micro_raymarch.cu` for CUDA
tensors and runs `march_plain`, the same function in plain PyTorch, for CPU
tensors. Nothing falls back: a CUDA tensor either launches the kernel or
raises.

Replaces: scripts/micro_raymarch_kernel.py:kern (the pallas_call at :87,
via f). Per tile t, block k = rows[t, k] of tw viewed as (C, 4096), ray
r < 256 and step m < M: the word at (r * (k M + m + 131)) & 4095 decoded to
a tsdf (2.0 where unallocated), and the crossing search of the script's
:67-72. The one-hot row select and lane gather were the TPU's way to read
that word; the kernel reads it from shared memory.
Bound: bytes, T * K * 16384 + T * 256 * 4 + T * K * 4 (each staged block,
the output and the row indices once); about 7 float32 operations a sample.
The kernel starts all K block copies of a tile at once (bulk copies of the
Tensor Memory Accelerator) and waits for each before sampling it.

Rounding: the crossing parameter is one fused multiply-add, where XLA's CPU
backend fuses it in the interpreted kernel; the plain version emulates it
(`_plain.fma`) and agrees with the kernel to the last bit.

    python -m open3d_tpu_torch.ops.kernels.micro_raymarch

runs the script's size on the card and prints its lines.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels._plain import fma

T, K, M, NR = 1200, 8, 8, 256  # tiles, blocks a tile, steps a block, rays a tile: the script's
C = 40960
OPS_SAMPLE = 7  # decode 1, z 1, prev_v - val 1, divide 1, z - prev_z 1, the fma 2
_INV_SCALE = np.float32(1.0 / 16383.0)


def make_inputs(generator: torch.Generator, device, T: int = T, C: int = C):
    """tw (C, 32, 128) int32 uniform over the int32 range and rows (T, K)
    int32 in [0, C), as the script draws them."""
    tw = torch.randint(-(2**31), 2**31 - 1, (C, 32, 128), generator=generator, device=device,
                       dtype=torch.int32)
    rows = torch.randint(0, C, (T, K), generator=generator, device=device, dtype=torch.int32)
    return tw, rows


def march_plain(rows: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The script's kern over all tiles at once: (T, 1, 256) float32, 1e9
    where a ray finds no crossing."""
    n_tiles = rows.shape[0]
    flat_tw = tw.reshape(tw.shape[0], -1)
    ray = torch.arange(NR, dtype=torch.int32, device=tw.device)
    zhit = torch.full((n_tiles, NR), 1e9, device=tw.device)
    prev_v = torch.ones((n_tiles, NR), device=tw.device)
    prev_z = torch.zeros((n_tiles, NR), device=tw.device)
    two = torch.tensor(2.0, device=tw.device)
    for k in range(K):
        blk = flat_tw[rows[:, k].long()]
        for m in range(M):
            w = blk[:, ((ray * (k * M + m + 131)) & 4095).long()]
            val = torch.where((w & 0xFFFF) > 0, (w >> 16).to(torch.float32) * _INV_SCALE, two)
            z = prev_z + 0.01
            crossing = (prev_v > 0) & (val <= 0) & (val > -1.5)
            zc = fma(prev_v / torch.clamp(prev_v - val, min=1e-6), z - prev_z, prev_z)
            zhit = torch.where(crossing & (zc < zhit), zc, zhit)
            prev_v = torch.where(val < 1.5, val, prev_v)
            prev_z = z
    return zhit[:, None, :]


def bytes_moved(n_tiles: int) -> int:
    """Bytes the function must move: each tile's K staged blocks and K row
    indices read once, its 256 depths written once."""
    return n_tiles * (K * 4096 * 4 + K * 4 + NR * 4)


def ops(n_tiles: int) -> int:
    """float32 operations of the function: OPS_SAMPLE for each sample."""
    return n_tiles * K * M * NR * OPS_SAMPLE


def march(rows: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """(T, 1, 256) float32 hit depths for rows (T, 8) int32, every row in
    [0, C), and tw (C, 32, 128) int32.

    CUDA tensors launch the kernel and count one in `march.launches` (a row
    out of range stops it with a device fault before its tile's first copy);
    CPU tensors
    run march_plain, after a check that raises on a row out of range."""
    dev = tw.device
    if tw.ndim != 3 or tuple(tw.shape[1:]) != (32, 128):
        raise ValueError(f"tw: expected (C, 32, 128), got {tuple(tw.shape)}")
    _check("tw", tw, torch.int32, dev, tw.shape)
    if rows.ndim != 2 or rows.shape[1] != K:
        raise ValueError(f"rows: expected (T, {K}), got {tuple(rows.shape)}")
    _check("rows", rows, torch.int32, dev, rows.shape)
    if dev.type == "cpu":
        if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= tw.shape[0]):
            raise ValueError(f"rows: every row must lie in [0, {tw.shape[0]})")
        return march_plain(rows, tw)
    if dev.type != "cuda":
        raise ValueError(f"march: unsupported device {dev}")
    if tw.data_ptr() % 16:
        raise ValueError("tw must start on a 16-byte boundary (bulk copies)")

    from open3d_tpu_torch.ops.kernels import _build

    lib = _build.load()
    out = torch.empty((rows.shape[0], 1, NR), dtype=torch.float32, device=dev)
    err = lib.o3dt_micro_raymarch(tw.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.shape[0],
                                  tw.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err)
    march.launches += 1
    return out


march.launches = 0


def occupancy() -> tuple:
    """(CTAs of the kernel a multiprocessor holds, multiprocessors)."""
    from open3d_tpu_torch.ops.kernels import _build

    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.load().o3dt_micro_raymarch_occupancy(ctypes.byref(per_sm),
                                                             ctypes.byref(sms)))
    return per_sm.value, sms.value


def parity(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Hit agreement (1e9 = miss) and the largest depth difference where
    both hit."""
    hk, hp = out < 1e9, ref < 1e9
    both = hk & hp
    dz = (out - ref).abs()[both]
    return {"hit_agree": float((hk == hp).float().mean()),
            "max_abs_dz": float(dz.max()) if dz.numel() else 0.0,
            "hit_frac": float(hk.float().mean())}


def main() -> None:
    from open3d_tpu_torch.ops.kernels._timing import device_ms, require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    tw, rows = make_inputs(gen, dev)
    out = march(rows, tw)
    par = parity(out, march_plain(rows, tw))
    print("compiled ok, out[0,:3] =", out[0, 0, :3].cpu().numpy(), par, flush=True)
    if par["hit_agree"] < 1.0 or par["max_abs_dz"] > 1e-6:
        raise RuntimeError(f"march disagrees with march_plain: {par}")
    ms = device_ms(lambda: march(rows, tw), reps=20)
    per_sm, sms = occupancy()
    print(f"raymarch inner T={T} K={K} M={M} ({T * K * M * NR / 1e6:.0f}M samples): {ms:.3f} ms "
          f"| {per_sm} CTA a multiprocessor, {-(-T // (per_sm * sms))} waves over {sms}",
          flush=True)


if __name__ == "__main__":
    main()
