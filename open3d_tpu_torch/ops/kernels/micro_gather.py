"""Gather from a small table: out[s] = table.flat[idx[s]] (port of
scripts/micro_onehot_gather.py).

`gather` launches the CUDA kernel in `csrc/micro_gather.cu` for CUDA
tensors and runs `gather_plain`, the same function in plain PyTorch, for
CPU tensors. Nothing falls back: a CUDA tensor either launches the kernel or
raises.

Replaces: scripts/micro_onehot_gather.py:make_gather (the pallas_call at
:49), both of its variants: "take" and "reduce" are two TPU ways to pick
the lane after a one-hot row select, and compute the same function. The
script's S_CHUNK is a TPU grid size and only names the configuration.
Bound: bytes, NT * 8 + R * 512 (each index read and each output written
once, the table read once), against no arithmetic; the kernel keeps the
table in shared memory and streams idx and out in 16-byte accesses.

    python -m open3d_tpu_torch.ops.kernels.micro_gather

runs the script's three configurations on the card and prints its lines.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check

CONFIGS = ((32, 2048), (320, 2048), (32, 8192))  # (R, S_CHUNK), the script's
NS = 12_000_000
SMEM_LIMIT = 232_448  # bytes of shared memory a CTA may hold on Hopper


def n_indices(s_chunk: int) -> int:
    """The script's index count for one S_CHUNK: whole chunks of NS."""
    return (NS // s_chunk) * s_chunk


def make_inputs(R: int, n: int, generator: torch.Generator, device):
    """table (R, 128) standard normal float32, idx (n, 1) int32 in
    [0, R * 128), as the script draws them."""
    table = torch.randn((R, 128), generator=generator, device=device)
    idx = torch.randint(0, R * 128, (n, 1), generator=generator, device=device, dtype=torch.int32)
    return table, idx


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s] = table.reshape(-1)[idx[s]], shaped like idx."""
    return table.reshape(-1)[idx.reshape(-1).long()].reshape(idx.shape)


def bytes_moved(R: int, n: int) -> int:
    """Bytes the function must move: idx read and out written once, the
    table read once."""
    return n * 8 + R * 128 * 4


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s] = table.flat[idx[s]] for table (R, 128) float32 and idx (n, 1)
    int32 with every index in [0, R * 128).

    CUDA tensors launch the kernel and count one in `gather.launches` (an
    index out of range stops it with a device fault); CPU tensors run
    gather_plain, after a check that raises on an index out of range."""
    dev = table.device
    if table.ndim != 2 or table.shape[1] != 128:
        raise ValueError(f"table: expected (R, 128), got {tuple(table.shape)}")
    R = table.shape[0]
    _check("table", table, torch.float32, dev, (R, 128))
    if idx.ndim != 2 or idx.shape[1] != 1:
        raise ValueError(f"idx: expected (n, 1), got {tuple(idx.shape)}")
    _check("idx", idx, torch.int32, dev, idx.shape)
    if dev.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= R * 128):
            raise ValueError(f"idx: every index must lie in [0, {R * 128})")
        return gather_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather: unsupported device {dev}")
    if R * 128 * 4 > SMEM_LIMIT:
        raise ValueError(f"table: {R} rows do not fit in one CTA's shared memory")
    if table.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("table and idx must start on a 16-byte boundary")

    from open3d_tpu_torch.ops.kernels import _build

    lib = _build.load()
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    err = lib.o3dt_micro_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, idx.numel(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err)
    gather.launches += 1
    return out


gather.launches = 0


def main() -> None:
    from open3d_tpu_torch.ops.kernels._timing import device_ms, require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    for R, s_chunk in CONFIGS:
        table, idx = make_inputs(R, n_indices(s_chunk), gen, dev)
        out = gather(table, idx)
        ok = torch.equal(out, gather_plain(table, idx))
        ms = device_ms(lambda: gather(table, idx), reps=20)
        print(f"gather R={R} chunk={s_chunk} ({'OK' if ok else 'WRONG'}): {ms:.3f} ms", flush=True)
        if not ok:
            raise RuntimeError(f"gather R={R} chunk={s_chunk} disagrees with gather_plain")


if __name__ == "__main__":
    main()
