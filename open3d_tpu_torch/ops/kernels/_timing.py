"""Device timing for the kernels' probes and chip_smoke.py."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA card; raises when there is none (a probe measures the card
    or nothing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("open3d_tpu_torch: this probe measures the CUDA card, and there is none")
    return torch.device("cuda")


def device_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events. A spin
    kernel of about 50 ms runs first, so the host has queued every launch
    before the first one starts: the events then time the device's work,
    not the host's enqueue rate (a wrapper's Python checks take longer
    than a small kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
