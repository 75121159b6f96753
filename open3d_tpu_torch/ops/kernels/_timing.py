"""Device timing for the kernels' probes and chip_smoke.py."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA card; raises when there is none (a probe measures the card
    or nothing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("open3d_tpu_torch: this probe measures the CUDA card, and there is none")
    return torch.device("cuda")


N_READINGS = 5  # readings a kernel time is the median of


def median_of(read) -> tuple:
    """(median, spread) of N_READINGS calls of read(), each one reading of a
    time: the spread is the largest reading less the smallest."""
    vals = sorted(read() for _ in range(N_READINGS))
    return vals[len(vals) // 2], vals[-1] - vals[0]


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


L2_BYTES = 50 * 2**20  # the H100's L2 cache


def cold_ms(fn, reps: int, flush_bytes: int = 4 * L2_BYTES) -> float:
    """Mean device time of fn() with a cold L2 cache: before each run a
    scratch buffer four times the L2 is written and a second one read (so
    the cache holds none of fn's data and no dirty lines to write back),
    and each run is timed alone by its own pair of CUDA events. A spin
    kernel runs first, as in device_ms, so the events time the device."""
    scratch = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    clean = torch.zeros_like(scratch)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    events = []
    for i in range(reps):
        scratch.fill_(i)
        clean.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps
