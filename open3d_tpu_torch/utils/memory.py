"""Memory statistics and profiler hooks (port of open3d_tpu/utils/memory.py;
Open3D's core/MemoryManagerStatistic.h: allocations per device and a leak
report at exit).

The port reads PyTorch's own hooks:
- `live_array_stats`: the live torch.Tensors of this process (found by the
  garbage collector's walk), each storage counted once, by `str(device)`;
- `device_memory_stats`: the CUDA caching allocator's counters under the
  JAX package's keys (bytes_in_use, peak_bytes_in_use, bytes_limit), None
  on the CPU, as the JAX package's CPU backend gives None;
- `trace` and `annotate`: torch.profiler and record_function;
- `save_device_memory_profile`: the allocator's snapshot.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import gc
import json
import os
from typing import Dict, Optional

import torch

from open3d_tpu_torch.utils.logging import log_info, log_warning


def live_array_stats() -> Dict[str, Dict[str, int]]:
    """{device: {"count", "bytes"}} of the tensors this process still
    references; tensors that share a storage (views) count it once."""
    stats: Dict[str, Dict[str, int]] = collections.defaultdict(lambda: {"count": 0, "bytes": 0})
    seen = set()
    for obj in gc.get_objects():
        # type(), not isinstance: the latter reads __class__, which some
        # objects in the walk (deprecated torch aliases) answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.is_meta or obj.layout != torch.strided:
            continue
        storage = obj.untyped_storage()
        dev = str(obj.device)
        key = (dev, storage.data_ptr(), storage.nbytes())
        if key in seen:
            continue
        seen.add(key)
        stats[dev]["count"] += 1
        stats[dev]["bytes"] += storage.nbytes()
    return dict(stats)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's allocator counters: bytes_in_use and peak_bytes_in_use
    (bytes the caching allocator holds for tensors, now and at peak since
    the last reset), bytes_limit (the card's memory), bytes_reserved (what
    the allocator reserved from CUDA) and bytes_free (free on the card).
    `device` defaults to the card where there is one; on the CPU, None."""
    if device is None and not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
        "bytes_free": int(free),
    }


def memory_report(tag: str = "memory") -> str:
    """A readable snapshot, logged at info level and returned."""
    lines = [f"[{tag}]"]
    for dev, s in sorted(live_array_stats().items()):
        lines.append(f"  {dev}: {s['count']} live arrays, {s['bytes'] / 1e6:.1f} MB")
    ms = device_memory_stats()
    if ms:
        lim = ms["bytes_limit"]
        lines.append(
            f"  allocator: in_use {ms['bytes_in_use'] / 1e6:.1f} MB, "
            f"peak {ms['peak_bytes_in_use'] / 1e6:.1f} MB"
            + (f", limit {lim / 1e6:.1f} MB" if lim else "")
        )
    out = "\n".join(lines)
    log_info("{}", out)
    return out


_leak_check_enabled = False
_baseline: Dict[str, int] = {}


def enable_exit_leak_report(threshold_bytes: int = 1 << 20) -> None:
    """Arm a report at interpreter exit of the live tensors that grew past
    `threshold_bytes` on a device since this call (Open3D's
    MemoryManagerStatistic report). Idempotent."""
    global _leak_check_enabled, _baseline
    if _leak_check_enabled:
        return
    _leak_check_enabled = True
    _baseline = {d: s["bytes"] for d, s in live_array_stats().items()}

    def _report():
        for dev, s in live_array_stats().items():
            grown = s["bytes"] - _baseline.get(dev, 0)
            if grown > threshold_bytes:
                log_warning("exit leak report: {} holds {} live arrays / {:.1f} MB "
                            "(+{:.1f} MB since enable)", dev, s["count"], s["bytes"] / 1e6,
                            grown / 1e6)

    atexit.register(_report)


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """torch.profiler over the block, the CPU and, where there is one, the
    card; the Chrome trace is written gzipped into `logdir` as
    `<host>_<pid>.<time>.pt.trace.json.gz` (Perfetto and TensorBoard read
    it). host_tracer_level is the JAX profiler's knob and has no
    counterpart: the host side is traced at torch.profiler's level."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir, use_gzip=True))
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline (record_function)."""
    with torch.profiler.record_function(name):
        yield


def save_device_memory_profile(path: str) -> None:
    """Write the device memory profile to `path`. With a card: the CUDA
    caching allocator's snapshot (its segments and blocks, pickled, as
    `torch.cuda.memory._dump_snapshot` writes it; PyTorch's memory_viz
    reads it). On the CPU, which has no device allocator: a JSON object
    {"device": "cpu", "live": live_array_stats()}."""
    if torch.cuda.is_available():
        torch.cuda.memory._dump_snapshot(path)
        return
    with open(path, "w") as f:
        json.dump({"device": "cpu", "live": live_array_stats()}, f)
