"""The traced run's instruments: CUDA-event pairs around the program's public
functions, and `torch.profiler` over the traced steps, reduced to the
numbers the per-layer readers take.

The device's busy time is the union of the device intervals (kernels,
copies, sets) of the traced part, so two operations that overlap count
once; the window is the host's wall time of the traced steps, which start
and end with the card idle. The trace's timestamps are the host's epoch
nanoseconds (`time.time_ns`); the card's are converted to them and can
sit a little off, so device intervals are not clipped to the host's
window: the profile holds the traced steps' work and nothing else.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

HOST_READ_OP = "aten::_local_scalar_dense"  # every float(), bool(), .item() of a device value
END = 2 ** 63  # past any timestamp: the whole profile


class LayerTimer:
    """CUDA-event pairs (host clock on the CPU) around functions patched onto
    their modules; `times[name]` lists the milliseconds of each call."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pairs = defaultdict(list)
        self.host = defaultdict(list)

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            if self.cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
                self.pairs[name].append((a, b))
                return out
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.host[name].append((time.perf_counter() - t) * 1e3)
            return out
        return timed

    @contextmanager
    def patched(self, targets):
        """targets: (module, attribute name, layer name) triples; the
        originals are put back however the block ends."""
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
        try:
            for mod, attr, name in targets:
                setattr(mod, attr, self.wrap(name, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def times(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.pairs.items()}
        return dict(self.host)


def device_events(prof):
    """[(start_ns, end_ns, name)] of every operation that ran on the card."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
    out.sort()
    return out


def host_events(prof):
    """[(start_ns, end_ns, name)] of the host's operators."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
    out.sort()
    return out


def merged(intervals, lo: int, hi: int):
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    disjoint sorted (start, end) pairs."""
    out = []
    for iv in sorted(intervals):
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def idle_gaps(intervals, lo: int, hi: int, host, n: int = 10):
    """The n longest stretches of [lo, hi] (widened to the device intervals)
    in which nothing ran on the card, each named by the innermost host
    operator running at its middle ("host idle" where none ran), as
    [[name, seconds]]."""
    if intervals:
        lo, hi = min(lo, intervals[0][0]), max(hi, max(e for _, e, _ in intervals))
    gaps, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            gaps.append((s - t, t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((hi - t, t, hi))
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:n]:
        mid = (s + e) // 2
        name = "host idle"
        best = None
        for hs, he, hn in host:
            if hs > mid:
                break
            if he >= mid and (best is None or hs >= best):
                best, name = hs, hn
        out.append([name, length / 1e9])
    return out


def top_device_ops(intervals, lo: int, hi: int, n: int = 10):
    """[[name, seconds]] of the n device operations with the most time in
    [lo, hi], summed over their launches."""
    tot = defaultdict(int)
    for s, e, name in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            tot[name] += e - s
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernel_ms(intervals, lo: int, hi: int, kernel: str):
    """Milliseconds of each launch of the kernel named `kernel` (a whole
    identifier in the device operation's name: `march_kernel` is not
    `raymarch_kernel`), in launch order, inside [lo, hi]."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel) + r"(?![A-Za-z0-9_])")
    return [(e - s) / 1e6 for s, e, name in intervals if s >= lo and e <= hi and pat.search(name)]


def count_host(host, lo: int, hi: int, name: str) -> int:
    return sum(1 for s, e, n in host if n == name and s >= lo and e <= hi)
