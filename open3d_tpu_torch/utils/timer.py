"""Wall-clock timers (port of open3d_tpu/utils/timer.py; Open3D's
utility/Timer.h: Timer, ScopeTimer, FPSTimer). PyTorch returns before the
card finishes, so `start` and `stop` synchronise the card first when one
is in use: a span then holds the device work queued inside it, as the JAX
package's does when its callers block on their results.

Beside them, the recorder of the frame step's spans and counters (`span`,
`count`, `host_read`; `enable`, `disable`, `drain`). It never synchronises
the card: a span holds the host's time in the layer, and a profiler's
trace, whose launch calls carry the same clock, says what the card did
meanwhile. It is off until `enable()` is called; off, a call costs one
flag test.
"""

from __future__ import annotations

import time

import torch

from open3d_tpu_torch.utils.logging import log_info


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self):
        self._start = None
        self._elapsed_ms = 0.0
        self.start()

    def start(self) -> None:
        _sync()
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            _sync()
            self._elapsed_ms = (time.perf_counter() - self._start) * 1e3
            self._start = None
        return self._elapsed_ms

    def elapsed_ms(self) -> float:
        if self._start is not None:
            _sync()
            return (time.perf_counter() - self._start) * 1e3
        return self._elapsed_ms


class ScopeTimer(Timer):
    """Context manager that logs the elapsed time on exit."""

    def __init__(self, name: str = "scope"):
        self.name = name
        super().__init__()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        log_info("{} took {:.2f} ms", self.name, self.stop())
        return False


class FPSTimer:
    """Counts frames and reports frames/s about every `report_every_s`."""

    def __init__(self, name: str = "fps", report_every_s: float = 1.0):
        self.name = name
        self.report_every_s = report_every_s
        self._count = 0
        self._t0 = time.perf_counter()

    def signal(self) -> float | None:
        """Count one frame; returns the rate when a report was emitted."""
        self._count += 1
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= self.report_every_s:
            fps = self._count / dt
            log_info("{}: {:.1f} fps", self.name, fps)
            self._count = 0
            self._t0 = now
            return fps
        return None


# ---- the span and counter recorder ------------------------------------------
#
# One process-wide recorder, for the thread that runs the frame step: the
# spans sit inside functions whose signatures are the reference's, so no
# recorder object can be passed down to them. Spans are stamped with
# time.time_ns(), the host's epoch clock, on which torch.profiler stamps
# the host's side of its trace. A record is
# (name, start_ns, end_ns, parent index or -1, frame id or None, attrs or None).

_on = False
_spans: list = []
_open: list = []  # indices of the spans entered and not yet left, innermost last
_counts: dict = {}


class _NoSpan:
    """The span handed out while the recorder is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "frame", "attrs", "index")

    def __init__(self, name, frame, attrs):
        self.name, self.frame, self.attrs = name, frame, attrs

    def __enter__(self):
        parent = _open[-1] if _open else -1
        frame = self.frame
        if frame is None and parent >= 0:
            frame = _spans[parent][4]
        self.index = len(_spans)
        _open.append(self.index)
        _spans.append([self.name, time.time_ns(), None, parent, frame, self.attrs])
        return self

    def __exit__(self, *exc):
        _spans[self.index][2] = time.time_ns()
        _open.pop()
        return False


def span(name: str, frame=None, level=None):
    """A context manager that records `name` from entry to exit, under the
    innermost span open. `frame` is the frame id its spans share (children
    take their parent's); `level`, where given, is kept as the attribute
    {"level": level}. Off, it returns one shared no-op."""
    if not _on:
        return _NO_SPAN
    return _Span(name, frame, None if level is None else {"level": level})


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (nothing while off)."""
    if not _on:
        return
    _counts[name] = _counts.get(name, 0) + n


def host_read(site: str, x):
    """`x.item()`: the host waits for a device value. Every such read on the
    frame step goes through here under the name of its site; while on, it
    is timed as the span `host_read.<site>` and counted in
    `host_reads.<site>`."""
    if not _on:
        return x.item()
    with _Span("host_read." + site, None, None):
        v = x.item()
    key = "host_reads." + site
    _counts[key] = _counts.get(key, 0) + 1
    return v


def enable() -> None:
    """Start recording (what was recorded and not drained is kept)."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain():
    """(spans, counters) recorded since the last drain, which are cleared:
    spans as (name, start_ns, end_ns, parent, frame, attrs) tuples in the
    order they were entered, parent an index into the list or -1. Called
    outside every span."""
    if _open:
        raise RuntimeError(f"drain() inside the open span {_spans[_open[-1]][0]!r}")
    spans = [tuple(r) for r in _spans]
    counts = dict(_counts)
    _spans.clear()
    _counts.clear()
    return spans, counts
