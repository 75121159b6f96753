"""Wall-clock timers (port of open3d_tpu/utils/timer.py; Open3D's
utility/Timer.h: Timer, ScopeTimer, FPSTimer). PyTorch returns before the
card finishes, so `start` and `stop` synchronise the card first when one
is in use: a span then holds the device work queued inside it, as the JAX
package's does when its callers block on their results.
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
