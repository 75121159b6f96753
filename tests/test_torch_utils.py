"""Port of utils/ (logging, timers, memory statistics and profiler hooks):
tests/test_memory_stats.py's five cases on the port, then the timers and
the logging levels, each against the JAX package's behaviour.

Bars: live_array_stats sees a 4 MiB tensor to the byte and counts a
storage shared by views once; the profiler writes a gzipped Chrome trace
that holds the annotated range's name; the logging levels print and stay
quiet where the JAX package's do, with the same text after the timestamp.
"""

import gzip
import json
import os
import re

import pytest
import torch

from open3d_tpu.utils import logging as jlog
from open3d_tpu_torch.utils import logging as tlog
from open3d_tpu_torch.utils import memory as mem
from open3d_tpu_torch.utils import timer

torch.set_num_threads(2)


# ---- tests/test_memory_stats.py's cases on the port ------------------------

def test_live_array_stats_sees_allocations():
    before = mem.live_array_stats().get("cpu", {"count": 0, "bytes": 0})
    big = torch.ones((1024, 1024), dtype=torch.float32) + 1
    views = [big[:10], big.view(-1), big.t()]  # the same storage, counted once
    after = mem.live_array_stats()["cpu"]
    assert after["bytes"] == before["bytes"] + 4 * 1024 * 1024
    assert after["count"] == before["count"] + 1
    del big, views


def test_memory_report_runs():
    held = torch.zeros(16)  # a process may hold no tensor at all
    out = mem.memory_report("test")
    assert "cpu: " in out and "live arrays" in out and out.startswith("[test]")
    del held


def test_exit_leak_report_armable():
    mem.enable_exit_leak_report()
    mem.enable_exit_leak_report()  # idempotent


def test_profiler_trace_writes_xplane(tmp_path):
    logdir = str(tmp_path / "prof")
    with mem.trace(logdir):
        with mem.annotate("work_in_port"):
            x = torch.ones((256, 256)) @ torch.ones((256, 256))
            _ = float(x[0, 0])
    found = [os.path.join(r, f) for r, _, files in os.walk(logdir) for f in files
             if f.endswith(".trace.json.gz")]
    assert len(found) == 1, f"no profiler output under {logdir}"
    with gzip.open(found[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "work_in_port" for e in events)


def test_device_memory_profile(tmp_path):
    p = str(tmp_path / "mem.prof")
    mem.save_device_memory_profile(p)
    assert os.path.getsize(p) > 0
    if not torch.cuda.is_available():  # the CPU has no device allocator
        assert json.load(open(p))["device"] == "cpu"


def test_device_memory_stats_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mem.device_memory_stats() is None
    assert mem.device_memory_stats("cpu") is None


# ---- timers -------------------------------------------------------------

def test_timers(monkeypatch):
    clock = iter([10.0, 10.25, 10.5, 11.0, 11.75])
    monkeypatch.setattr(timer.time, "perf_counter", lambda: next(clock))
    t = timer.Timer()  # starts at 10.0
    assert t.elapsed_ms() == 250.0  # running: 10.25
    assert t.stop() == 500.0  # 10.5
    assert t.elapsed_ms() == 500.0 and t.stop() == 500.0  # stopped: no clock read
    t.start()  # 11.0
    assert t.stop() == 750.0


def test_scope_and_fps_timers(capsys):
    with tlog.verbosity_context(tlog.VerbosityLevel.INFO):
        with timer.ScopeTimer("block") as st:
            pass
        assert st.elapsed_ms() >= 0.0
        fps = timer.FPSTimer("frames", report_every_s=0.0)
        assert fps.signal() > 0
        slow = timer.FPSTimer("slow", report_every_s=3600.0)
        assert slow.signal() is None
    err = capsys.readouterr().err
    assert re.search(r"block took \d+\.\d\d ms", err) and re.search(r"frames: \d+\.\d fps", err)
    assert "slow" not in err


# ---- logging ------------------------------------------------------------

def _strip(err: str) -> list:
    """The log lines with their timestamps cut out."""
    return [re.sub(r" \d\d:\d\d:\d\d\]", "]", ln) for ln in err.splitlines()]


@pytest.mark.parametrize("level", list(tlog.VerbosityLevel), ids=lambda v: v.name)
def test_logging_levels_as_the_reference(capsys, level):
    out = {}
    for name, lg in (("port", tlog), ("jax", jlog)):
        with lg.verbosity_context(int(level)):
            assert lg.get_verbosity_level() == int(level)
            lg.log_debug("d {}", 1)
            lg.log_info("i {x}", x=2)
            lg.log_warning("w")
            with pytest.raises(RuntimeError, match="bad 3"):
                lg.log_error("bad {}", 3)
        out[name] = _strip(capsys.readouterr().err)
    assert out["port"] == out["jax"]
    shown = {"DEBUG": 3, "INFO ": 2, "WARN ": 1, "ERROR": 0}
    assert [ln[len("[open3d_tpu "):][:5] for ln in out["port"]] == [
        k for k, v in shown.items() if v <= int(level) or k == "ERROR"]
    assert tlog.get_verbosity_level() == tlog.VerbosityLevel.INFO  # restored
