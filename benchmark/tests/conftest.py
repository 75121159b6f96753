"""The benchmark's own tests: CPU only, at a tiny size, except those marked
`cuda`, which need the card and skip without one.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# 160 x 120 frames, 2 cm voxels, a 2048-block grid; 24 frames of the orbit
TINY = {
    "config": {
        "camera": {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25, "cx": 79.5,
                   "cy": 59.5},
        "slam": {**json.loads((ROOT / "benchmark/configs/slam640.json").read_text())["slam"],
                 "voxel_size": 0.02, "block_count": 2048, "frame_block_capacity": 512},
    },
    "traffic": {"frames": 24, "warmup_steps": 2, "sample_stride": 3, "trace_steps": 4,
                "host_trace_steps": 2, "k2_count_every": 2},
}
CELLS = ("slam640.track", "slam640.known_pose")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(capsys, cell: str, trace: int = 0, seconds: float = 1.5, seed: int = 2147483913,
             overrides=None):
    """(exit code, the last line's JSON or None) of a tiny run of `cell` on
    the CPU through the harness's own path."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import run

    ov = {k: dict(v) for k, v in TINY.items()}
    for k, v in (overrides or {}).items():
        ov.setdefault(k, {}).update(v)
    capsys.readouterr()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", overrides=ov)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
