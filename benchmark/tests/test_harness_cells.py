"""A tiny run of each cell's traffic on the CPU, through the harness's own
path: the last line has the contract's keys and the cell's metrics, and the
run's outputs agree with the reference."""

import json

import pytest

from benchmark.tests.conftest import CELLS, ROOT, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _reported(kind, cell):
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_line(capsys, cell, trace):
    rc, line = run_cell(capsys, cell, trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace == 0:
        assert set(line["metrics"]) == _reported("end_to_end", cell)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        # on the CPU the profiler has no device: the device-trace readers
        # find nothing and their metrics are left out
        got = set(line["metrics"])
        assert got <= _reported("per_layer", cell)
        assert {"integrate_ms", "raycast_ms", "host_reads_per_frame"} <= got
        assert ("track_ms" in got) == (cell == "slam640.track")
        assert "busy_s" not in line["device"]
        for name, m in line["metrics"].items():
            unit = {x["name"]: x["unit"] for x in BENCH["per_layer"]}[name]
            assert m["unit"] == unit and m["value"] > 0


def test_unknown_workload_is_refused(capsys):
    from benchmark import run

    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"], device="cpu") == 2
    assert capsys.readouterr().out == ""
