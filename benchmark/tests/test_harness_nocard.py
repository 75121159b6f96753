"""A run without the card it asks for fails and prints no result; so does a
run in a checkout that holds only BENCHMARK.json and the benchmark's
files."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT, TINY


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from benchmark import run

    capsys.readouterr()
    rc = run.main(["--workload", "slam640.track", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_card_command_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "slam640.known_pose",
                          "--seed", "2147483941", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, sys\nfrom benchmark import run\n"
            f"ov = json.loads({json.dumps(json.dumps(TINY))})\n"
            "sys.exit(run.main(['--workload', 'slam640.track', '--seed', '1', '--seconds', '1'],"
            " device='cpu', overrides=ov))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "open3d_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """On the card: a short run of the known-pose cell is correct and names
    the device."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "slam640.known_pose",
                          "--seed", "2147483951", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
