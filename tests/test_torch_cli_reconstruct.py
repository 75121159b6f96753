"""Port parity for tools/cli.py's `reconstruct`: the command on a 160x120
TUM directory (8 frames of the synthetic room, span 0.5, written by the
port) at tests/test_tum_pipeline.py's configuration (a YAML file), started
as `python -m open3d_tpu_torch.tools.cli reconstruct DIR --device cpu` in a
process of its own while the test calls run_system directly on the loaded
sequence, both on 3 threads. Bar: the two trajectory.log files are
byte-equal, and the trajectory is within tests/test_tum_pipeline.py's
0.05 m ATE of the truth. The JAX package's `reconstruct` is in its full
tier, so it is not run here.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

from open3d_tpu_torch.data import dataset as tds
from open3d_tpu_torch.pipelines import reconstruction as trc
from test_torch_cli import tum_dir  # noqa: F401  (the fixture)

REPO = Path(__file__).resolve().parents[1]
THREADS = 3


def test_reconstruct_command_equals_run_system(tum_dir, tmp_path):
    cfg = trc.ReconstructionConfig(
        fragment_size=4, n_keyframes_per_n_frame=3, depth_max=4.0, voxel_size=0.02,
        block_count=8192, block_resolution=8, trunc_voxel_multiplier=4.0,
        downsample_voxel_size=0.05, registration_point_capacity=8192,
        fragment_point_capacity=65536, path_output=str(tmp_path / "direct"),
    )
    yml = str(tmp_path / "cfg.yml")
    cfg.to_yaml(yml)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS=str(THREADS))
    cli_out = str(tmp_path / "cli")
    proc = subprocess.Popen(
        [sys.executable, "-m", "open3d_tpu_torch.tools.cli", "reconstruct", tum_dir,
         "--device", "cpu", "--config", yml, "--output", cli_out],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seq = tds.load_tum_sequence(tum_dir)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        _, traj, _ = trc.run_system(seq, cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-4000:]
    assert "ATE RMSE" in log
    assert Path(cli_out, "trajectory.log").read_bytes() == \
        Path(cfg.path_output, "trajectory.log").read_bytes()
    assert trc.absolute_trajectory_error(traj, seq.gt_trajectory) < 0.05
