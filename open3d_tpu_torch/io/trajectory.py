"""Camera trajectory IO: Redwood .log and TUM formats (port of
open3d_tpu/io/trajectory.py, which needs no JAX; the port keeps its own
copy, so a file written by either package reads in the other, byte for
byte the same).

Reference surface: io/file_format/FileLOG.cpp (Redwood .log: per-frame
"i j k" header + 4x4 row-major matrix), io/file_format/FileTUM.cpp (TUM:
"timestamp tx ty tz qx qy qz qw"), io/PinholeCameraTrajectoryIO.cpp.
"""

from __future__ import annotations

import numpy as np


def read_trajectory_log(path: str) -> np.ndarray:
    """(N, 4, 4) poses from a Redwood .log file."""
    poses = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        i += 1  # metadata line "a b c"
        M = np.array([[float(x) for x in lines[i + r].split()] for r in range(4)])
        poses.append(M)
        i += 4
    return np.stack(poses).astype(np.float32)


def write_trajectory_log(path: str, poses: np.ndarray) -> None:
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            f.write(f"{i} {i} {i + 1}\n")
            for r in range(4):
                f.write(" ".join(f"{v:.8f}" for v in T[r]) + "\n")


def _quat_to_R(q):
    """qx, qy, qz, qw -> 3x3."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _R_to_quat(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # w ~ 0: pick the dominant diagonal axis
        k = int(np.argmax(np.diag(R)))
        i, j = (k + 1) % 3, (k + 2) % 3
        x_ = np.sqrt(max(0.0, 1.0 + R[k, k] - R[i, i] - R[j, j])) / 2.0
        q = [0.0, 0.0, 0.0]
        q[k] = x_
        q[i] = (R[i, k] + R[k, i]) / (4 * x_)
        q[j] = (R[j, k] + R[k, j]) / (4 * x_)
        x, y, z = q
    return x, y, z, w


def read_trajectory_tum(path: str):
    """Returns (timestamps (N,), poses (N, 4, 4)) from TUM format."""
    ts, poses = [], []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            vals = [float(x) for x in ln.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = _quat_to_R((qx, qy, qz, qw))
            T[:3, 3] = (tx, ty, tz)
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.stack(poses).astype(np.float32)


def write_trajectory_tum(path: str, poses: np.ndarray, timestamps=None) -> None:
    poses = np.asarray(poses)
    if timestamps is None:
        timestamps = np.arange(poses.shape[0], dtype=np.float64)
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses):
            qx, qy, qz, qw = _R_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")
