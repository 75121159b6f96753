"""Port parity: slam_step with raycast_normals=True, the TSDF-gradient
normal map of each frame's raycast feeding the next frame's
point-to-plane tracking, over tests/test_torch_slam.py's four frames at
160x120 (1 cm voxel, ROADMAP.md section 3 fault 4).

Bars: tests/test_slam.py's gates against the truth (pose error < 0.05,
raycast median error < 0.01 m, gross outliers < 0.15), the port's poses
within 0.02 m / 0.02 rad of the JAX package's, and the normal map that
tracking receives is in the camera frame: unit length on hits and facing
the camera's own pixel rays on > 95 % of them, which fails without the
rotation in synthesize_model_frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu.core import lie as jlie
from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.models import dense_slam as jslam
from open3d_tpu_torch.core import lie as tlie
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.models import dense_slam as tslam

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


N_FRAMES = 4
CFG = dict(voxel_size=0.01, block_count=4096, frame_block_capacity=2048, depth_max=6.0,
           raycast_max_steps=120, raycast_normals=True)


@pytest.fixture(scope="module")
def slam_sequence():
    d, c, e, intr = jsyn.render_sequence(6, span=0.25)
    return np.asarray(d), np.asarray(c), np.asarray(e), intr


@pytest.fixture(scope="module")
def slam_runs(slam_sequence):
    d, c, e, intr = slam_sequence
    model = jslam.create_model(jslam.SLAMConfig(**CFG), T_init=jlie.invert_se3(jnp.asarray(e[0])))
    step = jax.jit(lambda m, dd, cc, rd, rn: jslam.slam_step(m, dd, cc, rd, intr, model_normal=rn))
    # frame 0 keeps the initial pose and discards its tracking, so a zero
    # normal map there changes no result and spares JAX a second compile
    rd, rn = jnp.zeros_like(d[0]), jnp.zeros(d[0].shape + (3,), jnp.float32)
    jax_T = []
    for i in range(N_FRAMES):
        res = step(model, d[i], c[i], rd, rn)
        model, rd, rn = res.model, res.raycast_depth, res.raycast_normal
        jax_T.append(np.asarray(model.T_frame_to_world))

    ti = TIntr(intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy)
    model = tslam.create_model(tslam.SLAMConfig(**CFG), T_init=tlie.invert_se3(_t(e[0])),
                               device="cpu")
    rd, rn = torch.zeros(d[0].shape), torch.zeros(d[0].shape + (3,))
    port = []
    for i in range(N_FRAMES):
        res = tslam.slam_step(model, _t(d[i]), _t(c[i]), rd, ti, model_normal=rn)
        model, rd, rn = res.model, res.raycast_depth, res.raycast_normal
        port.append(dict(T=model.T_frame_to_world.numpy().copy(), ray=rd.numpy(),
                         normal=rn.numpy(), ok=bool(res.tracking_ok)))
    return jax_T, port, ti


def test_slam_with_raycast_normals_meets_the_gates(slam_sequence, slam_runs):
    d, _, e, _ = slam_sequence
    jax_T, port, _ = slam_runs
    for i, (Tj, r) in enumerate(zip(jax_T, port)):
        assert r["ok"]
        rot, trans = tlie.pose_distance(_t(r["T"]), tlie.invert_se3(_t(e[i])))
        assert float(rot) < 0.05 and float(trans) < 0.05, (i, float(rot), float(trans))
        rot, trans = tlie.pose_distance(_t(r["T"]), _t(Tj))
        assert float(rot) < 0.02 and float(trans) < 0.02, (i, float(rot), float(trans))
    valid = (port[-1]["ray"] > 0) & (d[N_FRAMES - 1] > 0)
    err = np.abs(port[-1]["ray"] - d[N_FRAMES - 1])[valid]
    assert valid.mean() > 0.5 and np.median(err) < 0.01 and (err > 0.05).mean() < 0.15


def test_slam_normals_are_in_the_camera_frame(slam_runs):
    """Tracking receives camera-frame normals: unit length on hits and
    facing the camera's own pixel rays [x, y, 1] on > 95 % of them."""
    _, port, ti = slam_runs
    r = port[-1]
    hit = r["ray"] > 0
    n = r["normal"][hit]
    assert np.all(np.abs(np.linalg.norm(n, axis=-1) - 1.0) < 1e-3)
    v, u = np.nonzero(hit)
    rays = np.stack([(u - ti.cx) / ti.fx, (v - ti.cy) / ti.fy, np.ones_like(u, float)], -1)
    assert (np.sum(n * rays, axis=-1) <= 1e-6).mean() > 0.95
