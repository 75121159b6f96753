"""The point-to-plane Gauss-Newton iteration (`ops/kernels/point_to_plane.py`):
its plain twin against the eager loop it replaced, the wrapper's checks and
the odometry's counters on the CPU; the two kernels against float64 sums and
a float64 solve on the card.

The CPU tests run everywhere: CPU tensors take the plain path. The card
tests (marker `cuda`) skip without a card; on a machine with one and no JAX
run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gn_kernel.py

Bars. CPU: bit-equality (`torch.equal`) with the eager iteration. Card: the
sums within 1e-5 of the sum of their terms' magnitudes and the valid count
exact, against float64 sums of the plain rows, whose points P are formed in
the kernel's order (so both pick the same nearest pixels); the solve's pose
and RMSE the float64 solve_gn_6x6 + se3_exp, rounded once to float32;
tracking within 1e-6 m and 1e-6 rad of the eager loop in as many
iterations; two runs, and hybrid and intensity odometry, bit for bit.
"""

import numpy as np
import pytest
import torch

from open3d_tpu_torch.core import lie, linalg
from open3d_tpu_torch.data import synthetic
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels import point_to_plane as p2p
from open3d_tpu_torch.pipelines import odometry as odom
from open3d_tpu_torch.utils import timer as tm

LOSS = odom.OdometryLossParams()
XI = torch.tensor([0.012, -0.021, 0.006, 0.018, -0.011, 0.014], dtype=torch.float64)


def holey_frames(n_levels, intr, seed=0, device="cpu", hole_share=0.2):
    """A rendered pair (source = frame 1, target = frame 0 of a short orbit)
    with `hole_share` of the pixels zeroed, and their odometry levels as
    rgbd_odometry_multi_scale builds them, finest first."""
    depths, colors, _, _ = synthetic.render_sequence(2, intrinsic=intr, span=0.1, device=device)
    g = torch.Generator().manual_seed(seed)
    holes = (torch.rand(depths.shape, generator=g) < hole_share).to(depths.device)
    depths = torch.where(holes, 0.0, depths).contiguous()
    src_pyr = im.build_depth_pyramid(depths[1], n_levels)
    tgt_pyr = im.build_depth_pyramid(depths[0], n_levels)
    levels = []
    for lvl in range(n_levels):
        il = intr.scaled(0.5**lvl)
        sv = im.create_vertex_map(im.filter_bilateral_depth(src_pyr[lvl]), il)
        tv = im.create_vertex_map(im.filter_bilateral_depth(tgt_pyr[lvl]), il)
        levels.append(odom._LevelData(sv, None, tv, im.create_normal_map(tv), None, il))
    return depths, colors, levels


def level_of(ld):
    return odom._p2p_level(ld, LOSS)


def eager_rows(ld, T, loss):
    """The point-to-plane rows in the eager loop's signature."""
    return p2p.rows_plain(ld.src_pts, ld.src_valid, ld.tgt_vtx_nrm, T, ld.intr,
                          loss.depth_outlier_trunc, loss.depth_huber_delta)


def eager_iteration(ld, T, monkeypatch):
    """One pass of the eager loop `_gn_level` with the point-to-plane rows:
    (its T, the RMSE it reads)."""
    reads = []
    monkeypatch.setattr(odom, "host_read", lambda site, x: reads.append(x) or x.item())
    T = odom._gn_level(ld, T, eager_rows, odom.OdometryConvergenceCriteria(1), LOSS)
    monkeypatch.undo()
    return T, reads[0]


def eager_odometry(monkeypatch):
    """Route point-to-plane odometry through the eager loop and plain final
    sums on any device."""
    def loop(ld, T, criteria, loss):
        return odom._gn_level(ld, T, eager_rows, criteria, loss)

    monkeypatch.setattr(odom, "_gn_level_point_to_plane", loop)
    monkeypatch.setattr(p2p, "residual_sums", p2p.residual_sums_plain)


# ---- CPU: the plain path --------------------------------------------------

INTR_CPU = PinholeCameraIntrinsic(160, 120, 131.25, 131.25, 79.5, 59.5)


@pytest.fixture(scope="module")
def cpu_frames():
    return holey_frames(2, INTR_CPU, seed=1)


@pytest.mark.parametrize("lvl", [0, 1])
@pytest.mark.parametrize("pose", ["identity", "moved"])
def test_twin_is_the_eager_iteration(cpu_frames, lvl, pose, monkeypatch):
    """iterate on CPU tensors (the twin) gives the eager loop's pose and
    RMSE bit for bit, and counts no launch."""
    ld = cpu_frames[2][lvl]
    T0 = torch.eye(4) if pose == "identity" else lie.se3_exp(XI).float()
    want_T, want_rmse = eager_iteration(ld, T0.clone(), monkeypatch)
    T = T0.clone()
    n = _build.launch_counts()
    rmse = p2p.iterate(level_of(ld), T)
    assert torch.equal(T, want_T) and torch.equal(rmse, want_rmse)
    assert _build.launch_counts() == n


def test_cpu_tensors_take_the_plain_path(cpu_frames):
    """The wrapper's CPU path is iterate_plain and residual_sums_plain."""
    ld = cpu_frames[2][0]
    T0 = lie.se3_exp(XI).float()
    lv = level_of(ld)
    n = _build.launch_counts()
    T, T_plain = T0.clone(), T0.clone()
    assert torch.equal(p2p.iterate(lv, T), p2p.iterate_plain(lv, T_plain))
    assert torch.equal(T, T_plain) and not torch.equal(T, T0)
    for a, b in zip(p2p.residual_sums(lv, T), p2p.residual_sums_plain(lv, T)):
        assert torch.equal(a, b)
    assert _build.launch_counts() == n


@pytest.mark.parametrize("init", [None, "moved"])
def test_odometry_is_the_eager_loop_on_the_cpu(cpu_frames, init, monkeypatch):
    """rgbd_odometry_multi_scale's point-to-plane result on CPU tensors is
    the eager loop's bit for bit, and the caller's init is not written."""
    depths = cpu_frames[0]
    src = RGBDImage(color=torch.zeros_like(depths[1]), depth=depths[1])
    tgt = RGBDImage(color=torch.zeros_like(depths[0]), depth=depths[0])
    T0 = None if init is None else lie.se3_exp(XI * 0.1).float()
    keep = None if T0 is None else T0.clone()
    got = odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, init=T0, method=odom.POINT_TO_PLANE)
    assert T0 is None or torch.equal(T0, keep)
    eager_odometry(monkeypatch)
    want = odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, init=T0, method=odom.POINT_TO_PLANE)
    for a, b in zip(got.__dict__.values(), want.__dict__.values()):
        assert torch.equal(a, b)


def _good_inputs():
    n = 48
    return {"src_pts": torch.rand((n, 3)), "src_valid": torch.ones(n, dtype=torch.bool),
            "tgt_vtx_nrm": torch.rand((6, 8, 6)), "T": torch.eye(4)}


@pytest.mark.parametrize("field,bad,err", [
    ("src_pts", lambda t: t.double(), TypeError),
    ("src_pts", lambda t: t[:, :2].contiguous(), ValueError),
    ("src_pts", lambda t: t.t().contiguous().t(), ValueError),  # non-contiguous
    ("src_valid", lambda t: t.to(torch.uint8), TypeError),
    ("src_valid", lambda t: t[:-1], ValueError),
    ("tgt_vtx_nrm", lambda t: t.half(), TypeError),
    ("tgt_vtx_nrm", lambda t: t[..., :3].contiguous(), ValueError),
    ("tgt_vtx_nrm", lambda t: t.reshape(48, 6), ValueError),
    ("T", lambda t: t.double(), TypeError),
    ("T", lambda t: t[:3].contiguous(), ValueError),
    ("T", lambda t: t.to("meta"), ValueError),
    ("src_pts", lambda t: t.to("meta"), ValueError),  # a device with no kernel
], ids=["src_float64", "src_2_columns", "src_non_contiguous", "valid_uint8", "valid_short",
        "tgt_float16", "tgt_3_channels", "tgt_2d", "T_float64", "T_3x4", "T_elsewhere",
        "meta_device"])
def test_wrapper_refuses_bad_inputs(field, bad, err):
    args = _good_inputs()
    args[field] = bad(args[field])
    if field == "src_pts" and args[field].device.type == "meta":
        args = {k: v.to("meta") for k, v in args.items()}
    n = _build.launch_counts()
    with pytest.raises(err):
        lv = p2p.Level(args["src_pts"], args["src_valid"], args["tgt_vtx_nrm"], INTR_CPU,
                       0.07, 0.05)
        p2p.iterate(lv, args["T"])
    assert _build.launch_counts() == n


@pytest.mark.parametrize("method", [odom.POINT_TO_PLANE, odom.HYBRID, odom.INTENSITY])
def test_kernel_counter_reads_zero_on_the_cpu(cpu_frames, method):
    """The recorder counts Gauss-Newton passes, and the solve kernel no
    launch, for every method on CPU tensors."""
    depths, colors = cpu_frames[0], cpu_frames[1]
    src = RGBDImage(color=colors[1], depth=depths[1])
    tgt = RGBDImage(color=colors[0], depth=depths[0])
    solves = _build.launch_counts()["o3dt_p2p_solve"]
    tm.disable()
    tm.drain()
    tm.enable()
    try:
        odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, method=method)
    finally:
        tm.disable()
    counts = tm.drain()[1]
    assert counts["odometry.gn_iterations"] >= 3
    assert _build.launch_counts()["o3dt_p2p_solve"] == solves


# ---- the card: the kernels --------------------------------------------------

INTR = PinholeCameraIntrinsic.prime_sense_default()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(cuda):
    return holey_frames(3, INTR, seed=2, device=cuda)


@pytest.fixture(scope="module")
def stride2_frames(cuda):
    return holey_frames(3, INTR.scaled(0.5), seed=3, device=cuda)


def kernel_order_transform(T, pts):
    """lie.transform_points with each coordinate formed as the kernel forms
    it: ((R_i0 p0 + R_i1 p1) + R_i2 p2) + t_i, every operation rounded."""
    cols = [((T[i, 0] * pts[:, 0] + T[i, 1] * pts[:, 1]) + T[i, 2] * pts[:, 2]) + T[i, 3]
            for i in range(3)]
    return torch.stack(cols, dim=-1)


def float64_sums(ld, T, monkeypatch):
    """(the 28 sums in the kernel's layout and their magnitudes' sums, in
    float64, the valid count) of the plain rows at T."""
    monkeypatch.setattr(lie, "transform_points", kernel_order_transform)
    J, r, w, valid = eager_rows(ld, T, LOSS)
    monkeypatch.undo()
    J, r, w = J.double(), r.double(), w.double()
    Jw = J * w[:, None]
    terms = [Jw[:, j] * J[:, k] for j in range(6) for k in range(j, 6)]
    terms += [Jw[:, j] * r for j in range(6)] + [torch.where(w > 0, r * r, 0.0)]
    terms = torch.stack(terms, dim=-1)
    return terms.sum(0), terms.abs().sum(0), int(valid.sum())


def check_sums(lv, ld, T, monkeypatch):
    sum_r2, n_valid = p2p.residual_sums(lv, T)
    torch.cuda.synchronize()
    got = lv.partials[:, :28].double().sum(0)
    count = int(lv.partials.view(torch.int32)[:, p2p.COUNT].sum())
    want, mag, want_count = float64_sums(ld, T, monkeypatch)
    assert count == want_count == int(n_valid)
    err = (got - want).abs()
    assert bool((err <= 1e-5 * mag).all()), (err / mag.clamp(min=1e-300)).max()
    assert abs(float(sum_r2) - float(want[27])) <= 1e-5 * float(mag[27])
    return count


class TestOnCard:
    pytestmark = pytest.mark.cuda

    @pytest.mark.parametrize("lvl", [0, 1, 2], ids=["640x480", "320x240", "160x120"])
    @pytest.mark.parametrize("pose", ["identity", "moved"])
    def test_sums_match_float64_sums_of_the_plain_rows(self, card_frames, lvl, pose, monkeypatch):
        ld = card_frames[2][lvl]
        T = torch.eye(4, device=ld.src_pts.device)
        if pose == "moved":
            T = lie.se3_exp(XI).float().to(T.device)
        assert check_sums(level_of(ld), ld, T, monkeypatch) > 0.2 * ld.src_pts.shape[0]

    @pytest.mark.parametrize("lvl", [0, 1, 2], ids=["320x240", "160x120", "80x60"])
    def test_sums_at_stride_2(self, stride2_frames, lvl, monkeypatch):
        ld = stride2_frames[2][lvl]
        T = lie.se3_exp(XI * 0.5).float().to(ld.src_pts.device)
        assert check_sums(level_of(ld), ld, T, monkeypatch) > 0

    @pytest.mark.parametrize("which", ["source", "target"])
    def test_all_pixels_invalid(self, card_frames, which, monkeypatch):
        """No valid pixel: zero sums and count, and the solve leaves T as it
        is (xi = 0) with an RMSE of 0."""
        ld = card_frames[2][0]
        src, tgt = ld.src_pts, ld.tgt_vtx_nrm
        if which == "source":
            src = torch.zeros_like(src)
        else:
            tgt = torch.zeros_like(tgt)
        lv = p2p.Level(src, src[:, 2] > 0, tgt, ld.intr, 0.07, 0.05)
        T0 = lie.se3_exp(XI).float().to(src.device)
        T = T0.clone()
        rmse = p2p.iterate(lv, T)
        torch.cuda.synchronize()
        assert int(lv.partials.view(torch.int32)[:, p2p.COUNT].sum()) == 0
        assert float(lv.partials[:, :28].abs().sum()) == 0.0
        assert torch.equal(T, T0) and float(rmse) == 0.0

    @pytest.mark.parametrize("size", [1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1])
    def test_solve_matches_float64(self, card_frames, size):
        """The solve kernel on sums whose step xi has |xi| = size, spread
        over three rows of partials: T and the RMSE are the float64
        solve_gn_6x6 + se3_exp's, rounded once to float32."""
        dev = card_frames[2][0].src_pts.device
        rng = np.random.default_rng(int(size * 1e6) + 7)
        B = rng.standard_normal((40, 6))
        A = B.T @ B + np.diag([4.0, 9.0, 2.0, 30.0, 50.0, 80.0])
        step = rng.standard_normal(6)
        step *= size / np.linalg.norm(step[:3])
        lam = 1e-6 * max(np.diag(A).max(), 1.0)
        g = -(A + lam * np.eye(6)) @ step
        tot = np.concatenate([[A[j, k] for j in range(6) for k in range(j, 6)], g, [0.37]])
        shares = rng.dirichlet(np.ones(3))
        rows = np.zeros((3, p2p.ROW), dtype=np.float32)
        rows[:, :28] = (shares[:, None] * tot[None, :]).astype(np.float32)
        lv = p2p.Level(*(t.contiguous() for t in (
            card_frames[2][2].src_pts, card_frames[2][2].src_valid, card_frames[2][2].tgt_vtx_nrm)),
            card_frames[2][2].intr, 0.07, 0.05)
        part = torch.from_numpy(rows)
        part.view(torch.int32)[:, p2p.COUNT] = torch.tensor([900, 1200, 300], dtype=torch.int32)
        lv.partials = part.to(dev)
        lv.n_blocks = 3
        T0 = lie.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.5, -0.7, 1.2], dtype=torch.float64))
        T = T0.float().to(dev)
        T_in = T.double().cpu()
        p2p._launch_solve(lv, T)
        torch.cuda.synchronize()
        s = part[:, :28].double().sum(0)
        JtJ = torch.zeros((6, 6), dtype=torch.float64)
        iu = torch.triu_indices(6, 6)
        JtJ[iu[0], iu[1]] = s[:21]
        JtJ[iu[1], iu[0]] = s[:21]
        xi = linalg.solve_gn_6x6(JtJ, s[21:27])
        assert abs(float(xi[:3].norm()) / size - 1.0) < 1e-3
        want = lie.se3_exp(xi) @ T_in
        got = T.double().cpu()
        half_ulp = 0.5 * np.spacing(np.abs(want.numpy()).astype(np.float32)).astype(np.float64)
        assert bool(((got - want).abs().numpy() <= half_ulp + 1e-13).all())
        want_rmse = float(np.sqrt(s[27].item() / 2400.0))
        assert abs(float(lv.rmse) - want_rmse) <= 0.5 * np.spacing(np.float32(want_rmse)) + 1e-13

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("normals", [False, True])
    def test_tracking_matches_the_eager_loop(self, cuda, stride, normals, monkeypatch):
        """track_frame_to_model through the kernels against the same call on
        the eager loop: within 1e-6 m and 1e-6 rad, in as many iterations,
        with two launches a kernel iteration and one for the final metrics."""
        from open3d_tpu_torch.models import dense_slam

        depths, _, _, intr = synthetic.render_sequence(2, intrinsic=INTR, span=0.1, device=cuda)
        cfg = dense_slam.SLAMConfig(block_count=1024, model_raycast_stride=stride)
        model = dense_slam.create_model(cfg, device=cuda)
        target = depths[0].contiguous()
        for _ in range(stride.bit_length() - 1):
            target = im.pyrdown_depth(target)
        nrm = None
        if normals:
            tv = im.create_vertex_map(target, intr.scaled(1.0 / stride))
            nrm = im.create_normal_map(tv)

        def run():
            tm.disable()
            tm.drain()
            tm.enable()
            try:
                res = dense_slam.track_frame_to_model(model, depths[1].contiguous(), target, intr,
                                                      model_normals=nrm)
            finally:
                tm.disable()
            return res, tm.drain()[1]

        n = _build.launch_counts()
        got, counts = run()
        its = counts["odometry.gn_iterations"]
        launched = _build.launch_counts() - n
        assert launched["o3dt_p2p_solve"] == its
        assert (launched["o3dt_p2p_sums"], launched["o3dt_p2p_solve"]) == (its + 1, its)
        eager_odometry(monkeypatch)
        n = _build.launch_counts()
        want, eager_counts = run()
        assert eager_counts["odometry.gn_iterations"] == its
        assert (_build.launch_counts() - n)["o3dt_p2p_solve"] == 0
        rot, trans = lie.pose_distance(got.transformation.double(), want.transformation.double())
        assert float(rot) <= 1e-6 and float(trans) <= 1e-6, (float(rot), float(trans))
        assert abs(float(got.fitness) - float(want.fitness)) <= 1e-4
        assert abs(float(got.inlier_rmse) - float(want.inlier_rmse)) <= 1e-4 * float(
            want.inlier_rmse)

    def test_two_runs_give_the_same_bits(self, card_frames):
        depths = card_frames[0]
        src = RGBDImage(color=torch.zeros_like(depths[1]), depth=depths[1])
        tgt = RGBDImage(color=torch.zeros_like(depths[0]), depth=depths[0])
        a = odom.rgbd_odometry_multi_scale(src, tgt, INTR, method=odom.POINT_TO_PLANE)
        b = odom.rgbd_odometry_multi_scale(src, tgt, INTR, method=odom.POINT_TO_PLANE)
        for x, y in zip(a.__dict__.values(), b.__dict__.values()):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("method", [odom.HYBRID, odom.INTENSITY])
    def test_hybrid_and_intensity_take_no_kernel(self, card_frames, method, monkeypatch):
        """The other methods run the eager loop alone: no launch, and the
        same bits with every point-to-plane entry made to raise."""
        depths, colors = card_frames[0], card_frames[1]
        src = RGBDImage(color=colors[1], depth=depths[1])
        tgt = RGBDImage(color=colors[0], depth=depths[0])
        n = _build.launch_counts()
        a = odom.rgbd_odometry_multi_scale(src, tgt, INTR, method=method)

        def refuse(*a, **k):
            raise AssertionError("the point-to-plane path ran")

        for mod, name in ((odom, "_gn_level_point_to_plane"), (p2p, "iterate"),
                          (p2p, "residual_sums"), (p2p, "Level")):
            monkeypatch.setattr(mod, name, refuse)
        b = odom.rgbd_odometry_multi_scale(src, tgt, INTR, method=method)
        launched = _build.launch_counts() - n
        assert (launched["o3dt_p2p_sums"], launched["o3dt_p2p_solve"]) == (0, 0)
        for x, y in zip(a.__dict__.values(), b.__dict__.values()):
            assert torch.equal(x, y)
