"""Point-to-plane's level maps (`ops/kernels/point_to_plane.py`: `maps`,
`maps_plain`, the maps kernel in `csrc/point_to_plane.cu`): the plain twin
against the eager composition it replaced, the odometry against the eager
level data it built before (`_LevelData` at every level and at the final
metrics), the wrapper's checks and the launch counter on the CPU; the
kernel against `maps_plain` on the card.

The CPU tests run everywhere: CPU tensors take the plain path. The card
tests (marker `cuda`) skip without a card; on a machine with one and no JAX
run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_p2p_maps.py

Bars: bit-equality (`torch.equal`) everywhere. On the card the kernel
repeats the eager operations in their order (the module's Rounding
paragraph), so its maps, and the odometry that reads them, are the eager
ones bit for bit.
"""

import pytest
import torch

from open3d_tpu_torch.core import lie
from open3d_tpu_torch.data import synthetic
from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.geometry.rgbd import RGBDImage
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels import point_to_plane as p2p
from open3d_tpu_torch.pipelines import odometry as odom

from test_torch_gn_kernel import INTR_CPU, XI, holey_frames

LOSS = odom.OdometryLossParams()


def maps_launches() -> int:
    return _build.launch_counts()["o3dt_p2p_maps"]


def level_depths(depths, intr, n_levels):
    """The (source, target) depths of each level as the odometry hands them
    to the maps (bilateral-filtered pyramids of frames 1 and 0), the given
    normal map of each level (the pyramid of frame 0's computed normals, as
    a raycast's would be), and each level's intrinsic, finest first."""
    src_pyr = im.build_depth_pyramid(depths[1].contiguous(), n_levels)
    tgt_pyr = im.build_depth_pyramid(depths[0].contiguous(), n_levels)
    nrm_pyr = im.build_normal_pyramid(
        im.create_normal_map(im.create_vertex_map(depths[0], intr)), n_levels)
    return [(im.filter_bilateral_depth(s), im.filter_bilateral_depth(t), n, intr.scaled(0.5**lvl))
            for lvl, (s, t, n) in enumerate(zip(src_pyr, tgt_pyr, nrm_pyr))]


def eager_maps(sd, td, intr, nrm=None):
    """The maps as the odometry built them before the kernel: the eager
    vertex and normal maps, packed by `_LevelData`."""
    tgt_vtx = im.create_vertex_map(td, intr)
    ld = odom._LevelData(im.create_vertex_map(sd, intr), None, tgt_vtx,
                         im.create_normal_map(tgt_vtx) if nrm is None else nrm, None, intr)
    return ld.src_pts, ld.src_valid, ld.tgt_vtx_nrm


def assert_same(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def eager_odometry(source, target, intrinsic, init=None, method=odom.HYBRID,
                   criteria=(odom.OdometryConvergenceCriteria(6), odom.OdometryConvergenceCriteria(3),
                             odom.OdometryConvergenceCriteria(1)),
                   target_normals=None):
    """rgbd_odometry_multi_scale as it ran before the maps kernel: the
    eager level data (`_LevelData`) at every level and at the final metrics,
    for every method; point-to-plane then iterates on a `p2p.Level` of its
    rows, the other methods run `_gn_level`."""
    n_levels = len(criteria)
    use_intensity = method in (odom.INTENSITY, odom.HYBRID)
    src_pyr = im.build_depth_pyramid(source.depth, n_levels)
    tgt_pyr = im.build_depth_pyramid(target.depth, n_levels)
    nrm_pyr = (im.build_normal_pyramid(target_normals, n_levels)
               if target_normals is not None else None)
    src_int = im.build_intensity_pyramid(source.color, n_levels) if use_intensity else None
    tgt_int = im.build_intensity_pyramid(target.color, n_levels) if use_intensity else None
    dev = source.depth.device
    T = torch.eye(4, device=dev) if init is None else init.to(device=dev, copy=True)

    def level_data(sd, td, lvl, intr):
        tgt_vtx = im.create_vertex_map(td, intr)
        return odom._LevelData(
            im.create_vertex_map(sd, intr), src_int[lvl] if use_intensity else None, tgt_vtx,
            nrm_pyr[lvl] if nrm_pyr is not None else im.create_normal_map(tgt_vtx),
            tgt_int[lvl] if use_intensity else None, intr)

    def p2p_level(ld):
        return p2p.Level(ld.src_pts, ld.src_valid, ld.tgt_vtx_nrm, ld.intr,
                         LOSS.depth_outlier_trunc, LOSS.depth_huber_delta)

    for lvl in reversed(range(n_levels)):
        intr = intrinsic.scaled(0.5**lvl)
        ld = level_data(im.filter_bilateral_depth(src_pyr[lvl]),
                        im.filter_bilateral_depth(tgt_pyr[lvl]), lvl, intr)
        crit = criteria[n_levels - 1 - lvl]
        if method == odom.POINT_TO_PLANE:
            lv, prev = p2p_level(ld), None
            for it in range(crit.max_iteration):
                rmse = p2p.iterate(lv, T).item()
                if it > 0 and abs(prev - rmse) < crit.relative_rmse:
                    break
                prev = rmse
        else:
            T = odom._gn_level(ld, T, odom._ROWS[method], crit, LOSS)
    ld = level_data(src_pyr[0], tgt_pyr[0], 0, intrinsic)
    if method == odom.POINT_TO_PLANE:
        sum_r2, n_in = p2p.residual_sums(p2p_level(ld), T)
    else:
        _, r, w, valid = odom._ROWS[method](ld, T, LOSS)
        sum_r2 = torch.sum(torch.where(w > 0, r * r, 0.0))
        n_in = torch.sum(valid.to(torch.float32))
    n_src = torch.clamp(torch.sum(ld.src_valid.to(torch.float32)), min=1.0)
    rmse = torch.sqrt(sum_r2 / torch.clamp(n_in, min=1.0))
    return odom.OdometryResult(transformation=T, fitness=n_in / n_src, inlier_rmse=rmse)


def odometry_pair(depths, colors, normals: bool, intr):
    src = RGBDImage(color=colors[1], depth=depths[1].contiguous())
    tgt = RGBDImage(color=colors[0], depth=depths[0].contiguous())
    nrm = im.create_normal_map(im.create_vertex_map(tgt.depth, intr)) if normals else None
    return src, tgt, nrm


# ---- CPU: the plain path --------------------------------------------------


@pytest.fixture(scope="module")
def cpu_frames():
    return holey_frames(3, INTR_CPU, seed=4)


@pytest.fixture(scope="module")
def cpu_levels(cpu_frames):
    return level_depths(cpu_frames[0], INTR_CPU, 3)


@pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
@pytest.mark.parametrize("lvl", [0, 1, 2], ids=["160x120", "80x60", "40x30"])
def test_plain_twin_is_the_eager_composition(cpu_levels, lvl, normals):
    """maps_plain, and maps on CPU tensors, give create_vertex_map's points
    and validity and the packed vertex + normal rows (create_normal_map's
    normals, or the given ones) bit for bit, with no launch."""
    sd, td, nrm, intr = cpu_levels[lvl]
    nrm = nrm if normals else None
    want = eager_maps(sd, td, intr, nrm)
    n = maps_launches()
    assert_same(p2p.maps_plain(sd, td, intr, nrm), want)
    assert_same(p2p.maps(sd, td, intr, nrm), want)
    assert maps_launches() == n
    assert int(want[1].sum()) > 0.5 * want[1].numel()


@pytest.mark.parametrize("method", [odom.POINT_TO_PLANE, odom.HYBRID, odom.INTENSITY])
@pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
@pytest.mark.parametrize("init", [None, "moved"])
def test_odometry_is_the_eager_level_data_on_the_cpu(cpu_frames, method, normals, init):
    """rgbd_odometry_multi_scale on CPU tensors gives, bit for bit, what it
    gave when every method built `_LevelData` at every level and at the
    final metrics, for each method, with and without given normals."""
    src, tgt, nrm = odometry_pair(cpu_frames[0], cpu_frames[1], normals, INTR_CPU)
    T0 = None if init is None else lie.se3_exp(XI * 0.1).float()
    crit = (odom.OdometryConvergenceCriteria(6), odom.OdometryConvergenceCriteria(3),
            odom.OdometryConvergenceCriteria(1))
    got = odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, init=T0, method=method,
                                         criteria=crit, target_normals=nrm)
    want = eager_odometry(src, tgt, INTR_CPU, init=T0, method=method, criteria=crit,
                          target_normals=nrm)
    for a, b in zip(got.__dict__.values(), want.__dict__.values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", [odom.POINT_TO_PLANE, odom.HYBRID, odom.INTENSITY])
def test_maps_counter_reads_zero_on_the_cpu(cpu_frames, method):
    """No method launches the maps kernel on CPU tensors."""
    src, tgt, _ = odometry_pair(cpu_frames[0], cpu_frames[1], False, INTR_CPU)
    n = maps_launches()
    odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, method=method)
    assert maps_launches() == n


@pytest.mark.parametrize("method", [odom.HYBRID, odom.INTENSITY])
def test_hybrid_and_intensity_take_no_maps(cpu_frames, method, monkeypatch):
    """Hybrid and intensity never reach the maps: with `maps` and
    `maps_plain` made to raise they give the same bits."""
    src, tgt, _ = odometry_pair(cpu_frames[0], cpu_frames[1], False, INTR_CPU)
    want = odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, method=method)

    def refuse(*a, **k):
        raise AssertionError("the point-to-plane maps ran")

    monkeypatch.setattr(p2p, "maps", refuse)
    monkeypatch.setattr(p2p, "maps_plain", refuse)
    got = odom.rgbd_odometry_multi_scale(src, tgt, INTR_CPU, method=method)
    for a, b in zip(got.__dict__.values(), want.__dict__.values()):
        assert torch.equal(a, b)


def strided(t):
    """t's values in a non-contiguous view: the left columns of a wider
    image."""
    wide = torch.zeros((t.shape[0], t.shape[1] + 3, *t.shape[2:]), dtype=t.dtype, device=t.device)
    view = wide[:, :t.shape[1]]
    view.copy_(t)
    assert not view.is_contiguous()
    return view


def strided_odometry(depths, colors, normals, intr, bilateral_filter):
    """Point-to-plane odometry of a pair given as contiguous images and as
    strided views of the same values (depths and given normals): (the
    contiguous result, the strided one)."""
    src, tgt, nrm = odometry_pair(depths, colors, normals, intr)
    crit = (odom.OdometryConvergenceCriteria(6), odom.OdometryConvergenceCriteria(3),
            odom.OdometryConvergenceCriteria(1))

    def run(s, t, n):
        return odom.rgbd_odometry_multi_scale(s, t, intr, method=odom.POINT_TO_PLANE,
                                              criteria=crit, target_normals=n,
                                              bilateral_filter=bilateral_filter)

    want = run(src, tgt, nrm)
    got = run(RGBDImage(color=src.color, depth=strided(src.depth)),
              RGBDImage(color=tgt.color, depth=strided(tgt.depth)),
              None if nrm is None else strided(nrm))
    return want, got


@pytest.mark.parametrize("bilateral_filter", [True, False], ids=["filtered", "unfiltered"])
@pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
def test_odometry_takes_strided_images_on_the_cpu(cpu_frames, normals, bilateral_filter):
    """Point-to-plane takes depths and given normals that are strided views,
    as it did when it built the eager vertex maps, and gives the bits of
    the same values laid out contiguously."""
    want, got = strided_odometry(cpu_frames[0], cpu_frames[1], normals, INTR_CPU,
                                 bilateral_filter)
    for a, b in zip(got.__dict__.values(), want.__dict__.values()):
        assert torch.equal(a, b)


def _good_maps_inputs():
    return {"src_depth": torch.rand((6, 8)), "tgt_depth": torch.rand((6, 8)),
            "tgt_normals": torch.rand((6, 8, 3))}


@pytest.mark.parametrize("field,bad,err", [
    ("src_depth", lambda t: t.double(), TypeError),
    ("src_depth", lambda t: t.t().contiguous().t(), ValueError),  # non-contiguous
    ("src_depth", lambda t: t.reshape(48), ValueError),
    ("src_depth", lambda t: t[:0], ValueError),  # empty
    ("tgt_depth", lambda t: t.half(), TypeError),
    ("tgt_depth", lambda t: t[None], ValueError),  # 3-D
    ("tgt_depth", lambda t: t[:, :0], ValueError),  # empty
    ("tgt_depth", lambda t: t[:, ::2], ValueError),  # non-contiguous
    ("tgt_depth", lambda t: t.to("meta"), ValueError),  # another device
    ("tgt_normals", lambda t: t.double(), TypeError),
    ("tgt_normals", lambda t: t[..., :2].contiguous(), ValueError),
    ("tgt_normals", lambda t: t[:, :7].contiguous(), ValueError),  # not the target's shape
    ("tgt_normals", lambda t: t.permute(1, 0, 2).contiguous().permute(1, 0, 2), ValueError),
    ("tgt_normals", lambda t: t.to("meta"), ValueError),
    ("src_depth", lambda t: t.to("meta"), ValueError),  # a device with no kernel
], ids=["src_float64", "src_non_contiguous", "src_1d", "src_empty", "tgt_float16", "tgt_3d",
        "tgt_empty", "tgt_non_contiguous", "tgt_elsewhere", "normals_float64",
        "normals_2_channels", "normals_not_the_targets_shape", "normals_non_contiguous",
        "normals_elsewhere", "meta_device"])
def test_maps_wrapper_refuses_bad_inputs(field, bad, err):
    args = _good_maps_inputs()
    args[field] = bad(args[field])
    if field == "src_depth" and args[field].device.type == "meta":
        args = {k: v.to("meta") for k, v in args.items()}
    n = maps_launches()
    with pytest.raises(err):
        p2p.maps(args["src_depth"], args["tgt_depth"], INTR_CPU, args["tgt_normals"])
    assert maps_launches() == n


def test_maps_wrapper_accepts_good_inputs():
    args = _good_maps_inputs()
    for nrm in (None, args["tgt_normals"]):
        pts, valid, rows = p2p.maps(args["src_depth"], args["tgt_depth"], INTR_CPU, nrm)
        assert (pts.shape, valid.shape, rows.shape) == ((48, 3), (48,), (6, 8, 6))
        assert valid.dtype == torch.bool and rows.dtype == pts.dtype == torch.float32


@pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
@pytest.mark.parametrize("which", ["finer_target", "finer_source"])
def test_source_and_target_of_two_shapes(cpu_levels, which, normals):
    """A SLAM step's first model depth is the frame's, not the raycast's: at
    model stride 2 the target is twice the source's size. The maps take
    each at its own shape, as the eager composition did."""
    (s0, t0, n0, intr), (s1, t1, n1, _) = cpu_levels[0], cpu_levels[1]
    sd, td, nrm = (s1, t0, n0) if which == "finer_target" else (s0, t1, n1)
    nrm = nrm if normals else None
    assert_same(p2p.maps(sd, td, intr, nrm), eager_maps(sd, td, intr, nrm))


# ---- the card: the kernel ---------------------------------------------------

INTR = PinholeCameraIntrinsic.prime_sense_default()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(cuda):
    return holey_frames(3, INTR, seed=5, device=cuda)


@pytest.fixture(scope="module")
def card_levels(card_frames):
    return level_depths(card_frames[0], INTR, 3)


@pytest.fixture(scope="module")
def stride2_levels(cuda):
    return level_depths(holey_frames(3, INTR.scaled(0.5), seed=6, device=cuda)[0],
                        INTR.scaled(0.5), 3)


def check_kernel(sd, td, intr, nrm):
    """One launch of the maps kernel against maps_plain on the card."""
    n = maps_launches()
    got = p2p.maps(sd, td, intr, nrm)
    assert maps_launches() == n + 1
    want = p2p.maps_plain(sd, td, intr, nrm)
    torch.cuda.synchronize()
    assert_same(got, want)
    return got


class TestOnCard:
    pytestmark = pytest.mark.cuda

    @pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
    @pytest.mark.parametrize("lvl", [0, 1, 2], ids=["640x480", "320x240", "160x120"])
    def test_kernel_is_the_plain_twin(self, card_levels, lvl, normals):
        sd, td, nrm, intr = card_levels[lvl]
        got = check_kernel(sd, td, intr, nrm if normals else None)
        assert int(got[1].sum()) > 0.5 * got[1].numel()
        assert int((got[2][..., 3:] != 0).any(-1).sum()) > 0.3 * got[1].numel()

    @pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
    @pytest.mark.parametrize("lvl", [0, 1, 2], ids=["320x240", "160x120", "80x60"])
    def test_kernel_at_stride_2(self, stride2_levels, lvl, normals):
        sd, td, nrm, intr = stride2_levels[lvl]
        check_kernel(sd, td, intr, nrm if normals else None)

    @pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
    @pytest.mark.parametrize("which", ["finer_target", "finer_source"])
    def test_source_and_target_of_two_shapes(self, card_levels, which, normals):
        (s0, t0, n0, intr), (s1, t1, n1, _) = card_levels[0], card_levels[1]
        sd, td, nrm = (s1, t0, n0) if which == "finer_target" else (s0, t1, n1)
        check_kernel(sd, td, intr, nrm if normals else None)

    def test_all_invalid_depths(self, card_levels):
        """Depths of 0, negative and NaN: every output 0 and nothing valid."""
        sd, td, _, intr = card_levels[0]
        for fill in (0.0, -1.0, float("nan")):
            z = torch.full_like(sd, fill)
            pts, valid, rows = check_kernel(z, z, intr, None)
            assert not bool(valid.any()) and not bool(pts.any()) and not bool(rows.any())

    def test_all_valid_depths(self, cuda):
        """A tilted plane seen whole: every source pixel valid, every target
        normal but the last row's and column's of unit length and facing the
        camera."""
        H, W = INTR.height, INTR.width
        yy, xx = torch.meshgrid(torch.arange(H, device=cuda), torch.arange(W, device=cuda),
                                indexing="ij")
        plane = (1.2 + 0.0007 * xx + 0.0004 * yy).to(torch.float32).contiguous()
        pts, valid, rows = check_kernel(plane, plane, INTR, None)
        assert bool(valid.all())
        n, v = rows[:-1, :-1, 3:], rows[:-1, :-1, :3]
        assert bool(((n * n).sum(-1) - 1.0).abs().max() < 1e-5)
        assert bool(((n * v).sum(-1) < 0).all())
        assert not bool(rows[-1, :, 3:].any()) and not bool(rows[:, -1, 3:].any())

    def test_two_runs_give_the_same_bits(self, card_levels):
        sd, td, nrm, intr = card_levels[0]
        for given in (None, nrm):
            assert_same(p2p.maps(sd, td, intr, given), p2p.maps(sd, td, intr, given))

    @pytest.mark.parametrize("method", [odom.POINT_TO_PLANE, odom.HYBRID, odom.INTENSITY])
    @pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
    def test_odometry_is_the_eager_level_data(self, card_frames, method, normals):
        """rgbd_odometry_multi_scale on the card gives, bit for bit, what it
        gave with the eager level data; point-to-plane launches the maps
        kernel at each level and for the final metrics (4), hybrid and
        intensity never."""
        src, tgt, nrm = odometry_pair(card_frames[0], card_frames[1], normals, INTR)
        crit = (odom.OdometryConvergenceCriteria(6), odom.OdometryConvergenceCriteria(3),
                odom.OdometryConvergenceCriteria(1))
        n = maps_launches()
        got = odom.rgbd_odometry_multi_scale(src, tgt, INTR, method=method, criteria=crit,
                                             target_normals=nrm)
        assert maps_launches() - n == (4 if method == odom.POINT_TO_PLANE else 0)
        want = eager_odometry(src, tgt, INTR, method=method, criteria=crit, target_normals=nrm)
        for a, b in zip(got.__dict__.values(), want.__dict__.values()):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("bilateral_filter", [True, False], ids=["filtered", "unfiltered"])
    @pytest.mark.parametrize("normals", [False, True], ids=["computed_normals", "given_normals"])
    def test_odometry_takes_strided_images(self, card_frames, normals, bilateral_filter):
        """Strided views of the depths and given normals launch the kernel
        4 times and give the contiguous images' bits."""
        n = maps_launches()
        want, got = strided_odometry(card_frames[0], card_frames[1], normals, INTR,
                                     bilateral_filter)
        assert maps_launches() - n == 8
        for a, b in zip(got.__dict__.values(), want.__dict__.values()):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("stride", [1, 2])
    def test_four_maps_launches_a_tracked_frame(self, cuda, stride):
        """slam_step's track launches the maps kernel once a level and once
        for the final metrics: 4 a frame at the default 3 levels."""
        from open3d_tpu_torch.models import dense_slam

        depths, colors, _, intr = synthetic.render_sequence(3, intrinsic=INTR, span=0.1,
                                                            device=cuda)
        cfg = dense_slam.SLAMConfig(block_count=1024, model_raycast_stride=stride)
        model = dense_slam.create_model(cfg, device=cuda)
        md = torch.zeros_like(depths[0])
        for i in range(3):
            n = _build.launch_counts()
            res = dense_slam.slam_step(model, depths[i].contiguous(), colors[i], md, intr)
            launched = _build.launch_counts() - n
            model, md = res.model, res.raycast_depth
            assert launched["o3dt_p2p_maps"] == 4
            assert launched["o3dt_p2p_sums"] == launched["o3dt_p2p_solve"] + 1
