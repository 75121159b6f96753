"""Tracking's two depth filters (`ops/kernels/depth_filters.py`): the
stencil kernels against their plain versions. The plain versions are held
against the JAX package on `holey_depth`'s images in
`test_torch_image_odometry.py`.

The CPU tests run everywhere: CPU tensors take the plain path. The card
tests (marker `cuda`) skip without a card; on a machine with one and no JAX
run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_depth_filters.py

Bar: bit-equality (`torch.equal`). The kernels repeat the plain versions'
element-wise operations in their order, so on one card they agree exactly.
"""

import numpy as np
import pytest
import torch

from open3d_tpu_torch.geometry import image as im
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels import depth_filters as df


def _filter_launches() -> tuple:
    """The bilateral filter's and the pyrdown's launches so far."""
    c = _build.launch_counts()
    return c["o3dt_bilateral_depth"], c["o3dt_pyrdown_depth"]


def _steps(x: float, n: int) -> list:
    """The float32 values x - n ulp .. x + n ulp."""
    v = np.float32(x)
    down, up = [v], [v]
    for _ in range(n):
        down.append(np.nextafter(down[-1], np.float32(-np.inf)))
        up.append(np.nextafter(up[-1], np.float32(np.inf)))
    return down[:0:-1] + up


def holey_depth(H: int, W: int, seed: int = 0) -> torch.Tensor:
    """A float32 depth image: a smooth surface with steps, ~20 % holes,
    a zero border, a few negative readings, and a band of pixels whose
    differences from their neighbours straddle the pyrdown's 0.07 m
    threshold and the bilateral filter's 0.05 m sigma by a few ulp."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 1.0 + 0.3 * np.sin(x / 17.0) + 0.2 * np.cos(y / 11.0) + 0.01 * rng.standard_normal((H, W))
    d += 0.15 * ((x // 23 + y // 19) % 2)  # steps wider than the threshold
    d = d.astype(np.float32)
    band = np.array([np.float32(1.0)] + _steps(1.07, 3) + _steps(0.93, 3) + _steps(1.05, 2)
                    + _steps(1.03, 2), dtype=np.float32)
    rows = slice(H // 3, H // 3 + 3)
    d[rows, :] = band[np.arange(W) % band.size][None, :]
    d[rng.random((H, W)) < 0.2] = 0.0
    d[rng.random((H, W)) < 0.005] = -0.5
    if H > 4 and W > 4:
        d[:2, :] = d[-2:, :] = 0.0
        d[:, :2] = d[:, -2:] = 0.0
    return torch.from_numpy(np.ascontiguousarray(d))


SIZES = [(120, 160), (61, 83), (3, 5), (2, 2), (1, 1)]
BILATERAL_PARAMS = [{}, {"kernel_size": 3}, {"kernel_size": 7, "sigma_space": 3.5},
                    {"sigma_depth": 0.02}, {"kernel_size": 4, "sigma_depth": 0.1}]
PYRDOWN_PARAMS = [{}, {"diff_threshold": 0.03}, {"diff_threshold": 0.1}]


# ---- CPU: the plain path --------------------------------------------------


@pytest.mark.parametrize("name", ["filter_bilateral_depth", "pyrdown_depth", "build_depth_pyramid"])
def test_cpu_tensors_take_the_plain_path(name):
    """image.py's callers on CPU tensors: the plain versions' bits, no
    launch counted by either wrapper."""
    d = holey_depth(120, 160, seed=3)
    before = _filter_launches()
    if name == "filter_bilateral_depth":
        got, want = [im.filter_bilateral_depth(d)], [df.bilateral_depth_plain(d)]
    elif name == "pyrdown_depth":
        got, want = [im.pyrdown_depth(d, 0.05)], [df.pyrdown_depth_plain(d, 0.05)]
    else:
        got = im.build_depth_pyramid(d, 3)
        want = [d, df.pyrdown_depth_plain(d)]
        want.append(df.pyrdown_depth_plain(want[-1]))
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and len(got) == len(want)
    assert _filter_launches() == before


@pytest.mark.parametrize("fn", [df.bilateral_depth, df.pyrdown_depth], ids=lambda f: f.__name__)
def test_wrappers_refuse_devices_without_a_kernel(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros((4, 4), device="meta"))


def test_gauss5_is_the_replaced_expression():
    x = torch.arange(-2, 3, dtype=torch.float32)
    k1 = torch.exp(-(x * x) / 2.0)
    assert torch.equal(df.gauss5("cpu"), k1 / torch.sum(k1))
    assert df.gauss5("cpu") is df.gauss5(torch.device("cpu"))


# ---- the card: the kernels --------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(d):
    """(kernel, plain) outputs of each filter on the CUDA tensor d."""
    out = [(df.bilateral_depth(d), df.bilateral_depth_plain(d)),
           (df.pyrdown_depth(d), df.pyrdown_depth_plain(d))]
    torch.cuda.synchronize()
    return out


class TestOnCard:
    pytestmark = pytest.mark.cuda

    @pytest.mark.parametrize("size", [(480, 640), (240, 320), (120, 160), (479, 641), (3, 5),
                                      (1, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
    def test_kernels_match_plain(self, cuda, size):
        d = holey_depth(*size, seed=size[0]).to(cuda)
        for got, want in _both(d):
            assert got.shape == want.shape and torch.equal(got, want)

    def test_kernels_match_plain_on_rendered_frames(self, cuda):
        from open3d_tpu_torch.data import synthetic
        from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic

        depths, _, _, _ = synthetic.render_sequence(
            2, intrinsic=PinholeCameraIntrinsic.prime_sense_default(), span=0.1, device=cuda)
        for d in depths:
            d = d.contiguous()
            assert torch.count_nonzero(d) > 0
            for got, want in _both(d):
                assert torch.equal(got, want)
            d2 = df.pyrdown_depth(d)
            for got, want in _both(d2):
                assert torch.equal(got, want)

    @pytest.mark.parametrize("params", BILATERAL_PARAMS, ids=str)
    def test_bilateral_kernel_with_other_parameters(self, cuda, params):
        d = holey_depth(97, 131, seed=5).to(cuda)
        got = df.bilateral_depth(d, **params)
        assert torch.equal(got, df.bilateral_depth_plain(d, **params))

    @pytest.mark.parametrize("params", PYRDOWN_PARAMS, ids=str)
    def test_pyrdown_kernel_with_other_thresholds(self, cuda, params):
        d = holey_depth(97, 131, seed=6).to(cuda)
        got = df.pyrdown_depth(d, **params)
        assert torch.equal(got, df.pyrdown_depth_plain(d, **params))

    @pytest.mark.parametrize("fn", [df.bilateral_depth, df.pyrdown_depth], ids=lambda f: f.__name__)
    @pytest.mark.parametrize("bad,err", [
        (lambda t: t.double(), TypeError),
        (lambda t: t.t(), ValueError),  # non-contiguous
        (lambda t: t[None], ValueError),  # 3-D
    ], ids=["float64", "non_contiguous", "3d"])
    def test_wrappers_refuse_bad_inputs(self, cuda, fn, bad, err):
        d = holey_depth(16, 24).to(cuda)
        n = _build.launch_counts()
        with pytest.raises(err):
            fn(bad(d))
        assert _build.launch_counts() == n

    def test_launches_count_one_per_call(self, cuda):
        d = holey_depth(48, 64).to(cuda)
        nb, npd = _filter_launches()
        df.bilateral_depth(d)
        df.bilateral_depth(d)
        df.pyrdown_depth(d)
        b, p = _filter_launches()
        assert (b - nb, p - npd) == (2, 1)

    @pytest.mark.parametrize("name", ["filter_bilateral_depth", "pyrdown_depth"])
    def test_image_filters_take_any_layout(self, cuda, name):
        """image.py's entry points hand the kernel a contiguous copy of a
        strided view, as the loops they replace took any layout."""
        d = holey_depth(97, 131, seed=7).to(cuda)
        view = d.t()
        n = sum(_filter_launches())
        got = getattr(im, name)(view)
        plain = (df.bilateral_depth_plain if name == "filter_bilateral_depth"
                 else df.pyrdown_depth_plain)
        assert torch.equal(got, plain(view.contiguous()))
        assert sum(_filter_launches()) - n == 1

    def test_tracking_pose_is_the_plain_filters_pose(self, cuda, monkeypatch):
        """track_frame_to_model through the kernels (ten launches: two
        pyramids of two pyrdowns, two bilateral filters at each of three
        levels) against the same call with the plain filters patched in."""
        from open3d_tpu_torch.data import synthetic
        from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
        from open3d_tpu_torch.models import dense_slam

        depths, _, _, intr = synthetic.render_sequence(
            2, intrinsic=PinholeCameraIntrinsic.prime_sense_default(), span=0.1, device=cuda)
        model = dense_slam.create_model(dense_slam.SLAMConfig(block_count=1024), device=cuda)
        n = sum(_filter_launches())
        got = dense_slam.track_frame_to_model(model, depths[1].contiguous(),
                                              depths[0].contiguous(), intr)
        assert sum(_filter_launches()) - n == 10
        monkeypatch.setattr(im, "filter_bilateral_depth", df.bilateral_depth_plain)
        monkeypatch.setattr(im, "pyrdown_depth", df.pyrdown_depth_plain)
        want = dense_slam.track_frame_to_model(model, depths[1].contiguous(),
                                               depths[0].contiguous(), intr)
        assert sum(_filter_launches()) - n == 10
        assert torch.equal(got.transformation, want.transformation)
        assert torch.equal(got.fitness, want.fitness)
