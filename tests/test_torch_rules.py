"""Rules of the port that hold on every machine: open3d_tpu_torch and
chip_smoke.py import neither JAX nor the JAX package; without a card the
device pick raises unless the CPU is named; the kernel build raises when
nvcc is missing; the kernel wrappers refuse inputs the kernels do not take;
chip_smoke.py fails without a card."""

import ast
import collections
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import open3d_tpu_torch
from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core import platform
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels import integrate as k4
from open3d_tpu_torch.ops.kernels import integrate2 as k1
from open3d_tpu_torch.ops.kernels import micro_gather as p2
from open3d_tpu_torch.ops.kernels import micro_primitives as p1
from open3d_tpu_torch.ops.kernels import micro_raymarch as p3
from open3d_tpu_torch.ops.kernels import raycast as k2
from open3d_tpu_torch.ops.kernels import tsdf as k3

REPO = Path(__file__).resolve().parents[1]
PKG = Path(open3d_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "open3d_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}: imports {bad}"


def test_port_runs_with_jax_blocked():
    """Every module imports, and a CPU integrate + raycast runs, in a
    process where importing jax or open3d_tpu fails."""
    code = """
import sys, pkgutil, importlib
for name in ("jax", "jaxlib", "open3d_tpu"):
    sys.modules[name] = None
import open3d_tpu_torch, torch
for m in pkgutil.walk_packages(open3d_tpu_torch.__path__, "open3d_tpu_torch."):
    importlib.import_module(m.name)
from open3d_tpu_torch.data import synthetic
from open3d_tpu_torch.geometry import voxel_block_grid as vbg
d, c, e, intr = synthetic.render_sequence(1, device="cpu")
g = vbg.create(voxel_size=0.04, block_count=512, device="cpu")
keys, n = vbg.compute_unique_block_coordinates(g, d[0], intr, e[0], frame_block_capacity=128)
g = vbg.integrate(g, keys, d[0], c[0], intr, e[0])
r = vbg.raycast(g, intr, e[0], with_color=False)
assert int(n) > 0 and float(r.mask.float().mean()) > 0.5
assert not any(k.split(".")[0] in ("jax", "jaxlib", "open3d_tpu") and sys.modules[k] is not None
               for k in sys.modules)
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvbg.create(block_count=8)
    assert platform.default_device("cpu") == torch.device("cpu")
    assert tvbg.create(block_count=8, device="cpu").tw.device.type == "cpu"


def test_factories_raise_without_cuda(monkeypatch):
    """make_table, empty_keys and intrinsic_matrix create on the card unless
    the caller names a device, like every other creation entry point."""
    intr = PinholeCameraIntrinsic(16, 12, 10.0, 10.0, 8.0, 6.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: hm.make_table(8, **kw), lambda **kw: hm.empty_keys((3, 4), **kw),
                 lambda **kw: intr.intrinsic_matrix_on(kw.get("device"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
    # the property, read as the reference's callers read it, is on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        intr.intrinsic_matrix
    assert not callable(type(intr).__dict__["intrinsic_matrix"])
    assert tuple(hm.make_table(8, device="cpu").shape) == (8, 2)
    assert tuple(hm.empty_keys(5, device="cpu").shape) == (5, 2)
    assert float(intr.intrinsic_matrix_on("cpu")[0, 2]) == 8.0


def test_registration_results_are_made_where_the_clouds_are(monkeypatch):
    """A RegistrationResult built without num_iterations makes it on the
    card, like every creation entry point; the registration functions make
    their results on the clouds' device (here the CPU, named)."""
    from open3d_tpu_torch.geometry.pointcloud import PointCloud
    from open3d_tpu_torch.pipelines import global_registration as gr
    from open3d_tpu_torch.pipelines import registration as reg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.RegistrationResult(torch.eye(4), torch.ones(()), torch.zeros(()))
    pts = torch.randn((64, 3), generator=torch.Generator().manual_seed(0))
    cloud = PointCloud.create(pts, device="cpu")
    feats = torch.rand((64, 33), generator=torch.Generator().manual_seed(1))
    for r in (reg.evaluate_registration(cloud, cloud, 0.05),
              gr.registration_ransac_based_on_feature_matching(
                  cloud, cloud, feats, feats, 0.05, criteria=gr.RANSACConvergenceCriteria(512)),
              gr.registration_fgr_based_on_feature_matching(cloud, cloud, feats, feats)):
        assert {t.device.type for t in (r.transformation, r.fitness, r.inlier_rmse,
                                        r.num_iterations)} == {"cpu"}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _k1_inputs(C=8, M=4, H=12, W=16):
    tw = torch.zeros((C + 1, 32, 128), dtype=torch.int32)
    color = torch.zeros_like(tw)
    slots = torch.tensor([0, 1, C, 2], dtype=torch.int32)[:M]
    coords = torch.zeros((M, 3), dtype=torch.int32)
    d21 = torch.zeros((H, W), dtype=torch.int32)
    rgb24 = torch.zeros_like(d21)
    intr = PinholeCameraIntrinsic(W, H, 10.0, 10.0, W / 2, H / 2)
    return [tw, color, slots, coords, d21, rgb24, intr, torch.eye(4), 0.01, 0.04, 3.0]


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t.to(torch.int64)),
    (2, lambda t: t.to(torch.int64)),
    (2, lambda t: torch.stack([t, t], 1)[:, 0]),  # non-contiguous
    (3, lambda t: t.t().contiguous().t()),  # non-contiguous
    (4, lambda t: t.to(torch.float32)),
    (5, lambda t: t[:, :-1]),  # wrong shape
])
def test_integrate_wrapper_refuses_bad_inputs(arg, bad):
    args = _k1_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises((TypeError, ValueError)):
        k1.integrate_blocks_v2(*args)


def _misaligned_rows(t: torch.Tensor) -> torch.Tensor:
    """t's values, contiguous and of t's shape, starting 4 bytes past a
    16-byte boundary."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("arg", [0, 1])
def test_integrate_wrappers_refuse_misaligned_rows(arg):
    """K1 and K4 move payload rows as 16-byte words, so tw and colour must
    start on a 16-byte boundary."""
    for inputs, wrapper in ((_k1_inputs(), k1.integrate_blocks_v2), (_k4_inputs(), k4.integrate_blocks)):
        inputs[arg] = _misaligned_rows(inputs[arg])
        with pytest.raises(ValueError, match="aligned"):
            wrapper(*inputs)


def test_integrate_wrapper_accepts_good_inputs():
    args = _k1_inputs()
    k1.integrate_blocks_v2(*args)  # CPU tensors: the plain version runs
    assert int(args[0][-1].abs().sum()) == 0


@pytest.mark.parametrize("field,bad", [
    ("rows", lambda t: t.to(torch.int64)),
    ("coords", lambda t: t.t().contiguous().t()),
    ("nk", lambda t: t.to(torch.float32)),
    ("n_extra", lambda t: t.repeat(2)),
])
def test_march_wrapper_refuses_bad_inputs(field, bad):
    intr = PinholeCameraIntrinsic(32, 16, 20.0, 20.0, 15.5, 7.5)
    g = tvbg.create(voxel_size=0.03, block_count=16, with_color=False, device="cpu")
    lists = k2.build_tile_lists(g, intr, torch.eye(4), 0.1, 3.0)
    good = k2.march_tiles(g, lists, intr, torch.eye(4), 0.1, 3.0)
    assert tuple(good.shape) == (16, 32) and float(good.abs().max()) == 0.0
    lists = lists._replace(**{field: bad(getattr(lists, field))})
    with pytest.raises((TypeError, ValueError)):
        k2.march_tiles(g, lists, intr, torch.eye(4), 0.1, 3.0)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no card: the script exits non-zero and prints no
    result line; alone in a directory it fails as well."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in [(REPO / "chip_smoke.py", REPO), (lone, tmp_path)]:
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_kernel_sources_present():
    names = sorted(p.name for p in _build.sources())
    assert names == ["common.cu", "depth_filters.cu", "integrate2.cu", "micro_gather.cu",
                     "micro_primitives.cu", "micro_raymarch.cu", "point_to_plane.cu", "raycast.cu",
                     "tsdf.cu"]
    assert len(_build.source_hash()) == 16


def test_launch_checks_and_counts_by_entry(monkeypatch):
    """_build.launch calls its entry with the device's current stream last,
    counts the call under the entry's name once it returns 0, raises with
    the library's message on an error code without counting it, and
    reset_launches clears the counts."""
    codes, calls = [0, 2], []

    class FakeLib:
        def o3dt_fake(self, *args):
            calls.append(args)
            return codes.pop(0)

        def o3dt_error_string(self, err):
            return b"fake failure"

    monkeypatch.setattr(_build, "_lib", FakeLib())
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    streams = {0: 1234}
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", streams.__getitem__,
                        raising=False)
    _build.launch("o3dt_fake", torch.device("cuda", 0), 7, 2.5)
    assert calls == [(7, 2.5, 1234)]
    assert _build.launch_counts() == {"o3dt_fake": 1}
    with pytest.raises(RuntimeError, match="fake failure"):
        _build.launch("o3dt_fake", torch.device("cuda", 0), 8)
    assert len(calls) == 2 and _build.launch_counts() == {"o3dt_fake": 1}
    _build.reset_launches()
    assert _build.launch_counts() == {} and _build.launch_counts()["o3dt_fake"] == 0


@pytest.mark.parametrize("path", sorted((PKG / "ops" / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_wrappers_catch_no_build_or_launch_error(path):
    """No kernel wrapper wraps a build or a launch in try/except (a CUDA
    tensor launches the kernel or raises; nothing falls back)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)], path


def _k3_inputs(C=8, M=4, B=8):
    B3 = B**3
    tw = torch.zeros((C + 1, B3), dtype=torch.int32)
    color = torch.zeros_like(tw)
    rows = torch.tensor([0, 1, C, 2], dtype=torch.int32)[:M]
    tsdf_new = torch.full((M, B3), 0.5)
    wn = torch.ones((M, B3))
    cnew = torch.full((M, B3), (512 << 21) | (1024 << 10) | 512, dtype=torch.int32)
    return [tw, color, rows, tsdf_new, wn, cnew]


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t.to(torch.int64)),
    (0, lambda t: t.reshape(t.shape[0], 8, 64)),  # not (C+1, B^3)
    (1, lambda t: t[:, :-1]),  # wrong shape
    (2, lambda t: t.to(torch.int64)),
    (2, lambda t: torch.stack([t, t], 1)[:, 0]),  # non-contiguous
    (3, lambda t: t.double()),
    (4, lambda t: t[:-1]),  # wrong shape
    (5, lambda t: t.to(torch.float32)),
    (5, lambda t: None),  # colour grid without colour samples
    (3, lambda t: t.to("meta")),  # another device
])
def test_fuse_wrapper_refuses_bad_inputs(arg, bad):
    args = _k3_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises((TypeError, ValueError)):
        k3.fuse_blocks(*args)


@pytest.mark.parametrize("arg", [0, 1, 3, 4, 5], ids=["tw", "color", "tsdf_new", "wn", "cnew"])
def test_fuse_wrapper_refuses_misaligned_rows(arg):
    """K3 moves rows and samples as 16-byte groups when B^3 % 4 == 0, so
    each of them must start on a 16-byte boundary; checked before the
    device branch, so on the CPU as well."""
    args = _k3_inputs()
    args[arg] = _misaligned_rows(args[arg])
    with pytest.raises(ValueError, match="aligned"):
        k3.fuse_blocks(*args)


def test_fuse_wrapper_takes_any_alignment_for_odd_blocks():
    """B = 5 (B^3 = 125) rows go one voxel a group, so a row base off a
    16-byte boundary is no fault there."""
    args = _k3_inputs(B=5)
    args[0] = _misaligned_rows(args[0])
    k3.fuse_blocks(*args)
    t, w = tvbg.unpack_tw(args[0][:3])
    assert float(w.min()) == 1.0 and int(args[0][-1].abs().sum()) == 0


def test_fuse_wrapper_accepts_good_inputs():
    for with_color in (True, False):
        args = _k3_inputs()
        if not with_color:
            args[1] = args[5] = None
        k3.fuse_blocks(*args)  # CPU tensors: the plain version runs
        t, w = tvbg.unpack_tw(args[0][:3])
        assert float(w.min()) == 1.0 and float((t - 0.5).abs().max()) < 1e-4
        assert int(args[0][-1].abs().sum()) == 0  # the dump row is skipped


def _k4_inputs(C=8, M=4, H=12, W=16):
    tw = torch.zeros((C + 1, 32, 128), dtype=torch.int32)
    color = torch.zeros_like(tw)
    slots = torch.tensor([0, 1, C, 2], dtype=torch.int32)[:M]
    coords = torch.zeros((M, 3), dtype=torch.int32)
    planes = k4.prepare_planes(torch.ones((H, W)), torch.full((H, W, 3), 0.5), True)
    intr = PinholeCameraIntrinsic(W, H, 10.0, 10.0, W / 2, H / 2)
    return [tw, color, slots, coords, planes, intr, torch.eye(4), 0.01, 0.04, 3.0]


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t.to(torch.int64)),
    (1, lambda t: t.reshape(t.shape[0], -1)),  # not (C+1, 32, 128)
    (2, lambda t: t.to(torch.int64)),
    (3, lambda t: t.t().contiguous().t()),  # non-contiguous
    (4, lambda t: t.to(torch.float32)),
    (4, lambda t: t[:4]),  # wrong shape
    (4, lambda t: t.to("meta")),  # another device
])
def test_integrate_v1_wrapper_refuses_bad_inputs(arg, bad):
    args = _k4_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises((TypeError, ValueError)):
        k4.integrate_blocks(*args)


def test_integrate_v1_wrapper_accepts_good_inputs():
    args = _k4_inputs()
    assert args[4].dtype == torch.bfloat16 and tuple(args[4].shape) == (5, 12, 16)
    k4.integrate_blocks(*args)  # CPU tensors: the plain version runs
    assert int(args[0][-1].abs().sum()) == 0


def _p2_inputs(R=32, n=64):
    table = torch.randn((R, 128))
    idx = torch.randint(0, R * 128, (n, 1), dtype=torch.int32)
    return [table, idx]


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t.double()),
    (0, lambda t: t[:, :64].contiguous()),  # not (R, 128)
    (0, lambda t: t.t().contiguous().t()),  # non-contiguous
    (1, lambda t: t.to(torch.int64)),
    (1, lambda t: t.reshape(-1)),  # not (n, 1)
    (1, lambda t: torch.cat([t, t], 1)[:, :1]),  # non-contiguous
    (1, lambda t: t.to("meta")),  # another device
])
def test_micro_gather_wrapper_refuses_bad_inputs(arg, bad):
    args = _p2_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises((TypeError, ValueError)):
        p2.gather(*args)


def test_micro_gather_wrapper_accepts_good_inputs():
    table, idx = _p2_inputs()
    out = p2.gather(table, idx)  # CPU tensors: the plain version runs
    assert torch.equal(out[:, 0], table.reshape(-1)[idx[:, 0].long()])


def _p3_inputs(T=2, C=8):
    return list(p3.make_inputs(torch.Generator().manual_seed(0), "cpu", T=T, C=C)[::-1])


@pytest.mark.parametrize("arg,bad", [
    (0, lambda t: t.to(torch.int64)),
    (0, lambda t: t[:, :7].contiguous()),  # not (T, 8)
    (0, lambda t: t.t().contiguous().t()),  # non-contiguous
    (1, lambda t: t.reshape(t.shape[0], -1)),  # not (C, 32, 128)
    (1, lambda t: t.float()),
    (1, lambda t: t.to("meta")),  # another device
])
def test_micro_raymarch_wrapper_refuses_bad_inputs(arg, bad):
    args = _p3_inputs()
    args[arg] = bad(args[arg])
    with pytest.raises((TypeError, ValueError)):
        p3.march(*args)


def test_micro_raymarch_wrapper_accepts_good_inputs():
    rows, tw = _p3_inputs()
    out = p3.march(rows, tw)  # CPU tensors: the plain version runs
    assert tuple(out.shape) == (2, 1, 256) and bool(torch.isfinite(out).all())


def _p1_case(name="take_along 1col (2048,128)"):
    probe = p1.BY_NAME[name]
    return probe, p1.make_inputs(probe, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("bad", [
    lambda p, ins: (p, [ins[0].double(), ins[1]], 2),
    lambda p, ins: (p, [ins[0], ins[1].to(torch.int64)], 2),
    lambda p, ins: (p, [ins[0][:1024].contiguous(), ins[1]], 2),  # wrong shape
    lambda p, ins: (p, [ins[0].t().contiguous().t(), ins[1]], 2),  # non-contiguous
    lambda p, ins: (p, [ins[0]], 2),  # an input missing
    lambda p, ins: (p, [ins[0], ins[1].to("meta")], 2),  # another device
    lambda p, ins: (p, ins, -1),  # negative repeat count
    lambda p, ins: (p1.Probe("x", "gather", "col", p.inputs, p.out_shape, p.out_dtype), ins, 2),
])
def test_micro_primitives_wrapper_refuses_bad_inputs(bad):
    probe, ins = _p1_case()
    with pytest.raises((TypeError, ValueError)):
        p1.run_probe(*bad(probe, ins))


def test_micro_primitives_wrapper_accepts_good_inputs():
    probe, ins = _p1_case()
    out = p1.run_probe(probe, ins, 2)  # CPU tensors: the plain version runs
    x, idx = ins
    g = x.gather(1, idx.long())
    expect = (g + 0.0) + (g + 1.0)  # iterations 0 and 1 summed from zero
    assert torch.equal(out, expect)


@pytest.mark.parametrize("family,M,K,N", [
    ("mma_bf16", 32, 128, 128),  # M not a multiple of 64 (a warpgroup's rows)
    ("mma_bf16", 64, 64, 128),  # K not 128 (A stays in registers at K = 128)
    ("mma_bf16", 64, 256, 128),
    ("mma_bf16", 64, 128, 100),  # N a multiple of neither 80 nor 32
    ("ffma", 6, 1024, 8),  # M not a multiple of 4
    ("ffma", 4, 1024, 12),  # N not a multiple of 8
    ("ffma", 4, 2000, 8),  # K not a multiple of 1024
])
def test_product_wrapper_refuses_shapes_the_tiles_cannot_take(family, M, K, N):
    dtype = torch.bfloat16 if family == "mma_bf16" else torch.float32
    a, b = torch.zeros((M, K), dtype=dtype), torch.zeros((K, N), dtype=dtype)
    with pytest.raises(ValueError, match="tiles"):
        p1.product(family, a, b, 1)


@pytest.mark.parametrize("bad", [
    lambda a, b: (a.float(), b),  # the bfloat16 kernel takes bfloat16
    lambda a, b: (a, b[:64].contiguous()),  # inner sizes differ
    lambda a, b: (a, b.t().contiguous().t()),  # non-contiguous
])
def test_product_wrapper_refuses_bad_inputs(bad):
    a, b = torch.zeros((64, 128), dtype=torch.bfloat16), torch.zeros((128, 80), dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        p1.product("mma_bf16", *bad(a, b), 1)


def _offset_view(shape, dtype):
    """A contiguous (rows, cols) view one element past a fresh allocation."""
    n = shape[0] * shape[1]
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("family,M,K,N,which", [
    ("mma_bf16", 64, 128, 80, "a"),  # a read as 4-byte words
    ("ffma", 4, 1024, 8, "a"),  # a and b read as 16-byte words
    ("ffma", 4, 1024, 8, "b"),
])
def test_product_wrapper_refuses_misaligned_bases(family, M, K, N, which):
    dtype = torch.bfloat16 if family == "mma_bf16" else torch.float32
    a, b = torch.zeros((M, K), dtype=dtype), torch.zeros((K, N), dtype=dtype)
    if which == "a":
        a = _offset_view((M, K), dtype)
    else:
        b = _offset_view((K, N), dtype)
    assert a.is_contiguous() and b.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        p1.product(family, a, b, 1)


@pytest.mark.parametrize("family,M,K,N", [
    ("mma_bf16", 64, 128, 80), ("mma_bf16", 128, 128, 96), ("ffma", 4, 1024, 8),
    ("ffma", 8, 2048, 16),
])
def test_product_wrapper_accepts_what_the_tiles_take(family, M, K, N):
    dtype = torch.bfloat16 if family == "mma_bf16" else torch.float32
    gen = torch.Generator().manual_seed(1)
    a = torch.randn((M, K), generator=gen).to(dtype)
    b = torch.randn((K, N), generator=gen).to(dtype)
    out = p1.product(family, a, b, 3)  # CPU tensors: the plain sum
    expect = sum(((a + torch.tensor(float(i)).to(dtype)).double() @ b.double()) for i in range(3))
    assert out.dtype == torch.float32 and tuple(out.shape) == (M, N)
    assert float((out.double() - expect).abs().max() / expect.abs().max()) < 1e-6


@pytest.mark.parametrize("mod", [p1, p2, p3], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_entry_points_raise_without_cuda(monkeypatch, mod):
    """python -m open3d_tpu_torch.ops.kernels.<probe> measures the card or
    nothing: without one its main() raises before it makes any input."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main()


def test_probe_wrappers_refuse_indices_out_of_range():
    table, idx = _p2_inputs()
    with pytest.raises(ValueError, match="index"):
        p2.gather(table, torch.full_like(idx, 32 * 128))
    with pytest.raises(ValueError, match="index"):
        p2.gather(table, torch.full_like(idx, -1))
    rows, tw = _p3_inputs()
    with pytest.raises(ValueError, match="row"):
        p3.march(torch.full_like(rows, tw.shape[0]), tw)
    probe, (x, idx1) = _p1_case()
    with pytest.raises(ValueError, match="index"):
        p1.run_probe(probe, [x, torch.full_like(idx1, 128)], 1)


# ---- public names and signatures against the reference ---------------------

# Names the reference has and the port still lacks, each with the item of
# ROADMAP.md §1 that queues it. Nothing else may be missing: none is left.
QUEUED = {}
# The port's modules with no module at the same path in the reference: the
# numpy interchange, the kernel layer that replaces ops/pallas/, and the
# benchmark suite (the JAX package's is bench.py at the repository's root)
PORT_ONLY = ("bench", "convert", "ops.kernels")


def _port_modules():
    import pkgutil

    return sorted(m.name[len("open3d_tpu_torch."):] for m in
                  pkgutil.walk_packages(open3d_tpu_torch.__path__, "open3d_tpu_torch."))


def _public(mod) -> dict:
    """The module's own public functions and classes, and each class's
    public methods and properties as "Class.name"."""
    import inspect

    out = {}
    for k, v in vars(mod).items():
        if k.startswith("_") or getattr(v, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(v):
            out[k] = v
        elif inspect.isclass(v):
            out[k] = v
            for mk, mv in vars(v).items():
                if not mk.startswith("_") and (inspect.isfunction(mv) or isinstance(
                        mv, (staticmethod, classmethod, property))):
                    out[f"{k}.{mk}"] = mv
    return out


def _default(d):
    """A default as the two packages can share it: a plain value as it is,
    a dataclass instance (an option record) by its repr, a tuple element by
    element, anything else (an array, a function) by its type's name."""
    import dataclasses

    if isinstance(d, (bool, int, float, str, type(None))):
        return d
    if isinstance(d, tuple):
        return tuple(_default(x) for x in d)
    if dataclasses.is_dataclass(d) and not isinstance(d, type):
        return repr(d)
    return type(d).__name__


def _params(obj) -> list:
    """(name, kind, default) of each parameter, the port's added `device`
    keyword left out."""
    import inspect

    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(obj).parameters.values() if p.name != "device"]


@pytest.mark.parametrize("name", [m for m in _port_modules()
                                  if not any(m == s or m.startswith(s + ".") for s in PORT_ONLY)])
def test_public_signatures_match_the_reference(name):
    """Every public function, class, method and property of the reference's
    module exists in the port's module of the same path, of the same kind,
    with the same parameter names, kinds and plain defaults in the same
    order; the port may add a `device` keyword. The reference's names the
    port still lacks are the ones ROADMAP.md §1 queues (QUEUED)."""
    import importlib
    import inspect

    port = importlib.import_module(f"open3d_tpu_torch.{name}")
    ref = importlib.import_module(f"open3d_tpu.{name}")
    P, R = _public(port), _public(ref)
    queued = QUEUED.get(name, {})
    missing = sorted(set(R) - set(P))
    assert missing == sorted(queued), f"missing {missing}, queued {sorted(queued)}"
    for k in sorted(set(R) & set(P)):
        a, b = P[k], R[k]
        assert type(a) is type(b) or (inspect.isclass(a) and inspect.isclass(b)), (
            f"{k}: {type(a).__name__} in the port, {type(b).__name__} in the reference")
        if isinstance(b, property):
            continue
        assert _params(a) == _params(b), f"{k}: {_params(a)} != {_params(b)}"
        f = a.__func__ if isinstance(a, (staticmethod, classmethod)) else a
        added = inspect.signature(f).parameters.get("device")
        assert added is None or added.default is None, f"{k}: device defaults to the card"


def test_port_only_modules_have_no_reference_twin():
    import importlib

    for name in _port_modules():
        if any(name == s or name.startswith(s + ".") for s in PORT_ONLY):
            with pytest.raises(ImportError):
                importlib.import_module(f"open3d_tpu.{name}")
