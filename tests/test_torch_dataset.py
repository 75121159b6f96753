"""Port parity for data/dataset.py: the TUM and Redwood layouts, the cache's
archive step, the synthetic sequence and the read-ahead frame stream,
against the JAX package's loaders on the same files.

Bars:
- write_tum_sequence in both packages from the same 160x120 frames: the
  text files byte-equal, and every PNG decodes to the same pixels (the
  PNG bytes differ: PIL filters and deflates its own way);
- load_tum_sequence on a layout with jittered and dropped timestamps and a
  ground truth at its own rate: the same pairs, timestamps, ground-truth
  poses (exact) and intrinsic, with and without intrinsic.txt; the frames
  read equal (exact);
- load_redwood_sequence with a trajectory.log: the same lists, poses and
  intrinsic, frames equal;
- DownloadDataset.fetch() on a cached local archive: extracts it with the
  right MD5, raises with the wrong one, as the JAX package does (no
  download is attempted: the archive is in place);
- synthetic_rgbd_sequence: the JAX package's layout, its ground truth
  within 1e-5 and its depth within one step of the PNG's 1 mm scale of
  the JAX package's (the two renders' float32 depths fall on either side
  of a millimetre at a few pixels);
- iter_frames yields read_frame's frames in order, exactly;
- demo_icp_point_clouds: the JAX package's relative pose within 1e-6.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from open3d_tpu.data import dataset as jds
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch.data import dataset as tds
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.io import write_trajectory_log, write_trajectory_tum
from open3d_tpu_torch.io.image_io import write_depth, write_image

torch.set_num_threads(2)
INTR = (160, 120, 131.25, 131.25, 79.5, 59.5)


@pytest.fixture(scope="module")
def frames():
    d, c, e, _ = tsyn.render_sequence(5, intrinsic=TIntr(*INTR), span=0.5, device="cpu")
    return d.numpy(), c.numpy(), np.linalg.inv(e.numpy())


def _same_frames(a, b, n):
    for i in range(n):
        for x, y in zip(a.read_frame(i), b.read_frame(i)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_write_tum_sequence_matches_the_reference(tmp_path, frames):
    d, c, traj = frames
    a = tds.write_tum_sequence(str(tmp_path / "port"), d, c, traj, TIntr(*INTR))
    b = jds.write_tum_sequence(str(tmp_path / "ref"), d, c, traj, JIntr(*INTR))
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt", "intrinsic.txt"):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    sa, sb = tds.load_tum_sequence(a), jds.load_tum_sequence(b)
    _same_frames(sa, sb, len(sa))
    # each package reads the other's files alike
    _same_frames(tds.load_tum_sequence(b), jds.load_tum_sequence(a), len(sa))


def _jittered_tum(root, frames, with_intrinsic):
    d, c, traj = frames
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rng = np.random.default_rng(4)
    t_rgb = np.arange(len(d)) / 30.0 + rng.uniform(-0.004, 0.004, len(d))
    t_dep = np.arange(len(d)) / 30.0 + rng.uniform(-0.012, 0.012, len(d))
    keep = [0, 1, 3, 4]  # depth frame 2 dropped; rgb 2 then pairs with a far depth or none
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n")
        for i in range(len(d)):
            write_image(os.path.join(root, f"rgb/{i}.png"), (c[i] * 255).astype(np.uint8))
            f.write(f"{t_rgb[i]:.6f} rgb/{i}.png\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth maps\n\n")
        for i in keep:
            write_depth(os.path.join(root, f"depth/{i}.png"), d[i], 5000.0)
            f.write(f"{t_dep[i]:.6f} depth/{i}.png extra\n")
    t_gt = np.arange(4 * len(d)) / 120.0 - 0.01
    gt = np.repeat(traj, 4, axis=0)
    write_trajectory_tum(os.path.join(root, "groundtruth.txt"), gt, t_gt)
    if with_intrinsic:
        with open(os.path.join(root, "intrinsic.txt"), "w") as f:
            f.write(" ".join(str(v) for v in INTR) + "\n")
    return root


@pytest.mark.parametrize("with_intrinsic", [False, True])
def test_load_tum_sequence_associates_as_the_reference(tmp_path, frames, with_intrinsic):
    root = _jittered_tum(str(tmp_path / "tum"), frames, with_intrinsic)
    a, b = tds.load_tum_sequence(root), jds.load_tum_sequence(root)
    assert a.color_paths == b.color_paths and a.depth_paths == b.depth_paths
    assert len(a) == 4 and a.depth_scale == b.depth_scale == 5000.0  # rgb 2 lost its depth
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    np.testing.assert_array_equal(a.gt_trajectory, b.gt_trajectory)
    ia, ib = a.intrinsic, b.intrinsic
    assert (ia.width, ia.height, ia.fx, ia.fy, ia.cx, ia.cy) == \
        (ib.width, ib.height, ib.fx, ib.fy, ib.cx, ib.cy)
    _same_frames(a, b, len(a))


def test_load_redwood_sequence_matches_the_reference(tmp_path, frames):
    d, c, traj = frames
    root = str(tmp_path / "redwood")
    os.makedirs(os.path.join(root, "image"))
    os.makedirs(os.path.join(root, "depth"))
    for i in range(len(d)):
        write_image(os.path.join(root, "image", f"{i:06d}.png"), (c[i] * 255).astype(np.uint8))
        write_depth(os.path.join(root, "depth", f"{i:06d}.png"), d[i], 1000.0)
    write_depth(os.path.join(root, "depth", f"{len(d):06d}.png"), d[0], 1000.0)  # unpaired
    write_trajectory_log(os.path.join(root, "trajectory.log"), traj)
    a, b = tds.load_redwood_sequence(root), jds.load_redwood_sequence(root)
    assert a.color_paths == b.color_paths and a.depth_paths == b.depth_paths
    assert len(a) == len(d) and a.depth_scale == b.depth_scale == 1000.0
    np.testing.assert_array_equal(a.gt_trajectory, b.gt_trajectory)
    assert a.intrinsic.fx == b.intrinsic.fx and a.intrinsic.cx == b.intrinsic.cx
    _same_frames(a, b, len(a))


def _archive(tmp_path):
    src = tmp_path / "payload"
    src.mkdir()
    (src / "hello.txt").write_text("fragment data\n")
    zip_path = shutil.make_archive(str(tmp_path / "Demo"), "zip", str(src))
    with open(zip_path, "rb") as f:
        return zip_path, hashlib.md5(f.read()).hexdigest()


@pytest.mark.parametrize("pkg", [tds, jds], ids=["port", "reference"])
def test_fetch_extracts_a_cached_archive_and_checks_its_md5(tmp_path, pkg):
    zip_path, md5 = _archive(tmp_path)
    url = "https://example.invalid/data/Demo.zip"
    for root, digest, ok in (("good", md5, True), ("bad", "0" * 32, False)):
        ds = pkg.DownloadDataset("Demo", url, digest, data_root_path=str(tmp_path / root))
        os.makedirs(ds.download_dir)
        shutil.copy(zip_path, os.path.join(ds.download_dir, "Demo.zip"))
        if ok:
            out = ds.fetch()
            assert out == ds.extract_dir and open(os.path.join(out, "hello.txt")).read() == \
                "fragment data\n"
            assert ds.fetch() == out  # extracted: the archive is not read again
        else:
            with pytest.raises(RuntimeError, match="MD5 mismatch"):
                ds.fetch()
    assert pkg.Dataset("X", str(tmp_path)).extract_dir == os.path.join(str(tmp_path), "extract",
                                                                       "X")


def test_synthetic_rgbd_sequence_matches_the_reference(tmp_path):
    a = tds.synthetic_rgbd_sequence(3, 80, 60, span=0.3, out_dir=str(tmp_path / "p"),
                                    device="cpu")
    b = jds.synthetic_rgbd_sequence(3, 80, 60, span=0.3, out_dir=str(tmp_path / "r"))
    assert [os.path.relpath(p, tmp_path / "p") for p in a.depth_paths] == \
        [os.path.relpath(p, tmp_path / "r") for p in b.depth_paths]
    np.testing.assert_allclose(a.gt_trajectory, b.gt_trajectory, atol=1e-5)
    assert a.intrinsic.fx == b.intrinsic.fx and a.depth_scale == b.depth_scale
    for i in range(3):
        da, db = a.read_frame(i)[0], b.read_frame(i)[0]
        both = (da > 0) & (db > 0)
        assert both.mean() > 0.9 and np.abs(da - db)[both].max() <= 1e-3 + 1e-6


def test_iter_frames_yields_read_frame_in_order(tmp_path, frames):
    d, c, traj = frames
    seq = tds.load_tum_sequence(tds.write_tum_sequence(str(tmp_path / "t"), d, c, traj,
                                                       TIntr(*INTR)))
    got = list(seq.iter_frames(n_threads=3, depth_ahead=2))
    assert len(got) == len(seq)
    for i, (depth, color) in enumerate(got):
        want = seq.read_frame(i)
        np.testing.assert_array_equal(depth, want[0])
        np.testing.assert_array_equal(color, want[1])


def test_demo_icp_point_clouds_pose(tmp_path):
    src, tgt, T = tds.demo_icp_point_clouds(n_points=2000, device="cpu")
    _, _, T_ref = jds.demo_icp_point_clouds(n_points=500)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), atol=1e-6)
    assert int(src.count()) > 500 and src.normals is not None and int(tgt.count()) > 500
