"""Datasets (port of open3d_tpu/data/dataset.py): the cache layout, the
RGB-D sequence loaders and the synthetic demo data.

- `Dataset` / `DownloadDataset`: the same cache layout under
  $OPEN3D_TPU_DATA_ROOT (default ~/.open3d_tpu/data): download/<prefix>
  holds the archive, extract/<prefix> its contents; `fetch()` uses an
  extracted directory, else a cached archive (MD5-checked), else tries the
  URL and, offline, raises with where to put the data.
- `RGBDSequence`: file lists, intrinsic and depth scale; `read_frame(i)`
  decodes one frame with the port's image reader (io/image_io.py), and
  `iter_frames` yields the same frames in the same order, the files read
  ahead by the native prefetcher (native.FilePrefetcher), as the JAX
  package reads them.
- `load_tum_sequence`, `write_tum_sequence`, `load_redwood_sequence`: the
  TUM RGB-D and Redwood layouts, as the JAX package reads and writes them.
- `synthetic_rgbd_sequence` and `demo_icp_point_clouds`: the analytic scene
  rendered on `device` (default: the card). The surface samples of
  `demo_icp_point_clouds` come from torch.Generators seeded 0 and 1 on that
  device, where the JAX package draws from PRNGKey(0) and PRNGKey(1): the
  points differ, their distribution and the relative pose do not.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Tuple

import numpy as np


def data_root() -> str:
    root = os.environ.get("OPEN3D_TPU_DATA_ROOT", os.path.expanduser("~/.open3d_tpu/data"))
    os.makedirs(root, exist_ok=True)
    return root


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Dataset:
    """Base dataset: prefix + cache paths (ref: data/Dataset.h:58)."""

    def __init__(self, prefix: str, data_root_path: Optional[str] = None):
        self.prefix = prefix
        self.root = data_root_path or data_root()
        self.download_dir = os.path.join(self.root, "download", prefix)
        self.extract_dir = os.path.join(self.root, "extract", prefix)


class DownloadDataset(Dataset):
    """Download -> MD5 -> extract (ref: data/Dataset.h DownloadDataset)."""

    def __init__(self, prefix: str, url: str, md5: str, data_root_path=None):
        super().__init__(prefix, data_root_path)
        self.url = url
        self.md5 = md5

    def fetch(self) -> str:
        """Return the extract dir, extracting a cached archive or
        downloading one if needed; raises RuntimeError with where to put
        the data when the archive is neither cached nor reachable, and on
        an MD5 mismatch."""
        if os.path.isdir(self.extract_dir) and os.listdir(self.extract_dir):
            return self.extract_dir
        archive = os.path.join(self.download_dir, os.path.basename(self.url))
        if os.path.isfile(archive):
            if self.md5 and _md5(archive) != self.md5:
                raise RuntimeError(f"MD5 mismatch for {archive}")
            self._extract(archive)
            return self.extract_dir
        try:
            import urllib.request

            os.makedirs(self.download_dir, exist_ok=True)
            urllib.request.urlretrieve(self.url, archive)
            if self.md5 and _md5(archive) != self.md5:
                raise RuntimeError(f"MD5 mismatch for {archive}")
            self._extract(archive)
            return self.extract_dir
        except (OSError, RuntimeError, ValueError) as e:  # offline, bad archive: say where it goes
            raise RuntimeError(
                f"dataset '{self.prefix}' not cached and download failed ({e}); "
                f"place the archive at {archive} or the extracted data at "
                f"{self.extract_dir}"
            ) from e

    def _extract(self, archive: str) -> None:
        import shutil

        os.makedirs(self.extract_dir, exist_ok=True)
        shutil.unpack_archive(archive, self.extract_dir)


# ---------------------------------------------------------------------------
# RGB-D sequences
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RGBDSequence:
    """A loaded RGB-D trajectory: file lists + intrinsics + conventions."""

    color_paths: List[str]
    depth_paths: List[str]
    depth_scale: float
    intrinsic: "object"  # PinholeCameraIntrinsic
    gt_trajectory: Optional[np.ndarray] = None  # (N, 4, 4) cam->world
    timestamps: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.depth_paths)

    def read_frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (depth_metric_f32 (H, W), color_f32 (H, W, 3) in [0,1])."""
        from open3d_tpu_torch.io.image_io import read_depth, read_image

        depth = read_depth(self.depth_paths[i], self.depth_scale)
        color = read_image(self.color_paths[i]).astype(np.float32) / 255.0
        return depth, color

    def iter_frames(self, n_threads: int = 4, depth_ahead: int = 8):
        """The frames in order, as `read_frame` gives them. The native
        prefetcher's `n_threads` threads read the depth and colour files up
        to `depth_ahead` files ahead of the consumer, so disk reads overlap
        the caller's work on the card; each frame is decoded when it is
        taken."""
        from open3d_tpu_torch.io.image_io import decode_image
        from open3d_tpu_torch.native import FilePrefetcher

        order = [p for pair in zip(self.depth_paths, self.color_paths) for p in pair]
        with FilePrefetcher(order, n_threads=n_threads, depth=depth_ahead) as pf:
            for i in range(len(self)):
                depth = decode_image(pf.get(2 * i), self.depth_paths[i]).astype(np.float32)
                color = decode_image(pf.get(2 * i + 1), self.color_paths[i]).astype(np.float32)
                yield depth / self.depth_scale, color / 255.0


def load_tum_sequence(root: str, max_depth_diff: float = 0.02) -> RGBDSequence:
    """TUM RGB-D layout: rgb.txt / depth.txt / groundtruth.txt with
    nearest-timestamp association, depth scale 5000; the freiburg1
    intrinsic unless the directory holds an intrinsic.txt."""
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.io.trajectory import read_trajectory_tum

    def read_list(name):
        out = []
        with open(os.path.join(root, name)) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                t, p = ln.split()[:2]
                out.append((float(t), os.path.join(root, p)))
        return out

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    pairs = []
    j = 0
    for t, cp in rgb:
        while j + 1 < len(depth) and abs(depth[j + 1][0] - t) <= abs(depth[j][0] - t):
            j += 1
        if abs(depth[j][0] - t) < max_depth_diff:
            pairs.append((t, cp, depth[j][1]))
    gt = None
    ts = np.asarray([p[0] for p in pairs])
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.isfile(gt_file):
        gts, gtp = read_trajectory_tum(gt_file)
        idx = np.clip(np.searchsorted(gts, ts), 0, len(gts) - 1)
        gt = gtp[idx]
    calib = os.path.join(root, "intrinsic.txt")
    if os.path.isfile(calib):
        with open(calib) as f:
            w, h, fx, fy, cx, cy = f.read().split()
        intr = PinholeCameraIntrinsic(int(w), int(h), float(fx), float(fy), float(cx), float(cy))
    else:
        intr = PinholeCameraIntrinsic(640, 480, 517.3, 516.5, 318.6, 255.3)
    return RGBDSequence(
        color_paths=[p[1] for p in pairs],
        depth_paths=[p[2] for p in pairs],
        depth_scale=5000.0,
        intrinsic=intr,
        gt_trajectory=gt,
        timestamps=ts,
    )


def _host(x) -> np.ndarray:
    """A numpy copy of a host or device array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def write_tum_sequence(
    root: str,
    depths,  # (N, H, W) metric float
    colors,  # (N, H, W, 3) float [0, 1]
    trajectory,  # (N, 4, 4) camera->world ground truth
    intrinsic=None,
    depth_scale: float = 5000.0,
    fps: float = 30.0,
) -> str:
    """Write frames in the TUM RGB-D layout (rgb/ 8-bit and depth/ 16-bit
    PNGs, rgb.txt / depth.txt / groundtruth.txt with quaternion poses, and
    intrinsic.txt when `intrinsic` is given), so `load_tum_sequence` reads
    them as it reads real data. Arrays may be numpy or tensors."""
    from open3d_tpu_torch.io.image_io import write_depth, write_image
    from open3d_tpu_torch.io.trajectory import write_trajectory_tum

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    n = len(depths)
    ts = np.arange(n, dtype=np.float64) / fps
    with open(os.path.join(root, "rgb.txt"), "w") as fr, open(
        os.path.join(root, "depth.txt"), "w"
    ) as fd:
        fr.write("# color images\n# timestamp filename\n")
        fd.write("# depth maps\n# timestamp filename\n")
        for i in range(n):
            rgb_rel = f"rgb/{ts[i]:.6f}.png"
            dep_rel = f"depth/{ts[i]:.6f}.png"
            write_image(os.path.join(root, rgb_rel),
                        (np.clip(_host(colors[i]), 0, 1) * 255).astype(np.uint8))
            write_depth(os.path.join(root, dep_rel), _host(depths[i]), depth_scale)
            fr.write(f"{ts[i]:.6f} {rgb_rel}\n")
            fd.write(f"{ts[i]:.6f} {dep_rel}\n")
    write_trajectory_tum(os.path.join(root, "groundtruth.txt"), _host(trajectory), ts)
    if intrinsic is not None:
        with open(os.path.join(root, "intrinsic.txt"), "w") as fi:
            fi.write(
                f"{intrinsic.width} {intrinsic.height} {intrinsic.fx} "
                f"{intrinsic.fy} {intrinsic.cx} {intrinsic.cy}\n"
            )
    return root


def load_redwood_sequence(root: str) -> RGBDSequence:
    """Redwood indoor layout: image/ (or color/) + depth/ sorted pairs,
    depth scale 1000, the PrimeSense intrinsic, the ground truth from
    trajectory.log, livingroom.log or pose.log when present."""
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.io.trajectory import read_trajectory_log

    def listdir(sub):
        d = os.path.join(root, sub)
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith((".png", ".jpg"))
        )

    color = listdir("image") if os.path.isdir(os.path.join(root, "image")) else listdir("color")
    depth = listdir("depth")
    n = min(len(color), len(depth))
    intr = PinholeCameraIntrinsic(640, 480, 525.0, 525.0, 319.5, 239.5)
    gt = None
    for name in ("trajectory.log", "livingroom.log", "pose.log"):
        p = os.path.join(root, name)
        if os.path.isfile(p):
            gt = read_trajectory_log(p)
            break
    return RGBDSequence(
        color_paths=color[:n],
        depth_paths=depth[:n],
        depth_scale=1000.0,
        intrinsic=intr,
        gt_trajectory=gt,
    )


# ---------------------------------------------------------------------------
# Synthetic demo datasets
# ---------------------------------------------------------------------------


def synthetic_rgbd_sequence(
    n_frames: int = 20,
    width: int = 320,
    height: int = 240,
    span: float = 1.2,
    out_dir: Optional[str] = None,
    device=None,
) -> RGBDSequence:
    """Render the analytic scene on `device` (default: the card) to PNG
    files in the dataset cache (depth scale 1000), once per directory."""
    from open3d_tpu_torch.data import synthetic
    from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic
    from open3d_tpu_torch.io.image_io import write_depth, write_image

    intr = PinholeCameraIntrinsic(
        width, height, 0.82 * width, 0.82 * width, (width - 1) / 2.0, (height - 1) / 2.0
    )
    out_dir = out_dir or os.path.join(data_root(), "extract", f"SyntheticRGBD_{n_frames}_{width}")
    depth_dir = os.path.join(out_dir, "depth")
    color_dir = os.path.join(out_dir, "color")
    done = os.path.join(out_dir, ".done")
    if not os.path.isfile(done):
        os.makedirs(depth_dir, exist_ok=True)
        os.makedirs(color_dir, exist_ok=True)
        depths, colors, extrinsics, _ = synthetic.render_sequence(
            n_frames, intrinsic=intr, span=span, device=device
        )
        depths, colors = _host(depths), _host(colors)
        poses = np.linalg.inv(_host(extrinsics))  # cam->world
        for i in range(n_frames):
            write_depth(os.path.join(depth_dir, f"{i:06d}.png"), depths[i], 1000.0)
            write_image(
                os.path.join(color_dir, f"{i:06d}.png"),
                (np.clip(colors[i], 0, 1) * 255).astype(np.uint8),
            )
        np.save(os.path.join(out_dir, "gt_poses.npy"), poses)
        with open(done, "w") as f:
            f.write("ok")
    gt = np.load(os.path.join(out_dir, "gt_poses.npy"))
    return RGBDSequence(
        color_paths=[os.path.join(color_dir, f"{i:06d}.png") for i in range(n_frames)],
        depth_paths=[os.path.join(depth_dir, f"{i:06d}.png") for i in range(n_frames)],
        depth_scale=1000.0,
        intrinsic=intr,
        gt_trajectory=gt,
    )


def demo_icp_point_clouds(n_points: int = 20000, device=None):
    """Two surface-sample clouds of the analytic scene, the second moved by
    a known pose: (source, target, T) with target = T applied to a second
    sampling (ref: data/dataset/DemoICPPointClouds.cpp)."""
    import torch

    from open3d_tpu_torch.core import lie
    from open3d_tpu_torch.core.platform import default_device
    from open3d_tpu_torch.data import synthetic

    dev = default_device(device)
    src = synthetic.sample_surface(
        synthetic.default_scene_sdf, torch.Generator(device=dev).manual_seed(0), n_points,
        with_normals=True,
    )
    tgt = synthetic.sample_surface(
        synthetic.default_scene_sdf, torch.Generator(device=dev).manual_seed(1), n_points,
        with_normals=True,
    )
    T = lie.se3_exp(torch.tensor([0.04, -0.03, 0.05, 0.06, -0.04, 0.08], dtype=torch.float32,
                                 device=dev))
    return src, tgt.transform(T), T


# dataset registry mirroring the reference's class names -> loaders
TUM_URLS = {
    "SampleTUMRGBDImage": "https://github.com/isl-org/open3d_downloads/releases/download/20220301-data/SampleTUMRGBDImage.zip",
}
