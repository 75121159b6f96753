"""Gaussian-splat .splat codec, antimatter15's layout (port of
open3d_tpu/io/splat.py; Open3D's t/io/file_format/FileSPLAT.cpp).

32 bytes a Gaussian: 3 float32 position, 3 float32 linear scale, 4 uint8
colour (RGB from the SH DC coefficient as 0.5 + SH_C0 f_dc, alpha the
sigmoid of the opacity logit), 4 uint8 rotation quaternion ((q + 1) 128,
wxyz). The writer sorts by volume x opacity, largest first; the reader
recovers f_dc, the opacity logit (clipped to +-30) and normalised
quaternions under the attribute names f_dc, opacity, scale and rot.
"""

from __future__ import annotations

import numpy as np

from open3d_tpu_torch.geometry.pointcloud import PointCloud

_SH_C0 = 0.28209479177387814
_REC_BYTES = 32


def read_splat(path: str, capacity: int | None = None, device=None):
    """A PointCloud with attrs f_dc (N, 3), opacity (N, 1), scale (N, 3)
    and rot (N, 4) from a .splat file, on `device` (default: the card)."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // _REC_BYTES
    rec = raw[:n * _REC_BYTES].reshape(n, _REC_BYTES)
    pos = rec[:, 0:12].copy().view(np.float32).reshape(n, 3)
    scale = rec[:, 12:24].copy().view(np.float32).reshape(n, 3)
    color = rec[:, 24:28].astype(np.float32)
    rot_u8 = rec[:, 28:32].astype(np.float32)

    f_dc = ((color[:, :3] / 255.0) - 0.5) / _SH_C0
    a = color[:, 3]
    with np.errstate(divide="ignore"):
        opacity = np.where(
            a <= 0.0, -np.inf,
            np.where(a >= 255.0, np.inf, -np.log(255.0 / np.maximum(a, 1e-6) - 1.0)),
        ).astype(np.float32)[:, None]
    opacity = np.clip(opacity, -30.0, 30.0)  # the saturated logits, finite

    q = rot_u8 / 128.0 - 1.0  # wxyz
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    q = np.where(norm > 1e-7, q / np.maximum(norm, 1e-7), [1.0, 0.0, 0.0, 0.0])
    return PointCloud.create(pos, capacity=capacity, device=device, f_dc=f_dc.astype(np.float32),
                             opacity=opacity, scale=scale, rot=q.astype(np.float32))


def write_splat(path: str, pcd) -> None:
    """The cloud's valid rows (attrs f_dc, opacity, scale, rot) as .splat,
    sorted by volume x opacity, largest first, so that progressive viewers
    draw the dominant splats first."""
    mask = pcd.mask.cpu().numpy()

    def host(x):
        return x.detach().cpu().numpy()[mask].astype(np.float32)

    pos = host(pcd.positions)
    f_dc = host(pcd.attrs["f_dc"])
    opacity = host(pcd.attrs["opacity"]).reshape(-1)
    scale = host(pcd.attrs["scale"])
    rot = host(pcd.attrs["rot"])
    n = pos.shape[0]

    vol = scale[:, 0] * scale[:, 1] * scale[:, 2]
    sig = 1.0 / (1.0 + np.exp(-opacity))
    order = np.argsort(-(vol * sig), kind="stable")

    rgb = np.clip(np.round((0.5 + _SH_C0 * f_dc) * 255.0), 0, 255)
    a = np.clip(np.round(sig * 255.0), 0, 255)
    color = np.concatenate([rgb, a[:, None]], axis=1).astype(np.uint8)
    qn = rot / np.maximum(np.linalg.norm(rot, axis=1, keepdims=True), 1e-7)
    rot_u8 = np.clip(np.round((qn + 1.0) * 128.0), 0, 255).astype(np.uint8)

    rec = np.zeros((n, _REC_BYTES), np.uint8)
    rec[:, 0:12] = np.ascontiguousarray(pos[order]).view(np.uint8).reshape(n, 12)
    rec[:, 12:24] = np.ascontiguousarray(scale[order]).view(np.uint8).reshape(n, 12)
    rec[:, 24:28] = color[order]
    rec[:, 28:32] = rot_u8[order]
    rec.tofile(path)
