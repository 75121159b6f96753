"""Tracking's two depth filters as stencil kernels: the bilateral filter of
a depth image and the depth-aware pyrdown (`geometry/image.py`'s
`filter_bilateral_depth` and `pyrdown_depth` call through here).

`bilateral_depth` and `pyrdown_depth` launch the CUDA kernels in
`csrc/depth_filters.cu` for CUDA tensors, on the current stream, and run
`bilateral_depth_plain` and `pyrdown_depth_plain`, the same functions in
plain PyTorch (a sum of `shift2d` copies, one a tap), for CPU tensors.
Nothing falls back: a CUDA tensor either launches the kernel or raises.

Replaces: open3d_tpu_torch/geometry/image.py:filter_bilateral_depth and
pyrdown_depth's tap loops, the twins of open3d_tpu/geometry/image.py:
filter_bilateral_depth and pyrdown_depth (which XLA fuses; no Pallas
kernel). On the card each tap of those loops was ~22 eager operations and
a host-to-device scalar: ~580 launches a call, against one here.
Bound: a pixel reads its k x k neighbourhood, from L1 and L2 after the
first touch, and writes one float: 8 B of device memory a pixel. At
640x480 the bilateral filter is bound by operations (10 float32
operations a tap with its two expf counted as one each, 251 a pixel at
k = 5: 77 M, ~1.2 us at 67 TFLOP/s; its 2.5 MB take ~0.7 us at 3.35
TB/s), the pyrdown by bytes (1.5 MB, ~0.5 us; 7 operations a tap). In
practice the expf set the time (~18 us at 640x480 on an H100, the
pyrdown ~5 us), and at tracking's sizes either is far below the ~580
launches it replaces.
Function: bilateral: out = sum(w nb) / max(sum(w), 1e-8) over the taps,
w = exp(-(dy^2 + dx^2) / (2 sigma_space^2)) exp(-(nb - d)^2 /
(2 sigma_depth^2)) [nb > 0], 0 where d <= 0. pyrdown: the same sum with
w = k[i] k[j] [nb > 0] [|nb - d| < diff_threshold] over the normalised
5-tap Gaussian k (sigma 1), 0 where d <= 0, kept at the even rows and
columns: ceil(H/2) x ceil(W/2). Taps outside the image read 0.
Rounding: the kernels repeat the plain versions' element-wise operations
in their order (see csrc/depth_filters.cu), so on the same card their
outputs are bit-equal: sums and products round one by one, no
multiply-add is fused, and the pyrdown's weights are the device tensor
`gauss5` computes with the plain version's expression.
"""

from __future__ import annotations

import torch

from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check
from open3d_tpu_torch.ops.kernels._plain import shift2d

_GAUSS5 = {}  # device -> the pyrdown's (5,) float32 weights on it


def gauss5(device) -> torch.Tensor:
    """The pyrdown's normalised 5-tap Gaussian (sigma 1) on `device`,
    computed once a device by the same PyTorch expression everywhere."""
    device = torch.device(device)
    if device not in _GAUSS5:
        x = torch.arange(-2, 3, dtype=torch.float32, device=device)
        k1 = torch.exp(-(x * x) / 2.0)
        _GAUSS5[device] = k1 / torch.sum(k1)
    return _GAUSS5[device]


def bilateral_depth_plain(depth, kernel_size: int = 5, sigma_space: float = 2.0,
                          sigma_depth: float = 0.05):
    """The bilateral filter in plain PyTorch on any device."""
    r = kernel_size // 2
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = shift2d(depth, dy, dx, fill=0.0)
            w_s = torch.exp(
                torch.tensor(-(dy * dy + dx * dx) * inv2ss, dtype=torch.float32, device=depth.device)
            )
            diff = nb - depth
            w = w_s * torch.exp(-(diff * diff) * inv2sd) * (nb > 0.0)
            num = num + w * nb
            den = den + w
    out = num / torch.clamp(den, min=1e-8)
    return torch.where(depth > 0.0, out, 0.0)


def pyrdown_depth_plain(depth: torch.Tensor, diff_threshold: float = 0.07) -> torch.Tensor:
    """The depth-aware pyrdown in plain PyTorch on any device."""
    r = 2
    k1 = gauss5(depth.device)
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    for i in range(5):
        for j in range(5):
            nb = shift2d(depth, i - r, j - r, fill=0.0)
            w = k1[i] * k1[j] * (nb > 0.0) * (torch.abs(nb - depth) < diff_threshold)
            num = num + w * nb
            den = den + w
    smoothed = torch.where(depth > 0.0, num / torch.clamp(den, min=1e-8), 0.0)
    return smoothed[::2, ::2].contiguous()


def _check_image(name: str, depth: torch.Tensor) -> None:
    """Raise unless `depth` is what the kernels take: a float32,
    contiguous, 2-D image on a CUDA card."""
    if depth.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {depth.device}")
    _check("depth", depth, torch.float32, depth.device)
    if depth.ndim != 2:
        raise ValueError(f"depth: expected a 2-D (H, W) image, got shape {tuple(depth.shape)}")


def bilateral_depth(depth: torch.Tensor, kernel_size: int = 5, sigma_space: float = 2.0,
                    sigma_depth: float = 0.05) -> torch.Tensor:
    """The bilateral filter of an (H, W) depth image. CUDA tensors (float32,
    contiguous) launch the kernel; CPU tensors run bilateral_depth_plain."""
    if depth.device.type == "cpu":
        return bilateral_depth_plain(depth, kernel_size, sigma_space, sigma_depth)
    _check_image("bilateral_depth", depth)
    H, W = depth.shape
    out = torch.empty_like(depth)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    _build.launch("o3dt_bilateral_depth", depth.device, depth.data_ptr(), out.data_ptr(), H, W,
                  kernel_size // 2, inv2ss, inv2sd)
    return out


def pyrdown_depth(depth: torch.Tensor, diff_threshold: float = 0.07) -> torch.Tensor:
    """The depth-aware pyrdown of an (H, W) depth image to (ceil(H/2),
    ceil(W/2)). CUDA tensors (float32, contiguous) launch the kernel; CPU
    tensors run pyrdown_depth_plain."""
    if depth.device.type == "cpu":
        return pyrdown_depth_plain(depth, diff_threshold)
    _check_image("pyrdown_depth", depth)
    H, W = depth.shape
    out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=torch.float32, device=depth.device)
    _build.launch("o3dt_pyrdown_depth", depth.device, depth.data_ptr(),
                  gauss5(depth.device).data_ptr(), out.data_ptr(), H, W, diff_threshold)
    return out
