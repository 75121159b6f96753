"""Build and load the port's CUDA kernels.

Every source under `open3d_tpu_torch/csrc/` is compiled by nvcc for Hopper
(`sm_90a`) into an object file, all of them in parallel, and linked into one
shared library with a plain C interface, loaded with ctypes. The sources
include no PyTorch header, so a build takes seconds. It runs at first use
into `open3d_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
flags, so a fresh checkout builds everything on its first call.

`--fmad=false` stops nvcc from fusing multiplies and adds on its own: a
kernel fuses only where it calls fmaf, at the same places as its plain
PyTorch version, so half-pixel rounding ties and keep decisions come out
the same in both.

A build failure raises with nvcc's output. There is no fallback.

Every kernel call goes through `launch`, which passes the device's current
stream, raises on the returned error code and counts the call in
`LAUNCHES` under its C entry name: one count is one call of that entry,
whichever wrapper made it. It reads the stream as the raw handle
(`torch._C._cuda_getCurrentRawStream`, as Triton's launcher does):
`torch.cuda.current_stream(device).cuda_stream` builds a Stream object and
took 4.26 us a call on the H100's host against 0.19 us, and a
Gauss-Newton iteration makes two launches.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libo3dt_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
]

_lib: Optional[ctypes.CDLL] = None
LAUNCHES = collections.Counter()  # C entry -> launches since reset_launches()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "open3d_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu (one nvcc per source, all at once) and link them.
    Returns the library path; reuses a finished build with the same hash."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    ptxas = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for src, _, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp_lib = work / LIB_NAME
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp_lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    if verbose:
        print("\n".join(logs))
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.o3dt_integrate_blocks.argtypes = [
        P, P, P, P, I, I,  # tw, color, slots, coords, M, C
        P, P, I, I,  # d21, rgb24, H, W
        P,  # params (R row-major 9, t 3) on the device
        F, F, F, F,  # fx fy cx cy
        F, F, F, F, F, F, F,  # voxel, block, -trunc, 1/trunc, depth_max, d21 scale, weight_max
        P,  # stream
    ]
    lib.o3dt_integrate_blocks.restype = I
    lib.o3dt_march_tiles.argtypes = [
        P, P, P, P, P, P, P,  # tw, rows, coords, nk, n_extra, params, out
        I, I, I, I, I, I,  # T, TW, H, W, K, M
        F, F, F, F,  # cx, cy, 1/fx, 1/fy
        F, F, F, F, F, F, F, F,  # voxel, block, 1/voxel, half voxel, 2 voxel, 1/M, dmin, dmax
        P,  # stream
    ]
    lib.o3dt_march_tiles.restype = I
    lib.o3dt_march_occupancy.argtypes = [I, P]  # M, int[4] out
    lib.o3dt_march_occupancy.restype = I
    lib.o3dt_fuse_blocks.argtypes = [
        P, P, P, P, P, P,  # tw, color, rows, tsdf_new, wn, cnew
        I, I, I, F,  # M, C, B3, weight_max
        P,  # stream
    ]
    lib.o3dt_fuse_blocks.restype = I
    lib.o3dt_fuse_occupancy.argtypes = [I, I, P]  # with_color, B3, int[4] out
    lib.o3dt_fuse_occupancy.restype = I
    lib.o3dt_integrate_blocks_v1.argtypes = [
        P, P, P, P, I, I,  # tw, color, slots, coords, M, C
        P, I, I,  # planes (5, H, W) bf16, H, W
        P,  # params (R row-major 9, t 3) on the device
        F, F, F, F,  # fx fy cx cy
        F, F, F, F, F, F,  # voxel, block, -trunc, 1/trunc, depth_max, weight_max
        P,  # stream
    ]
    lib.o3dt_integrate_blocks_v1.restype = I
    lib.o3dt_micro_gather.argtypes = [P, P, P, I, ctypes.c_longlong, P]  # table, idx, out, R, n
    lib.o3dt_micro_gather.restype = I
    lib.o3dt_micro_gather_occupancy.argtypes = [I, P]  # R, int[4] out
    lib.o3dt_micro_gather_occupancy.restype = I
    lib.o3dt_micro_raymarch.argtypes = [P, P, P, I, I, P]  # tw, rows, out, T, C
    lib.o3dt_micro_raymarch.restype = I
    lib.o3dt_micro_raymarch_occupancy.argtypes = [P]  # int[4] out
    lib.o3dt_micro_raymarch_occupancy.restype = I
    lib.o3dt_probe_elementwise.argtypes = [P, P, I, I, I, I, I, P]  # x, out, kind, rows, cols, n_out, iters
    lib.o3dt_probe_elementwise.restype = I
    lib.o3dt_probe_gather.argtypes = [P, P, P, I, I, I, P]  # x, idx, out, rows, width, iters
    lib.o3dt_probe_gather.restype = I
    lib.o3dt_probe_reduce.argtypes = [P, P, P, I, I, I, I, P]  # x, idx, out, kind, rows, cols, iters
    lib.o3dt_probe_reduce.restype = I
    lib.o3dt_probe_onehot.argtypes = [P, P, I, I, I, P]  # idx, out, rows, cols, iters
    lib.o3dt_probe_onehot.restype = I
    lib.o3dt_probe_mma_bf16.argtypes = [P, P, P, I, I, I, I, P]  # a, b, out, M, K, N, iters
    lib.o3dt_probe_mma_bf16.restype = I
    lib.o3dt_probe_ffma.argtypes = [P, P, P, P, I, I, I, I, P]  # a, v, split_out, out, M, K, N, iters
    lib.o3dt_probe_ffma.restype = I
    lib.o3dt_probe_occupancy.argtypes = [I, I, P]  # family (0 bf16, 1 f32), N, int[4] out
    lib.o3dt_probe_occupancy.restype = I
    lib.o3dt_bilateral_depth.argtypes = [
        P, P, I, I, I,  # in, out, H, W, radius
        ctypes.c_double, F,  # 1 / (2 sigma_space^2), 1 / (2 sigma_depth^2)
        P,  # stream
    ]
    lib.o3dt_bilateral_depth.restype = I
    lib.o3dt_pyrdown_depth.argtypes = [P, P, P, I, I, F, P]  # in, k5, out, H, W, diff_threshold
    lib.o3dt_pyrdown_depth.restype = I
    lib.o3dt_p2p_blocks.argtypes = [I]  # source pixels
    lib.o3dt_p2p_blocks.restype = I
    lib.o3dt_p2p_sums.argtypes = [
        P, P, P, P, P,  # src, src_valid, tgt rows, T, partials
        I, I, I,  # n, target H, W
        F, F, F, F,  # fx fy cx cy
        F, F, F, F,  # width - 1, height - 1, outlier cut, Huber delta
        P,  # stream
    ]
    lib.o3dt_p2p_sums.restype = I
    lib.o3dt_p2p_solve.argtypes = [P, I, P, P, ctypes.c_double, P]  # partials, CTAs, T, rmse, damping
    lib.o3dt_p2p_solve.restype = I
    lib.o3dt_error_string.argtypes = [I]
    lib.o3dt_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the kernel entry `entry`(*args, stream) on the current stream of
    `device` (a CUDA tensor's device, which names its index), raise on its
    error code (check), and count it in LAUNCHES."""
    check(getattr(load(), entry)(*args, torch._C._cuda_getCurrentRawStream(device.index)))
    LAUNCHES[entry] += 1


def launch_counts() -> collections.Counter:
    """A copy of LAUNCHES: each C entry's launches since reset_launches()
    (0 for an entry not launched)."""
    return LAUNCHES.copy()


def reset_launches() -> None:
    LAUNCHES.clear()


def occupancy(entry: str, *args) -> dict:
    """A kernel's CTAs a multiprocessor, the card's multiprocessors, its
    threads a CTA and registers a thread, from the C entry `entry`(*args,
    int out[4])."""
    out = (ctypes.c_int * 4)()
    check(getattr(load(), entry)(*args, out))
    return dict(zip(("ctas_per_sm", "sms", "threads", "registers"), out))


def check(err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().o3dt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {err})")
