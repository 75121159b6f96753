"""Native host runtime (port of open3d_tpu/native/): a C++ library built
with g++ at first use and bound through ctypes. It owns host-side hot
paths: the LZF codec of binary_compressed PCD files and a threaded
read-ahead file prefetcher that overlaps disk reads with work on the card.

The source, `native/src/o3dtpu_native.cpp`, is the JAX package's file,
byte for byte. It is compiled with `g++ -O3 -std=c++17 -shared -fPIC
-pthread`, as the JAX package compiles it, into
`open3d_tpu_torch/_build/native/<hash of the source>/`, so a fresh checkout
builds it on its first `load()`. Where no g++ is found, `load()` returns
None and each entry point takes its Python route: the LZF codec of
io/pcd.py and a thread pool of file reads. Where g++ is found and the
build fails, `load()` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "src" / "o3dtpu_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build" / "native"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compile() -> Optional[Path]:
    """The built library's path, building it if needed; None without g++."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_ROOT / tag / "o3dtpu_native.so"
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.build{os.getpid()}")
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"open3d_tpu_torch.native: g++ failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole library or none
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None where no g++ is found (the Python routes)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        so = _compile()
        _TRIED = True
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.o3d_lzf_decompress.restype = ctypes.c_long
        lib.o3d_lzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.o3d_lzf_compress.restype = ctypes.c_long
        lib.o3d_lzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.o3d_prefetcher_create.restype = ctypes.c_void_p
        lib.o3d_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        lib.o3d_prefetcher_wait.restype = ctypes.c_long
        lib.o3d_prefetcher_wait.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.o3d_prefetcher_take.restype = ctypes.c_long
        lib.o3d_prefetcher_take.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.o3d_prefetcher_peek_size.restype = ctypes.c_long
        lib.o3d_prefetcher_peek_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.o3d_prefetcher_destroy.restype = None
        lib.o3d_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """liblzf decompression of `data` into at most `expected_size` bytes."""
    lib = load()
    if lib is None:
        from open3d_tpu_torch.io.pcd import lzf_decompress as py

        return py(data, expected_size)
    out = ctypes.create_string_buffer(expected_size)
    n = lib.o3d_lzf_decompress(data, len(data), out, expected_size)
    if n < 0:
        raise ValueError("malformed LZF stream")
    return out.raw[:n]


def lzf_compress(data: bytes) -> bytes:
    """liblzf compression (the native codec finds back references; the
    Python one writes literal runs only: both decode with any liblzf)."""
    lib = load()
    if lib is None:
        from open3d_tpu_torch.io.pcd import lzf_compress as py

        return py(data)
    cap = len(data) + len(data) // 16 + 64 + len(data) // 32
    out = ctypes.create_string_buffer(cap)
    n = lib.o3d_lzf_compress(data, len(data), out, cap)
    if n < 0:
        raise ValueError("LZF compression overflow")
    return out.raw[:n]


class FilePrefetcher:
    """Threaded read-ahead over an ordered file list: the native library's
    worker threads stay up to `depth` files ahead of the last `get`, or,
    without it, a thread pool reads every file. Usage:
    `with FilePrefetcher(paths) as p: data = p.get(i)`."""

    def __init__(self, paths, n_threads: int = 4, depth: int = 8):
        self.paths = [os.fspath(p) for p in paths]
        self._lib = load()
        self._handle = None
        self._pool = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._keepalive = arr  # the workers read these strings until destroy
            self._handle = ctypes.c_void_p(
                self._lib.o3d_prefetcher_create(arr, len(self.paths), n_threads, depth))
        else:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=n_threads)
            self._futures = {i: self._pool.submit(self._read, p) for i, p in enumerate(self.paths)}

    @property
    def native(self) -> bool:
        """Whether the native library reads the files."""
        return self._lib is not None

    @staticmethod
    def _read(path):
        with open(path, "rb") as f:
            return f.read()

    def get(self, i: int) -> bytes:
        """File i's bytes, waiting until they are read."""
        if self._handle is not None:
            sz = self._lib.o3d_prefetcher_wait(self._handle, i)
            buf = ctypes.create_string_buffer(max(sz, 1))
            n = self._lib.o3d_prefetcher_take(self._handle, i, buf, max(sz, 1))
            if n < 0:
                raise RuntimeError(f"prefetcher lost file {i}")
            return buf.raw[:n]
        if self._pool is None:
            raise RuntimeError("FilePrefetcher is closed")
        return self._futures[i].result()

    def close(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.o3d_prefetcher_destroy(self._handle)
            self._handle = None
        elif getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
