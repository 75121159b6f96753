"""PCD reader and writer, ASCII, binary and binary_compressed (port of
open3d_tpu/io/pcd.py; PCL's container, as Open3D's FilePCD.cpp reads it).

The LZF codec here is liblzf's block format in pure Python, the route
`native.lzf_decompress` / `lzf_compress` take where the native library is
not built. `write_pcd` writes the bytes the JAX package's writes;
`write_pcd_compressed` writes the binary_compressed layout (the fields
column after column, LZF-compressed behind their two sizes), which the JAX
package reads and does not write.
"""

from __future__ import annotations

import struct

import numpy as np

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """liblzf decompression (literal runs and back references)."""
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):  # an overlapping copy runs forward
                out[o] = out[ref]
                o += 1
                ref += 1
    return bytes(out[:o])


def lzf_compress(data: bytes) -> bytes:
    """A valid LZF stream of literal runs only (ratio 1.0): any liblzf
    implementation decodes it."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        out.append(len(chunk) - 1)
        out.extend(chunk)
    return bytes(out)


def read_pcd(path: str) -> dict:
    """{field: np.ndarray} of a PCD file; the caller combines x, y, z."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: PCD header ends before DATA")
            line = raw.decode("ascii", "ignore").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]

        dt_fields = []
        for fname, sz, ty, ct in zip(fields, sizes, types, counts):
            base = _TYPE_MAP[(ty, sz)]
            dt_fields.append((fname, "<" + base, (ct,)) if ct > 1 else (fname, "<" + base))
        dt = np.dtype(dt_fields)

        if mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, -1)
            out, col = {}, 0
            for fname, sz, ty, ct in zip(fields, sizes, types, counts):
                base = _TYPE_MAP[(ty, sz)]
                out[fname] = (rows[:, col:col + ct].astype(base).squeeze(-1) if ct > 1
                              else rows[:, col].astype(base))
                col += ct
            return out
        if mode == "binary":
            arr = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            return {fname: np.ascontiguousarray(arr[fname]) for fname in fields}
        if mode == "binary_compressed":
            from open3d_tpu_torch import native

            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = native.lzf_decompress(f.read(comp_size), uncomp_size)
            out, off = {}, 0  # column after column
            for fname, sz, ty, ct in zip(fields, sizes, types, counts):
                base = np.dtype("<" + _TYPE_MAP[(ty, sz)])
                nbytes = base.itemsize * ct * n
                col = np.frombuffer(raw[off:off + nbytes], dtype=base)
                out[fname] = col.reshape(n, ct).squeeze(-1) if ct > 1 else col
                off += nbytes
            return out
    raise ValueError(f"unsupported PCD DATA mode {mode}")


def _columns(positions, normals, colors):
    """(field names, float32 columns): x y z, normal_x.. when given, and rgb
    as the float32 whose bits are 0x00RRGGBB."""
    positions = np.asarray(positions, np.float32)
    fields = ["x", "y", "z"]
    cols = [positions[:, 0], positions[:, 1], positions[:, 2]]
    if normals is not None:
        nn = np.asarray(normals, np.float32)
        fields += ["normal_x", "normal_y", "normal_z"]
        cols += [nn[:, 0], nn[:, 1], nn[:, 2]]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(np.asarray(c, np.float64) * 255.0, 0, 255).astype(np.uint8)
        rgb = (c[:, 0].astype(np.uint32) << 16 | c[:, 1].astype(np.uint32) << 8
               | c[:, 2].astype(np.uint32)).view(np.float32)
        fields.append("rgb")
        cols.append(rgb)
    return fields, cols


def _header(fields, n: int, data: str) -> bytes:
    k = len(fields)
    return ("\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(["4"] * k),
        "TYPE " + " ".join(["F"] * k),
        "COUNT " + " ".join(["1"] * k),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA " + data,
    ]) + "\n").encode("ascii")


def write_pcd(
    path: str,
    positions: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """A binary (records of float32 fields) or ASCII PCD file; the ASCII
    values are printed as Python's repr of each float32, as the JAX
    package prints them."""
    fields, cols = _columns(positions, normals, colors)
    n = cols[0].shape[0]
    with open(path, "wb") as f:
        f.write(_header(fields, n, "binary" if binary else "ascii"))
        if binary:
            arr = np.zeros(n, dtype=np.dtype([(fn, "<f4") for fn in fields]))
            for fn, col in zip(fields, cols):
                arr[fn] = col
            f.write(arr.tobytes())
        else:
            rows = zip(*[col.tolist() for col in cols])
            f.write("".join(" ".join(map(repr, r)) + "\n" for r in rows).encode())


def write_pcd_compressed(path: str, positions, normals=None, colors=None) -> None:
    """A binary_compressed PCD file: the float32 fields of `write_pcd`,
    column after column, LZF-compressed (native.lzf_compress)."""
    from open3d_tpu_torch import native

    fields, cols = _columns(positions, normals, colors)
    raw = b"".join(np.ascontiguousarray(c, "<f4").tobytes() for c in cols)
    comp = native.lzf_compress(raw)
    with open(path, "wb") as f:
        f.write(_header(fields, cols[0].shape[0], "binary_compressed"))
        f.write(struct.pack("<II", len(comp), len(raw)))
        f.write(comp)
