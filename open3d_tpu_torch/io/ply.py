"""PLY reader/writer, ascii and binary (port of open3d_tpu/io/ply.py, which
needs no JAX; the port keeps its own copy). Point clouds (positions,
normals, colours) and triangle meshes; numpy and the standard library only.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f):
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    while True:
        line = f.readline().decode("ascii").strip()
        if line.startswith("comment") or line.startswith("obj_info") or not line:
            continue
        if line == "end_header":
            break
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_TO_NP[parts[3]], True, _PLY_TO_NP[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]], False, None))
    return fmt, elements


def read_ply(path: str) -> dict:
    """Returns {element_name: {prop: np.ndarray}}; list properties (faces)
    come back as (N, k) when fixed-arity else a Python list."""
    out = {}
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                out[name] = _decode_ascii(rows, props)
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            endian = "<" if fmt == "binary_little_endian" else ">"
            for name, count, props in elements:
                if any(p[2] for p in props):
                    out[name] = _decode_binary_lists(f, count, props, endian)
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
                    out[name] = {p[0]: np.ascontiguousarray(arr[p[0]]) for p in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return out


def _decode_ascii(rows, props):
    cols = {p[0]: [] for p in props}
    for row in rows:
        i = 0
        for pname, dt, is_list, cdt in props:
            if is_list:
                n = int(row[i]); i += 1
                cols[pname].append([float(x) for x in row[i : i + n]]); i += n
            else:
                cols[pname].append(float(row[i])); i += 1
    out = {}
    for pname, dt, is_list, cdt in props:
        if is_list:
            lens = {len(v) for v in cols[pname]}
            if len(lens) == 1:
                out[pname] = np.asarray(cols[pname], dtype=dt)
            else:
                out[pname] = [np.asarray(v, dtype=dt) for v in cols[pname]]
        else:
            out[pname] = np.asarray(cols[pname], dtype=dt)
    return out


def _decode_binary_lists(f, count, props, endian):
    cols = {p[0]: [] for p in props}
    for _ in range(count):
        for pname, dt, is_list, cdt in props:
            if is_list:
                n = int(np.frombuffer(f.read(np.dtype(cdt).itemsize), dtype=endian + cdt)[0])
                itemsize = np.dtype(dt).itemsize
                cols[pname].append(np.frombuffer(f.read(itemsize * n), dtype=endian + dt))
            else:
                itemsize = np.dtype(dt).itemsize
                cols[pname].append(np.frombuffer(f.read(itemsize), dtype=endian + dt)[0])
    out = {}
    for pname, dt, is_list, cdt in props:
        if is_list:
            lens = {len(v) for v in cols[pname]}
            out[pname] = (
                np.stack(cols[pname]).astype(dt) if len(lens) == 1 else cols[pname]
            )
        else:
            out[pname] = np.asarray(cols[pname], dtype=dt)
    return out


def write_ply(
    path: str,
    positions: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    triangles: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write a point cloud or triangle mesh. colors float in [0,1] are
    converted to uchar (the conventional PLY encoding the reference emits)."""
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0"]
    header.append(f"element vertex {n}")
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        fields += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(np.asarray(colors, np.float64) * 255.0, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if triangles is not None:
        triangles = np.asarray(triangles, np.int32)
        header.append(f"element face {triangles.shape[0]}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    vert = np.zeros(n, dtype=np.dtype([(f, t) for f, t in fields]))
    vert["x"], vert["y"], vert["z"] = positions[:, 0], positions[:, 1], positions[:, 2]
    if normals is not None:
        nn = np.asarray(normals, np.float32)
        vert["nx"], vert["ny"], vert["nz"] = nn[:, 0], nn[:, 1], nn[:, 2]
    if colors is not None:
        vert["red"], vert["green"], vert["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(vert.tobytes())
            if triangles is not None:
                face = np.zeros(
                    triangles.shape[0],
                    dtype=np.dtype([("n", "u1"), ("v", "i4", (3,))]),
                )
                face["n"] = 3
                face["v"] = triangles
                f.write(face.tobytes())
        else:
            for i in range(n):
                f.write((" ".join(str(vert[name][i]) for name in vert.dtype.names) + "\n").encode())
            if triangles is not None:
                for tri in triangles:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())
