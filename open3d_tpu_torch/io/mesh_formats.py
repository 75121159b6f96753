"""STL, OFF and glTF / GLB mesh codecs in numpy (port of
open3d_tpu/io/mesh_formats.py; Open3D's FileSTL.cpp, FileOFF.cpp and
FileGLTF.cpp). They read and write (vertices (V, 3) float32, triangles
(T, 3) int32) on the host; io/__init__.py moves them to and from a
TriangleMesh. The writers write the JAX package's bytes. A file that is
not of its format raises ValueError.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np


# ----------------------------------------------------------------- STL ----
def read_stl(path: str):
    """Binary or ASCII STL -> (vertices (V, 3) f32, triangles (T, 3) i32),
    the triangle soup's vertices welded where they are equal, as the
    reference's reader indexes unique vertices."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    is_ascii = head[:5] == b"solid" and b"facet" in (head + rest[:200])
    if is_ascii:
        tris_v = []
        for ln in (head + rest).decode("ascii", "ignore").splitlines():
            p = ln.split()
            if p[:1] == ["vertex"]:
                tris_v.append([float(p[1]), float(p[2]), float(p[3])])
        soup = np.asarray(tris_v, np.float32).reshape(-1, 3, 3)
    else:
        if len(head) < 80 or len(rest) < 4:
            raise ValueError(f"{path}: not an STL file (too short)")
        (n,) = struct.unpack("<I", rest[:4])
        if len(rest) < 4 + 50 * n:
            raise ValueError(f"{path}: binary STL of {n} triangles holds {len(rest) - 4} bytes")
        data = np.frombuffer(rest[4:4 + n * 50], dtype=np.uint8).reshape(n, 50)
        soup = data[:, :48].copy().view(np.float32).reshape(n, 4, 3)[:, 1:4]  # the normal row dropped
    uniq, inv = np.unique(soup.reshape(-1, 3), axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)


def write_stl(path: str, vertices, triangles) -> None:
    """Binary STL with unit facet normals (Open3D's WriteTriangleMeshToSTL)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    tri = v[t]  # (T, 3, 3)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = (nrm / np.maximum(ln, 1e-12)).astype(np.float32)
    rec = np.zeros((len(t), 50), np.uint8)
    payload = np.concatenate([nrm[:, None, :], tri], axis=1).reshape(len(t), 12)
    rec[:, :48] = payload.astype(np.float32).view(np.uint8).reshape(len(t), 48)
    with open(path, "wb") as f:
        f.write(b"open3d_tpu binary STL".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(t)))
        f.write(rec.tobytes())


# ----------------------------------------------------------------- OFF ----
def read_off(path: str):
    """OFF -> (vertices, triangles); polygons fan-triangulated."""
    toks = []
    with open(path) as f:
        for ln in f:
            ln = ln.split("#")[0].strip()
            if ln:
                toks.extend(ln.split())
    if not toks or toks[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = int(toks[1]), int(toks[2])
    i = 4
    verts = np.asarray(toks[i:i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    tris = []
    for _ in range(nf):
        k = int(toks[i])
        ids = [int(x) for x in toks[i + 1:i + 1 + k]]
        for j in range(1, k - 1):
            tris.append([ids[0], ids[j], ids[j + 1]])
        i += 1 + k
    return verts, np.asarray(tris, np.int32).reshape(-1, 3)


def write_off(path: str, vertices, triangles) -> None:
    """OFF with 7 decimals a coordinate."""
    v = np.asarray(vertices)
    t = np.asarray(triangles)
    lines = ["OFF", f"{len(v)} {len(t)} 0"]
    lines += [f"{p[0]:.7f} {p[1]:.7f} {p[2]:.7f}" for p in v.tolist()]
    lines += [f"3 {a} {b} {c}" for a, b, c in t.tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------- glTF ----
def write_glb(path: str, vertices, triangles) -> None:
    """A glTF 2.0 binary holding one mesh: positions and indices (the
    schema of Open3D's FileGLTF.cpp)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.uint32)
    vbytes = v.tobytes()
    ibytes = t.tobytes()
    pad_v = (-len(vbytes)) % 4
    bin_chunk = vbytes + b"\0" * pad_v + ibytes
    bin_chunk += b"\0" * ((-len(bin_chunk)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "open3d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": int(len(v)),
                "type": "VEC3",
                "min": [float(x) for x in v.min(0)] if len(v) else [0, 0, 0],
                "max": [float(x) for x in v.max(0)] if len(v) else [0, 0, 0],
            },
            {"bufferView": 1, "componentType": 5125, "count": int(t.size), "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbytes), "target": 34962},
            {"buffer": 0, "byteOffset": len(vbytes) + pad_v, "byteLength": len(ibytes),
             "target": 34963},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # "glTF", version 2
        f.write(struct.pack("<II", len(js), 0x4E4F534A))  # JSON chunk
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN chunk
        f.write(bin_chunk)


def read_glb(path: str):
    """Positions and indices of the first mesh primitive of a .glb, or of
    a .gltf with an external or embedded (data: URI) buffer. A file that
    starts with the GLB magic reads as GLB whatever its extension:
    `write_glb` writes GLB to a .gltf path too (the JAX package's reader
    then fails on its own file)."""
    with open(path, "rb") as f:
        is_glb = f.read(4) == b"glTF"
    try:
        return _read_gltf(path, is_glb)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{path}: not a glTF mesh ({e!r})") from None


def _read_gltf(path: str, is_glb: bool):
    if not is_glb and path.lower().endswith(".gltf"):
        with open(path) as f:
            gltf = json.load(f)
        uri = gltf["buffers"][0].get("uri", "")
        if uri.startswith("data:"):
            bin_chunk = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(os.path.dirname(path), uri), "rb") as f:
                bin_chunk = f.read()
    else:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or struct.unpack("<I", head[:4])[0] != 0x46546C67:
                raise ValueError(f"{path}: not a GLB file")
            ln, _ = struct.unpack("<II", f.read(8))
            gltf = json.loads(f.read(ln))
            bin_chunk = b""
            hdr = f.read(8)
            if hdr:
                ln2, _ = struct.unpack("<II", hdr)
                bin_chunk = f.read(ln2)

    prim = gltf["meshes"][0]["primitives"][0]

    def load_accessor(aid):
        acc = gltf["accessors"][aid]
        bv = gltf["bufferViews"][acc["bufferView"]]
        off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        comp = {5126: np.float32, 5125: np.uint32, 5123: np.uint16, 5121: np.uint8}[
            acc["componentType"]]
        n_comp = {"VEC3": 3, "VEC2": 2, "SCALAR": 1}[acc["type"]]
        count = acc["count"]
        arr = np.frombuffer(bin_chunk, dtype=comp, count=count * n_comp, offset=off)
        return arr.reshape(count, n_comp) if n_comp > 1 else arr

    verts = load_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
    tris = load_accessor(prim["indices"]).astype(np.int32).reshape(-1, 3)
    return verts, tris
