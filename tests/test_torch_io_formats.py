"""Port parity for the IO formats (io/pcd.py, io/splat.py,
io/mesh_formats.py and io/__init__.py's dispatch), the native library
(native/: LZF and the file prefetcher) and RGBDSequence.iter_frames:
tests/test_io.py's cases for these on the port, and every format across
the two packages.

Bars:
- a file either package writes reads in the other: PCD in all three
  encodings (binary_compressed built by the JAX package's LZF, as its own
  test builds it), splat, STL, OFF and GLB; positions, normals and scales
  bit-exact where the format stores float32, colours within the 1/255 of
  their byte, the text formats (.xyz, .xyzn, .pts: 7 decimals) within
  5e-8 + 1e-7 relative;
- the port writes the JAX package's bytes for the same geometry (PCD
  binary and ASCII, splat, STL, OFF, GLB, the text formats);
- LZF streams decode to their input across the native and the Python
  codecs of both packages, each direction;
- the prefetcher returns every file's bytes, natively and on its Python
  route; iter_frames yields read_frame's frames exactly, through the
  native prefetcher.
"""

import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open3d_tpu.io as jio
from open3d_tpu import native as jnative
from open3d_tpu.geometry.pointcloud import PointCloud as JCloud
from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
from open3d_tpu.io import pcd as jpcd
from open3d_tpu_torch import io as tio
from open3d_tpu_torch import native
from open3d_tpu_torch.data import dataset as tds
from open3d_tpu_torch.geometry.pointcloud import PointCloud as TCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh as TMesh
from open3d_tpu_torch.io import pcd as tpcd

torch.set_num_threads(2)


def _arrays(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pos, nrm, col


def _clouds(seed=0):
    pos, nrm, col = _arrays(seed=seed)
    return (JCloud.create(pos, normals=nrm, colors=col),
            TCloud.create(pos, normals=nrm, colors=col, device="cpu"))


def _same_cloud(t, want, colors=True, atol=0.0):
    d = t.to_numpy()
    np.testing.assert_allclose(d["positions"], want["positions"], rtol=0, atol=atol)
    if "normals" in want:
        np.testing.assert_allclose(d["normals"], want["normals"], rtol=0, atol=atol)
    if colors and "colors" in want:
        np.testing.assert_allclose(d["colors"], want["colors"], rtol=0, atol=1 / 255 + 1e-7)


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


# ---- tests/test_io.py's cases on the port ---------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_pcd_roundtrip(tmp_path, binary):
    pos, nrm, col = _arrays(100, 1)
    p = str(tmp_path / "a.pcd")
    tpcd.write_pcd(p, pos, normals=nrm, colors=col, binary=binary)
    back = tio.read_point_cloud(p, device="cpu")
    np.testing.assert_allclose(back.positions.numpy(), pos, atol=1e-5)
    np.testing.assert_allclose(back.attrs["colors"].numpy(), col, atol=1 / 255.0)


def test_lzf_roundtrip():
    data = np.random.RandomState(0).bytes(10000) + b"\x00" * 5000
    assert tpcd.lzf_decompress(tpcd.lzf_compress(data), len(data)) == data


def test_binary_compressed_read(tmp_path):
    """A binary_compressed PCD built by hand with the JAX package's LZF."""
    n = 50
    xyz = np.random.RandomState(2).uniform(-1, 1, (n, 3)).astype(np.float32)
    raw = b"".join(np.ascontiguousarray(xyz[:, i]).tobytes() for i in range(3))
    comp = jpcd.lzf_compress(raw)
    header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary_compressed\n")
    p = str(tmp_path / "c.pcd")
    with open(p, "wb") as f:
        f.write(header.encode() + struct.pack("<II", len(comp), len(raw)) + comp)
    d = tpcd.read_pcd(p)
    np.testing.assert_array_equal(d["x"], xyz[:, 0])
    np.testing.assert_array_equal(d["z"], xyz[:, 2])


def test_native_builds_into_the_port_tree():
    lib = native.load()
    assert lib is not None and native.load() is lib
    built = list(native.BUILD_ROOT.glob("*/o3dtpu_native.so"))
    assert built and all(b.is_relative_to(native.BUILD_ROOT) for b in built)
    src = os.path.join(os.path.dirname(native.__file__), "src", "o3dtpu_native.cpp")
    ref = os.path.join(os.path.dirname(jnative.__file__), "src", "o3dtpu_native.cpp")
    assert _bytes(src) == _bytes(ref)


LZF_DATA = [np.random.RandomState(0).bytes(5000), b"abc" * 4000, b"", b"\x00" * 100000]


@pytest.mark.parametrize("data", LZF_DATA, ids=["random", "repeats", "empty", "zeros"])
def test_lzf_across_codecs_and_packages(data):
    """Every compressor's stream decodes to its input in every
    decompressor: native and Python, port and JAX package."""
    comps = {"port native": native.lzf_compress, "port python": tpcd.lzf_compress,
             "jax native": jnative.lzf_compress, "jax python": jpcd.lzf_compress}
    decomps = {"port native": native.lzf_decompress, "port python": tpcd.lzf_decompress,
               "jax native": jnative.lzf_decompress, "jax python": jpcd.lzf_decompress}
    streams = {k: c(data) for k, c in comps.items()}
    assert streams["port native"] == streams["jax native"]
    assert streams["port python"] == streams["jax python"]
    if len(data) > 1000:
        assert len(streams["port native"]) < len(data) // 2 or data == LZF_DATA[0]
    for ck, s in streams.items():
        for dk, d in decomps.items():
            assert d(s, len(data)) == data, (ck, dk)


def _files(tmp_path, n=12):
    rng = np.random.RandomState(1)
    paths, blobs = [], []
    for i in range(n):
        p = str(tmp_path / f"f{i}.bin")
        b = rng.bytes(500 + 37 * i)
        with open(p, "wb") as f:
            f.write(b)
        paths.append(p)
        blobs.append(b)
    return paths, blobs


@pytest.mark.parametrize("route", ["native", "python"])
def test_prefetcher(tmp_path, monkeypatch, route):
    paths, blobs = _files(tmp_path)
    if route == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    with native.FilePrefetcher(paths, n_threads=3, depth=4) as pf:
        assert pf.native == (route == "native")
        for i in range(12):
            assert pf.get(i) == blobs[i]
    with pytest.raises(RuntimeError):
        pf.get(0)


def test_sequence_iter_frames(tmp_path, monkeypatch):
    seq = tds.synthetic_rgbd_sequence(n_frames=3, width=64, height=48,
                                      out_dir=str(tmp_path / "seq"), device="cpu")
    routes = []
    real = native.FilePrefetcher

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            routes.append(self.native)

    monkeypatch.setattr(native, "FilePrefetcher", Spy)
    frames = list(seq.iter_frames(n_threads=2, depth_ahead=2))
    assert routes == [True] and len(frames) == 3
    for i, (d, c) in enumerate(frames):
        d0, c0 = seq.read_frame(i)
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(c, c0)


@pytest.mark.parametrize("ext", [".stl", ".off", ".glb"])
def test_mesh_format_roundtrip(tmp_path, ext):
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    t = np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    p = str(tmp_path / f"m{ext}")
    tio.write_triangle_mesh(p, TMesh.create(v, t, device="cpu"))
    v2, t2 = tio.read_triangle_mesh(p, device="cpu").compact()
    assert len(t2) == len(t)
    assert {tuple(np.round(x, 5)) for x in v} == {tuple(np.round(x, 5)) for x in v2}


def _splat_arrays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1  # the canonical hemisphere (the u8 round trip's sign)
    return dict(positions=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                f_dc=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                opacity=rng.uniform(-3, 3, (n, 1)).astype(np.float32),
                scale=rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32), rot=q)


def test_splat_roundtrip(tmp_path):
    a = _splat_arrays()
    pcd = TCloud.create(a["positions"], device="cpu", **{k: v for k, v in a.items()
                                                          if k != "positions"})
    p = str(tmp_path / "g.splat")
    tio.write_point_cloud(p, pcd)
    assert os.path.getsize(p) == 32 * 64
    back = tio.read_point_cloud(p, device="cpu")
    assert int(back.count()) == 64
    oa, ob = np.lexsort(a["positions"].T), np.lexsort(back.positions.numpy().T)
    np.testing.assert_array_equal(back.positions.numpy()[ob], a["positions"][oa])
    np.testing.assert_array_equal(back.attrs["scale"].numpy()[ob], a["scale"][oa])
    sig = lambda x: 1 / (1 + np.exp(-x.reshape(-1)))  # noqa: E731
    np.testing.assert_allclose(sig(back.attrs["opacity"].numpy()[ob]), sig(a["opacity"][oa]),
                               atol=1 / 255)
    np.testing.assert_allclose(back.attrs["rot"].numpy()[ob], a["rot"][oa], atol=0.02)


# ---- across the two packages ----------------------------------------------

@pytest.mark.parametrize("encoding", ["binary", "ascii", "binary_compressed"])
def test_pcd_across_packages(tmp_path, encoding):
    pj, pt = _clouds(2)
    want = pt.to_numpy()
    a, b = str(tmp_path / "port.pcd"), str(tmp_path / "jax.pcd")
    if encoding == "binary_compressed":
        tpcd.write_pcd_compressed(a, want["positions"], want["normals"], want["colors"])
        cols = [want["positions"][:, i] for i in range(3)] + [want["normals"][:, i]
                                                               for i in range(3)]
        c8 = np.clip(want["colors"].astype(np.float64) * 255.0, 0, 255).astype(np.uint32)
        cols.append((c8[:, 0] << 16 | c8[:, 1] << 8 | c8[:, 2]).view(np.float32))
        raw = b"".join(np.ascontiguousarray(c, "<f4").tobytes() for c in cols)
        comp = jpcd.lzf_compress(raw)
        head = _bytes(a)[:_bytes(a).index(b"DATA binary_compressed\n") + 23]
        with open(b, "wb") as f:
            f.write(head + struct.pack("<II", len(comp), len(raw)) + comp)
        assert _bytes(a)[len(head) + 8:] == native.lzf_compress(raw)
        assert native.lzf_decompress(_bytes(a)[len(head) + 8:], len(raw)) == raw
    else:
        binary = encoding == "binary"
        tpcd.write_pcd(a, want["positions"], want["normals"], want["colors"], binary=binary)
        jpcd.write_pcd(b, want["positions"], want["normals"], want["colors"], binary=binary)
        assert _bytes(a) == _bytes(b)
    for p in (a, b):
        _same_cloud(tio.read_point_cloud(p, device="cpu"), want)
        got = jio.read_point_cloud(p)
        np.testing.assert_array_equal(np.asarray(got.positions), want["positions"])
        np.testing.assert_array_equal(np.asarray(got.attrs["normals"]), want["normals"])
        np.testing.assert_array_equal(np.asarray(got.attrs["colors"]),
                                      tio.read_point_cloud(p, device="cpu").attrs["colors"].numpy())


def test_splat_across_packages(tmp_path):
    a = _splat_arrays(80, 3)
    attrs = {k: v for k, v in a.items() if k != "positions"}
    a_path, b_path = str(tmp_path / "port.splat"), str(tmp_path / "jax.splat")
    tio.write_point_cloud(a_path, TCloud.create(a["positions"], device="cpu", **attrs))
    jio.write_point_cloud(b_path, JCloud.create(jnp.asarray(a["positions"]),
                                                **{k: jnp.asarray(v) for k, v in attrs.items()}))
    assert _bytes(a_path) == _bytes(b_path)
    t, j = tio.read_point_cloud(a_path, device="cpu"), jio.read_point_cloud(a_path)
    np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
    for k in attrs:
        np.testing.assert_array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]), err_msg=k)


@pytest.mark.parametrize("ext", [".xyz", ".xyzn", ".pts", ".npz"])
def test_point_formats_across_packages(tmp_path, ext):
    pj, pt = _clouds(4)
    want = pt.to_numpy()
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    tio.write_point_cloud(a, pt)
    jio.write_point_cloud(b, pj)
    if ext != ".npz":  # npz holds the writer's zip timestamps
        assert _bytes(a) == _bytes(b)
    exact = ext == ".npz"
    for p in (a, b):
        t, j = tio.read_point_cloud(p, device="cpu"), jio.read_point_cloud(p)
        np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
        np.testing.assert_allclose(t.positions.numpy(), want["positions"], rtol=1e-7,
                                   atol=0 if exact else 5e-8)
        assert set(t.attrs) == set(j.attrs)
        for k in t.attrs:
            np.testing.assert_array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]), err_msg=k)
        if ext == ".xyzn":
            np.testing.assert_allclose(t.attrs["normals"].numpy(), want["normals"], rtol=1e-7,
                                       atol=5e-8)
    with pytest.raises(ValueError, match="unsupported point cloud format"):
        tio.read_point_cloud(str(tmp_path / "x.las"), device="cpu")
    with pytest.raises(ValueError, match="unsupported point cloud format"):
        tio.write_point_cloud(str(tmp_path / "x.las"), pt)


def _tetra_mesh():
    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    t = rng.integers(0, 40, (60, 3)).astype(np.int32)
    t = t[(t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])]
    return v, t


@pytest.mark.parametrize("ext", [".stl", ".off", ".glb"])
def test_mesh_formats_across_packages(tmp_path, ext):
    v, t = _tetra_mesh()
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    tio.write_triangle_mesh(a, TMesh.create(v, t, device="cpu"))
    jio.write_triangle_mesh(b, JMesh.create(v, t))
    assert _bytes(a) == _bytes(b)
    tv, tt = tio.read_triangle_mesh(a, device="cpu").compact()
    jv, jt = jio.read_triangle_mesh(a).compact()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tv, jv)
    # the same triangles over the same points as written (STL welds and reorders)
    src = {tuple(sorted(map(tuple, np.round(v[tri], 5)))) for tri in t}
    got = {tuple(sorted(map(tuple, np.round(tv[tri], 5)))) for tri in tt}
    assert got == src


def test_mesh_text_variants_read_as_the_reference(tmp_path):
    """ASCII STL, OFF with a quad and comments, and a .gltf with an
    embedded buffer, each read by both packages."""
    import base64
    import json

    stl = tmp_path / "a.stl"
    stl.write_text("solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 1 0 0\n"
                   "vertex 0 1 0\nendloop\nendfacet\nfacet normal 0 0 1\nouter loop\n"
                   "vertex 1 0 0\nvertex 1 1 0\nvertex 0 1 0\nendloop\nendfacet\nendsolid t\n")
    off = tmp_path / "a.off"
    off.write_text("OFF\n# a quad and a triangle\n5 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
                   "0.5 0.5 1\n4 0 1 2 3\n3 0 1 4\n")
    b = tmp_path / "m.glb"
    jio.write_triangle_mesh(str(b), JMesh.create(*_tetra_mesh()))
    raw = _bytes(str(b))
    (ln,) = struct.unpack("<I", raw[12:16])
    gltf = json.loads(raw[20:20 + ln])
    gltf["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                 + base64.b64encode(raw[28 + ln:]).decode())
    emb = tmp_path / "e.gltf"
    emb.write_text(json.dumps(gltf))
    for p in (stl, off, emb):
        tv, tt = tio.read_triangle_mesh(str(p), device="cpu").compact()
        jv, jt = jio.read_triangle_mesh(str(p)).compact()
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)
    assert len(tio.read_triangle_mesh(str(off), device="cpu").compact()[1]) == 3


def test_dataset_directory_reads_in_both(tmp_path):
    """A TUM directory the port writes decodes alike through the port's
    prefetched stream and the JAX package's (PIL on the native
    prefetcher)."""
    from open3d_tpu.data import dataset as jds

    seq = tds.synthetic_rgbd_sequence(n_frames=2, width=48, height=32,
                                      out_dir=str(tmp_path / "s"), device="cpu")
    root = os.path.dirname(seq.depth_paths[0])
    shutil.copytree(root, tmp_path / "copy")
    jseq = jds.RGBDSequence([p.replace(root, str(tmp_path / "copy")) for p in seq.color_paths],
                            [p.replace(root, str(tmp_path / "copy")) for p in seq.depth_paths],
                            seq.depth_scale, None)
    for (d, c), (jd, jc) in zip(seq.iter_frames(), jseq.iter_frames()):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(c, jc)
