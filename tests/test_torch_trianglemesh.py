"""Port parity for geometry/trianglemesh.py, the mesh, BVH, VoxelGrid and
Octree carries in convert.py,
the triangle-mesh files of io/__init__.py and io/trajectory.py, against
open3d_tpu on the same seeded numpy inputs.

Bars: integer results (triangles, masks, counts, compacted ids) equal;
float32 results within 1e-5, both packages rounding the same formulas (the
vertex normals' scatter-adds may sum in another order). Sampling draws from
a torch generator, not JAX's stream: samples are held to the mesh (on the
triangles, area-weighted) and the metrics of sampled meshes to the JAX
package's own test bars (tests/test_trianglemesh.py), as is the mesh that
the port extracts from a synthetic scan (that file's sphere case). Files
written by either package are byte for byte the same and read back in both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu import io as jio
from open3d_tpu.geometry import trianglemesh as jtm
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.io import trajectory as jtraj
from open3d_tpu_torch import convert
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry import trianglemesh as ttm
from open3d_tpu_torch.geometry import voxel_block_grid as tvbg
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr
from open3d_tpu_torch.geometry.pointcloud import PointCloud as TPointCloud
from open3d_tpu_torch.io import trajectory as ttraj

torch.set_num_threads(2)
ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               atol=atol, rtol=0)


def _random_mesh(seed=0, V=40, T=60):
    """Random vertices, random triangles with distinct corners, some
    vertices and triangles masked out, per-vertex colours."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    t = np.stack([rng.choice(V, 3, replace=False) for _ in range(T)]).astype(np.int32)
    vm = rng.uniform(size=V) > 0.1
    tm = rng.uniform(size=T) > 0.2
    col = rng.uniform(0, 1, (V, 3)).astype(np.float32)
    return v, t, vm, tm, col


def _pair(seed=0):
    v, t, vm, tm, col = _random_mesh(seed)
    mj = jtm.TriangleMesh.create(v, t, vertex_attrs={"colors": col}, vertex_mask=vm,
                                 triangle_mask=tm)
    mt = ttm.TriangleMesh.create(v, t, vertex_attrs={"colors": col}, vertex_mask=vm,
                                 triangle_mask=tm, device="cpu")
    return mj, mt


def _mesh_eq(mt, mj, atol=ATOL):
    np.testing.assert_array_equal(mt.triangles.numpy(), np.asarray(mj.triangles))
    np.testing.assert_array_equal(mt.vertex_mask.numpy(), np.asarray(mj.vertex_mask))
    np.testing.assert_array_equal(mt.triangle_mask.numpy(), np.asarray(mj.triangle_mask))
    _close(mt.vertices, mj.vertices, atol)
    for dt, dj in ((mt.vertex_attrs, mj.vertex_attrs), (mt.triangle_attrs, mj.triangle_attrs)):
        assert dt.keys() == dj.keys()
        for k in dt:
            _close(dt[k], dj[k], atol)


_T = np.array([[0.36, -0.48, 0.8, 0.1], [0.8, 0.6, 0.0, -0.2], [-0.48, 0.64, 0.6, 0.3],
               [0, 0, 0, 1]], np.float32)
METHODS = {
    "create": lambda m, pkg: m,
    "num_vertices": lambda m, pkg: m.num_vertices(),
    "num_triangles": lambda m, pkg: m.num_triangles(),
    "compute_triangle_normals": lambda m, pkg: m.compute_triangle_normals(),
    "compute_vertex_normals": lambda m, pkg: m.compute_vertex_normals(),
    "triangle_areas": lambda m, pkg: m.triangle_areas(),
    "surface_area": lambda m, pkg: m.surface_area(),
    "transform": lambda m, pkg: m.compute_vertex_normals().transform(
        torch.from_numpy(_T) if pkg == "port" else jnp.asarray(_T)),
    "get_min_bound": lambda m, pkg: m.get_min_bound(),
    "get_max_bound": lambda m, pkg: m.get_max_bound(),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_matches_reference(name):
    mj, mt = _pair(sum(map(ord, name)))
    rj, rt = METHODS[name](mj, "jax"), METHODS[name](mt, "port")
    if isinstance(rt, ttm.TriangleMesh):
        _mesh_eq(rt, rj)
    else:
        _close(rt, rj)


def test_from_triangle_soup():
    rng = np.random.default_rng(3)
    soup = rng.uniform(-1, 1, (7, 3, 3)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    col = rng.uniform(0, 1, (7, 3, 3)).astype(np.float32)
    for c in (None, col):
        mj = jtm.TriangleMesh.from_triangle_soup(soup, mask, colors=c)
        mt = ttm.TriangleMesh.from_triangle_soup(torch.from_numpy(soup), torch.from_numpy(mask),
                                                 colors=None if c is None else torch.from_numpy(c))
        _mesh_eq(mt, mj, atol=0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_matches_reference(seed):
    mj, mt = _pair(seed)
    # merge some vertices: copy a few positions over others
    v = np.asarray(mj.vertices).copy()
    v[5], v[9], v[17] = v[3], v[3], v[11]
    mj = dataclasses.replace(mj, vertices=jnp.asarray(v))
    mt = dataclasses.replace(mt, vertices=torch.from_numpy(v))
    for decimals in (6, 1):
        vj, tj = mj.compact(decimals)
        vt, tt = mt.compact(decimals)
        assert vt.dtype == vj.dtype and tt.dtype == tj.dtype
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(tt, tj)
    soup = jtm.TriangleMesh.from_triangle_soup(
        jnp.asarray([[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 0, 0], [1, 1, 0], [0, 1, 0]]],
                    jnp.float32), jnp.ones((2,), bool))
    vt, tt = convert.triangle_mesh_from_numpy(_to_numpy(soup), device="cpu").compact()
    assert vt.shape == (4, 3) and tt.shape == (2, 3)  # 6 soup vertices -> 4 unique


def _to_numpy(mj) -> dict:
    out = {f: np.asarray(getattr(mj, f)) for f in convert.MESH_FIELDS}
    out["vertex_attrs"] = {k: np.asarray(v) for k, v in mj.vertex_attrs.items()}
    out["triangle_attrs"] = {k: np.asarray(v) for k, v in mj.triangle_attrs.items()}
    return out


def test_convert_round_trip():
    mj, _ = _pair(4)
    mj = mj.compute_triangle_normals()
    arrays = _to_numpy(mj)
    mt = convert.triangle_mesh_from_numpy(arrays, device="cpu")
    _mesh_eq(mt, mj, atol=0.0)
    back = convert.triangle_mesh_to_numpy(mt)
    for f in convert.MESH_FIELDS:
        assert back[f].dtype == arrays[f].dtype and np.array_equal(back[f], arrays[f]), f
    for group in ("vertex_attrs", "triangle_attrs"):
        assert back[group].keys() == arrays[group].keys()
        for k in arrays[group]:
            assert np.array_equal(back[group][k], arrays[group][k]), (group, k)


@pytest.mark.parametrize("kind", ["bvh", "voxel_grid", "octree"])
def test_convert_round_trip_spatial(kind):
    """A BVH, a VoxelGrid and an Octree the JAX package built, carried
    across through numpy and back, answer queries as the JAX package's do."""
    from open3d_tpu.geometry import bvh as jbvh
    from open3d_tpu.geometry import voxelgrid as jvg
    from open3d_tpu_torch.geometry import bvh as tbvh

    rng = np.random.default_rng(7)
    q = rng.uniform(-1.2, 1.2, (200, 3)).astype(np.float32)
    if kind == "bvh":
        mj, _ = _pair(4)
        jb = jbvh.build_bvh(mj.vertices, mj.triangles, mj.triangle_mask)
        arrays = {f: np.asarray(getattr(jb, f)) for f in jb._fields}
        tb = convert.bvh_from_numpy(arrays, device="cpu")
        back = convert.bvh_to_numpy(tb)
        d = rng.normal(0, 1, (200, 3)).astype(np.float32)
        jt, ji, _ = jbvh.cast_rays(jb, jnp.asarray(q), jnp.asarray(d))
        tt, ti, _ = tbvh.cast_rays(tb, torch.from_numpy(q), torch.from_numpy(d))
        np.testing.assert_array_equal(tt.numpy() < 1e30, np.asarray(jt) < 1e30)
        _close(np.where(tt.numpy() < 1e30, tt.numpy(), 0), np.where(np.asarray(jt) < 1e30, jt, 0))
        _, _, jd = jbvh.closest_points(jb, jnp.asarray(q))
        _close(tbvh.closest_points(tb, torch.from_numpy(q))[2].numpy(), jd)
    elif kind == "voxel_grid":
        jg = jvg.create_from_point_cloud(jnp.asarray(q), 0.2, colors=jnp.asarray(np.abs(q)))
        arrays = {f: np.asarray(getattr(jg, f)) for f in convert.VOXEL_GRID_FIELDS}
        arrays["voxel_size"] = jg.voxel_size
        tg = convert.voxel_grid_from_numpy(arrays, device="cpu")
        back = convert.voxel_grid_to_numpy(tg)
        probe = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
        np.testing.assert_array_equal(tg.check_if_included(torch.from_numpy(probe)).numpy(),
                                      np.asarray(jg.check_if_included(jnp.asarray(probe))))
        _close(tg.get_voxel_centers().numpy(), jg.get_voxel_centers())
    else:
        jo_ = jvg.octree_from_point_cloud(jnp.asarray(q), max_depth=5)
        arrays = {"point_codes": np.asarray(jo_.point_codes),
                  "point_order": np.asarray(jo_.point_order),
                  "level_codes": [np.asarray(c) for c in jo_.level_codes],
                  "level_counts": [np.asarray(c) for c in jo_.level_counts],
                  "origin": np.asarray(jo_.origin), "size": jo_.size, "max_depth": jo_.max_depth}
        to_ = convert.octree_from_numpy(arrays, device="cpu")
        back = convert.octree_to_numpy(to_)
        arrays["level_codes"] = np.stack(arrays["level_codes"])
        arrays["level_counts"] = np.stack(arrays["level_counts"])
        probe = np.concatenate([q, rng.uniform(-2, 2, (100, 3))]).astype(np.float32)
        np.testing.assert_array_equal(to_.locate_leaf(torch.from_numpy(probe)).numpy(),
                                      np.asarray(jo_.locate_leaf(jnp.asarray(probe))))
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert np.array_equal(np.asarray(back[k]), np.asarray(v)), k


def _unit_quad():
    """Two triangles covering the unit square in z = 0."""
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    t = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return ttm.TriangleMesh.create(v, t, device="cpu")


def test_sample_points_uniformly():
    """The JAX package's bars (tests/test_trianglemesh.py): on the quad,
    mean near its centre; masked triangles are never drawn; a generator
    makes the draw repeatable."""
    mesh = _unit_quad()
    pcd = mesh.sample_points_uniformly(2000, key=torch.Generator().manual_seed(1))
    p = pcd.positions.numpy()
    assert p.shape == (2000, 3) and bool(pcd.mask.all())
    assert np.all(p[:, :2] >= -1e-6) and np.all(p[:, :2] <= 1 + 1e-6)
    assert np.allclose(p[:, 2], 0.0, atol=1e-6)
    assert np.allclose(p[:, :2].mean(0), 0.5, atol=0.05)
    again = mesh.sample_points_uniformly(2000, key=torch.Generator().manual_seed(1))
    assert torch.equal(again.positions, pcd.positions)
    half = dataclasses.replace(mesh, triangle_mask=torch.tensor([True, False]))
    q = half.sample_points_uniformly(500).positions.numpy()
    assert np.all(q[:, 0] >= q[:, 1] - 1e-6)  # triangle 0 lies under the diagonal


def test_sample_points_poisson_disk():
    mesh = _unit_quad()
    pcd = mesh.sample_points_poisson_disk(64, key=torch.Generator().manual_seed(2))
    p = pcd.positions.numpy()[pcd.mask.numpy()]
    assert p.shape == (64, 3) and np.allclose(p[:, 2], 0.0, atol=1e-6)
    d = np.linalg.norm(p[:, None] - p[None], axis=-1) + np.eye(64) * 9
    u = mesh.sample_points_uniformly(64, key=torch.Generator().manual_seed(2)).positions.numpy()
    du = np.linalg.norm(u[:, None] - u[None], axis=-1) + np.eye(64) * 9
    assert d.min() > 2 * du.min()  # blue noise: well spread against a uniform draw


def test_metrics_point_cloud_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    b = (a[:250] + rng.normal(0, 0.01, (250, 3))).astype(np.float32)
    ma, mb = rng.uniform(size=300) > 0.1, rng.uniform(size=250) > 0.1
    rj = jtm.compute_metrics_point_cloud(JPointCloud.create(a, mask=ma),
                                         JPointCloud.create(b, mask=mb), fscore_radius=0.02)
    rt = ttm.compute_metrics_point_cloud(TPointCloud.create(a, mask=ma, device="cpu"),
                                         TPointCloud.create(b, mask=mb, device="cpu"),
                                         fscore_radius=0.02)
    for x, y in zip(rt, rj):
        _close(x, y)
    assert 0.0 < float(rt.fscore) < 1.0


def test_metrics_mesh():
    """The JAX package's bars: identical meshes score near 0 chamfer and
    F-score 1; a 0.5 offset shows."""
    a = _unit_quad()
    m = ttm.compute_metrics_mesh(a, a, n_samples=2000, fscore_radius=0.05)
    assert float(m.chamfer_distance) < 0.05 and float(m.fscore) > 0.99
    shift = torch.eye(4)
    shift[2, 3] = 0.5
    m = ttm.compute_metrics_mesh(a, a.transform(shift), n_samples=2000, fscore_radius=0.05)
    assert float(m.chamfer_distance) > 0.8 and float(m.fscore) < 0.01


@pytest.mark.parametrize("ext", [".ply", ".obj"])
def test_mesh_files_match_reference(ext, tmp_path):
    """The same mesh written by both packages: the same bytes; each
    package reads either file to the same arrays."""
    mj, mt = _pair(6)
    a, b = str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}")
    jio.write_triangle_mesh(a, mj)
    tio.write_triangle_mesh(b, mt)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    rj = jio.read_triangle_mesh(b)
    rt = tio.read_triangle_mesh(a, device="cpu")
    assert int(rt.num_triangles()) > 10
    _mesh_eq(rt, rj, atol=0.0)


def test_mesh_ply_reads_colours_and_normals(tmp_path):
    from open3d_tpu_torch.io import ply

    rng = np.random.default_rng(8)
    v = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    n = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    c = rng.uniform(0, 1, (6, 3)).astype(np.float32)
    path = str(tmp_path / "m.ply")
    ply.write_ply(path, v, normals=n, colors=c, triangles=np.array([[0, 1, 2], [3, 4, 5]]))
    _mesh_eq(tio.read_triangle_mesh(path, device="cpu"), jio.read_triangle_mesh(path), atol=0.0)


@pytest.mark.parametrize("ext", [".stl", ".off", ".gltf", ".glb"])
def test_queued_mesh_formats_raise(ext, tmp_path):
    """The formats once queued write the JAX package's bytes and read in
    either package; a file not of its format and an unknown extension
    raise ValueError."""
    mj, mt = _pair(7)
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    tio.write_triangle_mesh(a, mt)
    jio.write_triangle_mesh(b, mj)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    vt, tt = tio.read_triangle_mesh(a, device="cpu").compact()
    if ext == ".gltf":  # both write GLB there, which the JAX package reads only as .glb
        a = str(tmp_path / "port_as.glb")
        tio.write_triangle_mesh(a, mt)
    vj, tj = jio.read_triangle_mesh(a).compact()
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(vt, vj)
    bad = tmp_path / f"bad{ext}"
    bad.write_bytes(b"solid x" if ext == ".stl" else b"{}" if ext == ".gltf" else b"nothing")
    with pytest.raises(ValueError):
        tio.read_triangle_mesh(str(bad), device="cpu")
    with pytest.raises(ValueError):
        tio.read_triangle_mesh(str(tmp_path / "m.xyz"), device="cpu")


def _poses(rng, n=6):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 1.0, (n, 3))).as_matrix()
    T[:, :3, 3] = rng.uniform(-2, 2, (n, 3))
    # a rotation of pi about x exercises the quaternion's w ~ 0 branch
    T[0, :3, :3] = np.diag([1.0, -1.0, -1.0])
    return T.astype(np.float32)


def test_trajectory_log_matches_reference(tmp_path):
    P = _poses(np.random.default_rng(9))
    a, b = str(tmp_path / "jax.log"), str(tmp_path / "port.log")
    jtraj.write_trajectory_log(a, P)
    ttraj.write_trajectory_log(b, P)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = tio.read_trajectory_log(a)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, jtraj.read_trajectory_log(b))
    _close(back, P, 1e-7)


def test_trajectory_tum_matches_reference(tmp_path):
    P = _poses(np.random.default_rng(10))
    ts = np.arange(6) * 0.033 + 100.0
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jtraj.write_trajectory_tum(a, P, ts)
    ttraj.write_trajectory_tum(b, P, ts)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    tt, pt = tio.read_trajectory_tum(a)
    tj, pj = jtraj.read_trajectory_tum(b)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(pt, pj)
    _close(pt, P, 1e-5)


def test_sphere_extraction():
    """tests/test_trianglemesh.py's sphere case on the port: integrate a
    synthetic scan, extract, and hold the mesh's samples to the TSDF's zero
    crossing (the grid's point cloud)."""
    intr = TIntr(160, 120, 131.25, 131.25, 79.5, 59.5)
    depths, colors, extrinsics, _ = tsyn.render_sequence(6, intrinsic=intr, span=0.6,
                                                         device="cpu")
    vbg = tvbg.create(voxel_size=0.02, block_resolution=8, block_count=4096, with_color=True,
                      device="cpu")
    for i in range(6):
        keys, _ = tvbg.compute_unique_block_coordinates(
            vbg, depths[i], intr, extrinsics[i], depth_max=4.0, frame_block_capacity=2048)
        vbg = tvbg.integrate(vbg, keys, depths[i], colors[i], intr, extrinsics[i], depth_max=4.0)

    mesh = tvbg.extract_triangle_mesh(vbg, triangle_capacity=262144, weight_threshold=2.0)
    assert int(mesh.num_triangles()) > 1000
    pcd = tvbg.extract_point_cloud(vbg, point_capacity=131072, weight_threshold=2.0)
    samples = mesh.sample_points_uniformly(5000, key=torch.Generator().manual_seed(0))
    m = ttm.compute_metrics_point_cloud(samples, pcd, fscore_radius=0.03)
    assert float(m.chamfer_distance) < 0.05
    assert float(m.fscore) > 0.9
    # triangle ids reference live vertices
    tris = mesh.triangles[mesh.triangle_mask]
    assert int(tris.min()) >= 0 and int(tris.max()) < int(mesh.num_vertices())
