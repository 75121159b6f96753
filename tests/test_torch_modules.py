"""Port parity: the public names of the begun modules that the earlier
slices left out (hashmap erase / active_slots / resize; eigh3x3 and
solve3x3; the masked reductions and padding; the rgbd unprojection and
splat; the PointCloud transforms, bounds and selection; the Sobel,
colourise, linear and dilate image ops; the camera records; sample_surface;
the grid, pose-graph and triangle-mesh files), one parametrised case a name, against
open3d_tpu on the same seeded numpy inputs.

Bars: integer results (hash tables, slots, counts, index maps, masks) and
pure data moves equal; float32 results within 1e-5 (1e-4 for eigenvectors,
whose cross products round differently near a repeated eigenvalue), both
packages rounding the same formulas. sample_surface draws from a torch
generator, not JAX's stream, so its points are held to |sdf| < 1e-3 and
to the JAX package's share of valid points within 0.05. Files written by
either package read back equal in the other.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_tpu import io as jio
from open3d_tpu.core import hashmap as jhm
from open3d_tpu.core import lie as jlie
from open3d_tpu.core import linalg as jlinalg
from open3d_tpu.core import masking as jmasking
from open3d_tpu.data import synthetic as jsyn
from open3d_tpu.geometry import camera as jcam
from open3d_tpu.geometry import image as jimage
from open3d_tpu.geometry import rgbd as jrgbd
from open3d_tpu.geometry import voxel_block_grid as jvbg
from open3d_tpu.geometry.pointcloud import PointCloud as JPointCloud
from open3d_tpu.pipelines import pose_graph as jpg
from open3d_tpu_torch import convert
from open3d_tpu_torch import io as tio
from open3d_tpu_torch.core import hashmap as thm
from open3d_tpu_torch.core import linalg as tlinalg
from open3d_tpu_torch.core import masking as tmasking
from open3d_tpu_torch.data import synthetic as tsyn
from open3d_tpu_torch.geometry import camera as tcam
from open3d_tpu_torch.geometry import image as timage
from open3d_tpu_torch.geometry import rgbd as trgbd
from open3d_tpu_torch.geometry.pointcloud import PointCloud as TPointCloud

torch.set_num_threads(2)
ATOL = 1e-5
INTR = (80, 64, 65.6, 65.6, 39.5, 31.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               atol=atol, rtol=0)


CASES = {}


def case(name):
    def register(fn):
        CASES[name] = fn
        return fn
    return register


# ---- core/hashmap.py ---------------------------------------------------------


def _tables(rng):
    """The same 1024-slot table in both packages: 300 unique random blocks
    activated; then 150 of them and 20 absent keys to erase."""
    coords = np.unique(rng.integers(-40, 40, (400, 3)), axis=0)[:300].astype(np.int32)
    rng.shuffle(coords)
    keys = np.asarray(jhm.pack_coords(jnp.asarray(coords)))
    tj, _, okj = jhm.activate(jhm.make_table(1024), jnp.asarray(keys))
    tt, _, okt = thm.activate(thm.make_table(1024, device="cpu"), _t(keys))
    _eq(tt, tj)
    assert bool(okt.all())
    absent = np.asarray(jhm.pack_coords(jnp.asarray(rng.integers(100, 200, (20, 3)).astype(np.int32))))
    gone = np.concatenate([keys[:150], absent])
    rng.shuffle(gone)
    return tt, tj, gone


@case("hashmap.erase")
def _(rng):
    tt, tj, gone = _tables(rng)
    et, ft = thm.erase(tt, _t(gone))
    ej, fj = jhm.erase(tj, jnp.asarray(gone))
    _eq(et, ej)
    _eq(ft, fj)
    assert int(ft.sum()) == 150 and int((et[:, 1] == 2).sum()) == 150  # tombstones
    # the surviving keys are still found through the tombstones
    live = et[thm.occupied_mask(et)]
    assert bool(thm.find(et, live)[1].all())


@case("hashmap.active_slots")
def _(rng):
    tt, tj, gone = _tables(rng)
    tt, _ = thm.erase(tt, _t(gone))
    tj, _ = jhm.erase(tj, jnp.asarray(gone))
    for capacity in (1024, 200, 64):  # room to spare, and fewer slots than keys
        st, ct = thm.active_slots(tt, capacity)
        sj, cj = jhm.active_slots(tj, capacity)
        _eq(st, sj)
        assert int(ct) == int(cj) == min(150, capacity)


@case("hashmap.resize")
def _(rng):
    tt, tj, gone = _tables(rng)
    tt, _ = thm.erase(tt, _t(gone))
    tj, _ = jhm.erase(tj, jnp.asarray(gone))
    for capacity in (2048, 256, 151):  # larger, smaller, and too tight for every key
        out_t = thm.resize(tt, capacity)
        out_j = jhm.resize(tj, capacity)
        for a, b in zip(out_t, out_j):
            _eq(a, b)
        assert out_t[0].device == tt.device and int(out_t[3]) == 150
        placed = int((out_t[2][:150] >= 0).sum())
        assert placed == 150 if capacity > 151 else 0 < placed <= 150


# ---- core/linalg.py ----------------------------------------------------------


@case("linalg.eigh3x3")
def _(rng):
    M = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = M @ np.swapaxes(M, -1, -2)
    A[0] = 2.0 * np.eye(3)  # isotropic: the identity basis
    A[1] = np.diag([1.0, 1.0, 3.0])  # a repeated eigenvalue
    A[2] = np.diag([1e-6, 1.0, 1.0])  # a planar covariance (normal estimation)
    wt, vt = tlinalg.eigh3x3(_t(A))
    wj, vj = jlinalg.eigh3x3(jnp.asarray(A))
    _close(wt, wj)
    _close(vt, vj, atol=1e-4)
    # V diag(w) V^T rebuilds A where the spectrum is simple (an exactly
    # repeated eigenvalue leaves the closed form's basis to rounding, in
    # both packages alike)
    v, w = vt.numpy()[3:], wt.numpy()[3:]
    _close(v @ (w[..., None] * np.swapaxes(v, -1, -2)), A[3:], atol=1e-4 * np.abs(A).max())


@case("linalg.solve3x3")
def _(rng):
    A = rng.normal(size=(128, 3, 3)).astype(np.float32) + 3.0 * np.eye(3, dtype=np.float32)
    A[0] = 0.0  # singular: x = 0
    b = rng.normal(size=(128, 3)).astype(np.float32)
    xt = tlinalg.solve3x3(_t(A), _t(b))
    xj = jlinalg.solve3x3(jnp.asarray(A), jnp.asarray(b))
    _close(xt, xj)
    assert float(xt[0].abs().max()) == 0.0


# ---- core/masking.py ---------------------------------------------------------


def _masked(rng):
    x = rng.normal(size=(50, 3)).astype(np.float32)
    m = rng.random(50) < 0.4
    return x, m


@case("masking.masked_mean")
def _(rng):
    x, m = _masked(rng)
    _close(tmasking.masked_mean(_t(x), _t(m)), jmasking.masked_mean(jnp.asarray(x), jnp.asarray(m)))
    _close(tmasking.masked_mean(_t(x), _t(m), keepdims=True),
           jmasking.masked_mean(jnp.asarray(x), jnp.asarray(m), keepdims=True))
    _close(tmasking.masked_mean(_t(x), torch.zeros(50, dtype=torch.bool)), np.zeros(3))


@case("masking.masked_min")
def _(rng):
    x, m = _masked(rng)
    _eq(tmasking.masked_min(_t(x), _t(m)), jmasking.masked_min(jnp.asarray(x), jnp.asarray(m)))
    _eq(tmasking.masked_min(_t(x), _t(m), axis=1, big=9.0),
        jmasking.masked_min(jnp.asarray(x), jnp.asarray(m), axis=1, big=9.0))


@case("masking.masked_max")
def _(rng):
    x, m = _masked(rng)
    _eq(tmasking.masked_max(_t(x), _t(m)), jmasking.masked_max(jnp.asarray(x), jnp.asarray(m)))
    none = np.zeros(50, bool)
    _eq(tmasking.masked_max(_t(x), _t(none)), jmasking.masked_max(jnp.asarray(x), jnp.asarray(none)))


@case("masking.pad_axis0")
def _(rng):
    x = rng.normal(size=(7, 2)).astype(np.float32)
    for capacity in (7, 12, 4):
        pt = tmasking.pad_axis0(_t(x), capacity, -1.0)
        _eq(pt, jmasking.pad_axis0(jnp.asarray(x), capacity, -1.0))
        assert pt.dtype == torch.float32


@case("masking.round_up")
def _(rng):
    for x, m in [(0, 8), (1, 8), (8, 8), (9, 8), (1000, 128), (4097, 4096)]:
        assert tmasking.round_up(x, m) == jmasking.round_up(x, m)


# ---- geometry/rgbd.py --------------------------------------------------------


@pytest.fixture(scope="module")
def frame():
    d, c, e, _ = jsyn.render_sequence(2, intrinsic=jcam.PinholeCameraIntrinsic(*INTR), span=0.2)
    return np.asarray(d[1]), np.asarray(c[1]), np.asarray(e[1])


def _cloud_pair(cj, ct, atol=ATOL):
    _eq(ct.mask, cj.mask)
    _close(ct.positions, cj.positions, atol)
    assert ct.attrs.keys() == cj.attrs.keys()
    for k in ct.attrs:
        _close(ct.attrs[k], cj.attrs[k], atol)


@case("rgbd.pointcloud_from_depth")
def _(rng, frame):
    d, c, e = frame
    for stride, E, col in ((1, e, None), (2, e, c), (1, None, c)):
        ct = trgbd.pointcloud_from_depth(_t(d), tcam.PinholeCameraIntrinsic(*INTR),
                                         None if E is None else _t(E), stride,
                                         None if col is None else _t(col))
        cj = jrgbd.pointcloud_from_depth(jnp.asarray(d), jcam.PinholeCameraIntrinsic(*INTR),
                                         None if E is None else jnp.asarray(E), stride,
                                         None if col is None else jnp.asarray(col))
        _cloud_pair(cj, ct)


@case("rgbd.pointcloud_from_rgbd")
def _(rng, frame):
    d, c, e = frame
    ct = trgbd.pointcloud_from_rgbd(trgbd.RGBDImage(_t(c), _t(d)), tcam.PinholeCameraIntrinsic(*INTR),
                                    _t(e), 2)
    cj = jrgbd.pointcloud_from_rgbd(jrgbd.RGBDImage(jnp.asarray(c), jnp.asarray(d)),
                                    jcam.PinholeCameraIntrinsic(*INTR), jnp.asarray(e), 2)
    _cloud_pair(cj, ct)
    assert int(ct.count()) > 0.8 * ct.capacity


@case("rgbd.project_to_rgbd")
def _(rng, frame):
    """A world cloud splatted back through the frame's pose gives back its
    depth and colour, in both packages alike."""
    d, c, e = frame
    cj = jrgbd.pointcloud_from_depth(jnp.asarray(d), jcam.PinholeCameraIntrinsic(*INTR),
                                     jnp.asarray(e), 1, jnp.asarray(c))
    ct = trgbd.pointcloud_from_depth(_t(d), tcam.PinholeCameraIntrinsic(*INTR), _t(e), 1, _t(c))
    for cloud_j, cloud_t in ((cj, ct), (cj.with_attrs(colors=None), ct.with_attrs(colors=None))):
        rj = jrgbd.project_to_rgbd(cloud_j, jcam.PinholeCameraIntrinsic(*INTR), jnp.asarray(e))
        rt = trgbd.project_to_rgbd(cloud_t, tcam.PinholeCameraIntrinsic(*INTR), _t(e), depth_max=10.0)
        _close(rt.depth, rj.depth)
        _close(rt.color, rj.color)
    ok = (rt.depth.numpy() > 0) & (d > 0)
    assert ok.mean() > 0.8 and np.abs(rt.depth.numpy() - d)[ok].max() < 1e-4


# ---- geometry/pointcloud.py --------------------------------------------------


def _clouds(rng):
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    col = rng.random((40, 3)).astype(np.float32)
    mask = rng.random(40) < 0.7
    kw = dict(capacity=48, mask=mask, normals=nrm, colors=col)
    return JPointCloud.create(pos, **kw), TPointCloud.create(pos, device="cpu", **kw)


def _pose(rng):
    xi = rng.normal(size=6).astype(np.float32) * 0.5
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


@case("pointcloud.transform")
def _(rng):
    cj, ct = _clouds(rng)
    T = _pose(rng)
    _cloud_pair(cj.transform(jnp.asarray(T)), ct.transform(_t(T)))


@case("pointcloud.translate")
def _(rng):
    cj, ct = _clouds(rng)
    for relative in (True, False):
        _cloud_pair(cj.translate([0.5, -1.0, 2.0], relative), ct.translate([0.5, -1.0, 2.0], relative))


@case("pointcloud.rotate")
def _(rng):
    cj, ct = _clouds(rng)
    R = _pose(rng)[:3, :3]
    _cloud_pair(cj.rotate(jnp.asarray(R), [0.1, 0.2, 0.3]), ct.rotate(_t(R), [0.1, 0.2, 0.3]))


@case("pointcloud.scale")
def _(rng):
    cj, ct = _clouds(rng)
    _cloud_pair(cj.scale(1.7, [1.0, 0.0, -1.0]), ct.scale(1.7, [1.0, 0.0, -1.0]))


@case("pointcloud.get_min_bound")
def _(rng):
    cj, ct = _clouds(rng)
    _eq(ct.get_min_bound(), cj.get_min_bound())


@case("pointcloud.get_max_bound")
def _(rng):
    cj, ct = _clouds(rng)
    _eq(ct.get_max_bound(), cj.get_max_bound())


@case("pointcloud.get_center")
def _(rng):
    cj, ct = _clouds(rng)
    _close(ct.get_center(), cj.get_center())


@case("pointcloud.select_by_mask")
def _(rng):
    cj, ct = _clouds(rng)
    keep = rng.random(48) < 0.5
    _cloud_pair(cj.select_by_mask(jnp.asarray(keep)), ct.select_by_mask(_t(keep)))


@case("pointcloud.crop")
def _(rng):
    cj, ct = _clouds(rng)
    lo, hi = [-0.5, -1.0, -0.5], [1.0, 0.5, 1.5]
    _cloud_pair(cj.crop(lo, hi), ct.crop(lo, hi))
    assert 0 < int(ct.crop(lo, hi).count()) < int(ct.count())


# ---- geometry/image.py -------------------------------------------------------


@case("image.filter_sobel")
def _(rng):
    img = rng.random((24, 32)).astype(np.float32)
    for a, b in zip(timage.filter_sobel(_t(img)), jimage.filter_sobel(jnp.asarray(img))):
        _close(a, b)


@case("image.colorize_depth")
def _(rng, frame):
    d = frame[0] * 1000.0
    _close(timage.colorize_depth(_t(d), 1000.0, 0.5, 4.0),
           jimage.colorize_depth(jnp.asarray(d), 1000.0, 0.5, 4.0))
    _close(timage.colorize_depth(_t(frame[0])), jimage.colorize_depth(jnp.asarray(frame[0])))


@case("image.linear_transform")
def _(rng):
    img = rng.random((8, 10, 3)).astype(np.float32)
    _close(timage.linear_transform(_t(img), 2.5, -0.25),
           jimage.linear_transform(jnp.asarray(img), 2.5, -0.25))


@case("image.dilate")
def _(rng):
    for shape, k in (((24, 32), 3), ((12, 16, 3), 5)):
        img = rng.normal(size=shape).astype(np.float32)
        _eq(timage.dilate(_t(img), k), jimage.dilate(jnp.asarray(img), k))


# ---- geometry/camera.py ------------------------------------------------------


@case("camera.PinholeCameraIntrinsic.from_matrix")
def _(rng):
    K = np.array([[525.0, 0, 319.5], [0, 520.0, 239.5], [0, 0, 1]], np.float32)
    ref = jcam.PinholeCameraIntrinsic.from_matrix(640, 480, K)
    for arg in (K, _t(K), K.tolist()):
        got = tcam.PinholeCameraIntrinsic.from_matrix(640, 480, arg)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)


@case("camera.PinholeCameraParameters")
def _(rng):
    intr = tcam.PinholeCameraIntrinsic(*INTR)
    E = _t(_pose(rng))
    p = tcam.PinholeCameraParameters(intrinsic=intr, extrinsic=E)
    assert [f.name for f in dataclasses.fields(p)] == [
        f.name for f in dataclasses.fields(jcam.PinholeCameraParameters)]
    assert p.intrinsic == intr and torch.equal(p.extrinsic, E)


@case("camera.PinholeCameraTrajectory")
def _(rng):
    intr = tcam.PinholeCameraIntrinsic(*INTR)
    traj = tcam.PinholeCameraTrajectory(
        [tcam.PinholeCameraParameters(intr, _t(_pose(rng))) for _ in range(3)])
    assert [f.name for f in dataclasses.fields(traj)] == [
        f.name for f in dataclasses.fields(jcam.PinholeCameraTrajectory)]
    assert len(traj.parameters) == 3


# ---- data/synthetic.py -------------------------------------------------------


@case("synthetic.sample_surface")
def _(rng):
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    pc = tsyn.sample_surface(tsyn.default_scene_sdf, gen, 2048, with_colors=True, capacity=2100)
    ref = jsyn.sample_surface(jsyn.default_scene_sdf, jax.random.PRNGKey(0), 2048)
    assert pc.capacity == 2100 and pc.has("normals") and pc.has("colors")
    pts = pc.positions[pc.mask]
    n = int(pc.count())
    assert float(tsyn.default_scene_sdf(pts).abs().max()) < 1e-3
    assert abs(n / 2048 - int(ref.count()) / 2048) < 0.05 and n > 1024
    _close(pc.normals[pc.mask], tsyn.sdf_normal(tsyn.default_scene_sdf, pts))
    _close(pc.colors[pc.mask], tsyn.scene_color(pts))
    # the same generator state gives the same points
    again = tsyn.sample_surface(tsyn.default_scene_sdf, gen.manual_seed(7), 64, with_normals=False)
    same = tsyn.sample_surface(tsyn.default_scene_sdf, torch.Generator().manual_seed(7), 64,
                               with_normals=False)
    assert torch.equal(again.positions, same.positions) and not again.has("normals")


# ---- io/__init__.py ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_grid(with_color):
    """A small JAX grid with two fused frames (made once; both file cases
    read it)."""
    ji = jcam.PinholeCameraIntrinsic(*INTR)
    d, c, e, _ = jsyn.render_sequence(2, intrinsic=ji, span=0.1)
    g = jvbg.create(voxel_size=0.05, block_resolution=8, block_count=256, with_color=with_color)
    for i in range(2):
        keys, _ = jvbg.compute_unique_block_coordinates(g, d[i], ji, e[i], frame_block_capacity=256)
        g = jvbg.integrate(g, keys, d[i], c[i] if with_color else None, ji, e[i])
    return g


@case("io.read_voxel_block_grid")
def _(rng, tmp_path):
    """A checkpoint the JAX package wrote reads here with the same arrays."""
    for with_color in (True, False):
        gj = _jax_grid(with_color)
        path = str(tmp_path / f"jax_{with_color}.npz")
        jio.write_voxel_block_grid(path, gj)
        gt = tio.read_voxel_block_grid(path, device="cpu")
        _eq(gt.table, gj.table)
        _eq(gt.tw, gj.tw)
        assert gt.has_color == with_color and int((gt.tw.view(-1) & 0xFFFF).sum()) > 0
        if with_color:
            _eq(gt.color, gj.color)
        assert (gt.voxel_size, gt.block_resolution, gt.sdf_trunc) == (
            gj.voxel_size, gj.block_resolution, gj.sdf_trunc)


@case("io.write_voxel_block_grid")
def _(rng, tmp_path):
    """A checkpoint the port wrote reads in the JAX package, and here."""
    for with_color in (True, False):
        gj = _jax_grid(with_color)
        gt = convert.vbg_from_numpy(np.asarray(gj.table), np.asarray(gj.tw), np.asarray(gj.color),
                                    gj.voxel_size, 8, gj.sdf_trunc, device="cpu")
        path = str(tmp_path / f"port_{with_color}.npz")
        tio.write_voxel_block_grid(path, gt)
        back = jio.read_voxel_block_grid(path)
        _eq(back.table, gj.table)
        _eq(back.tw, gj.tw)
        _eq(back.color, gj.color)
        again = tio.read_voxel_block_grid(path, device="cpu")
        assert torch.equal(again.tw, gt.tw) and again.has_color == with_color


def _meshes(rng):
    """The same random mesh in both packages (60 triangles over 40
    vertices, a few of each masked out), with vertex colours."""
    from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
    from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh as TMesh

    v = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    t = np.stack([rng.choice(40, 3, replace=False) for _ in range(60)]).astype(np.int32)
    kw = dict(vertex_mask=rng.uniform(size=40) > 0.1, triangle_mask=rng.uniform(size=60) > 0.2,
              vertex_attrs={"colors": rng.uniform(0, 1, (40, 3)).astype(np.float32)})
    return JMesh.create(v, t, **kw), TMesh.create(v, t, device="cpu", **kw)


def _mesh_files_eq(mt, mj):
    for f in ("vertices", "triangles", "vertex_mask", "triangle_mask"):
        _eq(getattr(mt, f), getattr(mj, f))
    assert mt.vertex_attrs.keys() == mj.vertex_attrs.keys()


@case("io.read_triangle_mesh")
def _(rng, tmp_path):
    """Meshes the JAX package wrote (.ply, .obj) read here as there."""
    mj, _ = _meshes(rng)
    for ext in (".ply", ".obj"):
        path = str(tmp_path / f"jax{ext}")
        jio.write_triangle_mesh(path, mj)
        _mesh_files_eq(tio.read_triangle_mesh(path, device="cpu"), jio.read_triangle_mesh(path))


@case("io.write_triangle_mesh")
def _(rng, tmp_path):
    """Meshes the port wrote equal the JAX package's files byte for byte."""
    mj, mt = _meshes(rng)
    for ext in (".ply", ".obj"):
        a, b = str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}")
        jio.write_triangle_mesh(a, mj)
        tio.write_triangle_mesh(b, mt)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _graphs(rng):
    n = 5
    poses = np.stack([_pose(rng) for _ in range(n)])
    edges = np.array([[i, i + 1] for i in range(n - 1)] + [[0, 3]], np.int32)
    X = np.stack([_pose(rng) for _ in range(len(edges))])
    info = np.tile(np.eye(6, dtype=np.float32), (len(edges), 1, 1)) * 2.0
    unc = np.array([False] * (n - 1) + [True])
    return jpg.PoseGraph.create(poses, edges, X, informations=info, uncertain=unc)


def _graph_eq(gt, gj):
    for f in convert.POSE_GRAPH_FIELDS:
        _close(getattr(gt, f), getattr(gj, f), atol=0.0)


@case("io.read_pose_graph")
def _(rng, tmp_path):
    gj = _graphs(rng)
    path = str(tmp_path / "jax.json")
    jio.write_pose_graph(path, gj)
    _graph_eq(tio.read_pose_graph(path, device="cpu"), gj)


@case("io.write_pose_graph")
def _(rng, tmp_path):
    gj = _graphs(rng)
    gt = convert.pose_graph_from_numpy({f: np.asarray(getattr(gj, f))
                                        for f in convert.POSE_GRAPH_FIELDS}, device="cpu")
    path = str(tmp_path / "port.json")
    tio.write_pose_graph(path, gt)
    _graph_eq(gt, jio.read_pose_graph(path))
    ref = str(tmp_path / "jax.json")
    jio.write_pose_graph(ref, gj)
    with open(path) as a, open(ref) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_name_matches_reference(name, frame, tmp_path):
    import inspect

    fn = CASES[name]
    kw = {"frame": frame, "tmp_path": tmp_path}
    fn(np.random.default_rng(sum(map(ord, name))),  # a seed of its own for each name
       **{k: kw[k] for k in inspect.signature(fn).parameters if k in kw})
