"""Port parity for geometry/bvh.py and geometry/raycasting.py: the same
seeded numpy inputs through open3d_tpu and open3d_tpu_torch, and each
assertion of tests/test_bvh.py and tests/test_raycasting.py on the port.

Bars: Morton codes and the BVH's leaf order exact, its boxes and leaf
triangles within 1e-6; hit masks and intersection counts equal; t within
1e-5 relative; primitive ids equal except at a tie (a ray through a shared
edge, a closest point on a shared edge or corner, or two triangles at
the same distance), where the two t (or distances) agree within 1e-6
relative; uv within 1e-4, and the closest points within 1e-5, where the
ids agree; distances within 1e-5; occupancy equal; rays within 1e-6. A small
`max_steps` truncates both traversals at the same step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_bvh as ref_bvh
import test_mesh_toolbox as ref_toolbox
import test_raycasting as ref_rc
from open3d_tpu.geometry import bvh as jbvh
from open3d_tpu.geometry import raycasting as jrc
from open3d_tpu.geometry.camera import PinholeCameraIntrinsic as JIntr
from open3d_tpu_torch.geometry import bvh as tbvh
from open3d_tpu_torch.geometry import raycasting as trc
from open3d_tpu_torch.geometry.camera import PinholeCameraIntrinsic as TIntr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sphere():
    return ref_bvh._sphere_mesh()


def _soup(seed=0):
    """Random triangles, every fourth one repeated exactly (equal centroids,
    so equal Morton codes that the stable sort must keep in id order), and a
    mask that drops some."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (300, 1, 3))
    tri = (c + rng.normal(0, 0.08, (300, 3, 3))).astype(np.float32)
    tri = np.concatenate([tri, tri[::4]], 0)
    v = tri.reshape(-1, 3)
    t = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    mask = rng.uniform(size=t.shape[0]) > 0.15
    return v, t, mask


def _ids_agree(ji, ti, jt, tt, rel=1e-6):
    """ids equal, or at a tie the two t within rel."""
    ji, ti, jt, tt = map(np.asarray, (ji, ti, jt, tt))
    diff = ji != ti
    assert np.all(np.abs(jt[diff] - tt[diff]) <= rel * np.maximum(np.abs(jt[diff]), 1e-12)), (
        diff.sum(), jt[diff], tt[diff])
    return int(diff.sum())


def test_morton3_exact():
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.uniform(-0.1, 1.1, (4000, 3)),
                        [[0, 0, 0], [1, 1, 1], [1023 / 1024, 0.5, 1e-9]]]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jbvh.morton3(jnp.asarray(p))),
                                  tbvh.morton3(torch.from_numpy(p)).numpy())


@pytest.mark.parametrize("which", ["sphere", "soup"])
def test_build_bvh_matches_reference(which, sphere):
    v, t, mask = (*sphere, None) if which == "sphere" else _soup()
    jb = jbvh.build_bvh(jnp.asarray(v), jnp.asarray(t),
                        None if mask is None else jnp.asarray(mask))
    tb = tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t),
                        None if mask is None else torch.from_numpy(mask))
    assert tb.n_leaves == jb.n_leaves
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    for f in ("node_min", "node_max", "v0", "e1", "e2"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 3.0]) + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.3, (n, 2)), -np.ones((n, 1))], -1).astype(np.float32)
    return o, d


@pytest.mark.parametrize("which", ["sphere", "soup"])
@pytest.mark.parametrize("max_steps", [2048, 24])
def test_cast_rays_matches_reference(which, max_steps, sphere):
    v, t, mask = (*sphere, None) if which == "sphere" else _soup()
    jb = jbvh.build_bvh(jnp.asarray(v), jnp.asarray(t),
                        None if mask is None else jnp.asarray(mask))
    tb = tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t),
                        None if mask is None else torch.from_numpy(mask))
    o, d = _rays(1, 256)
    jt, ji, juv = (np.asarray(x) for x in jbvh.cast_rays(jb, jnp.asarray(o), jnp.asarray(d),
                                                       max_steps=max_steps))
    tt, ti, tuv = (x.numpy() for x in tbvh.cast_rays(tb, torch.from_numpy(o), torch.from_numpy(d),
                                                     max_steps=max_steps))
    hit = jt < 1e30
    np.testing.assert_array_equal(tt < 1e30, hit)
    assert hit.sum() > 10
    np.testing.assert_array_equal(tt[~hit], jt[~hit])  # 3e38 on a miss
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
    _ids_agree(ji, ti, jt, tt)
    same = ji == ti
    np.testing.assert_allclose(tuv[same], juv[same], atol=1e-4)


@pytest.mark.parametrize("max_steps", [4096, 30])
def test_closest_points_matches_reference(max_steps, sphere):
    v, t = sphere
    jb = jbvh.build_bvh(jnp.asarray(v), jnp.asarray(t))
    tb = tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t))
    q = np.random.default_rng(2).uniform(-1.6, 1.6, (200, 3)).astype(np.float32)
    jp, ji, jd = (np.asarray(x) for x in jbvh.closest_points(jb, jnp.asarray(q),
                                                           max_steps=max_steps))
    tp, ti, td = (x.numpy() for x in tbvh.closest_points(tb, torch.from_numpy(q),
                                                         max_steps=max_steps))
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    _ids_agree(ji, ti, jd, td)
    np.testing.assert_allclose(tp[ji == ti], jp[ji == ti], rtol=0, atol=1e-5)


def _scenes(threshold, tile=512):
    # an icosphere: the lat-long sphere's pole slivers (edges 1e-4 against
    # 0.1) leave the closest point on them ill-conditioned
    ico = ref_toolbox._icosphere(3)
    v, t = np.array(ico.vertices), np.array(ico.triangles)
    js = jrc.RaycastingScene(tile=tile, bvh_threshold=threshold)
    ts = trc.RaycastingScene(tile=tile, bvh_threshold=threshold, device="cpu")
    for s in (js, ts):
        assert s.add_triangles(v, t) == 0
        assert s.add_triangles(0.5 * v + np.float32(2.0), t) == 1
    return js, ts


@pytest.mark.parametrize("route", ["brute_force", "bvh"])
def test_scene_queries_match_reference(route):
    js, ts = _scenes(1 << 30 if route == "brute_force" else 1)
    rng = np.random.default_rng(3)
    rays = np.concatenate([rng.uniform(-2, 3, (300, 3)), rng.normal(0, 1, (300, 3))],
                          -1).astype(np.float32).reshape(20, 15, 6)
    a, b = js.cast_rays(jnp.asarray(rays)), ts.cast_rays(torch.from_numpy(rays))
    ja, tb_ = np.asarray(a["t_hit"]), b["t_hit"].numpy()
    hit = np.isfinite(ja)
    assert tb_.shape == (20, 15) and hit.sum() > 20
    np.testing.assert_array_equal(np.isfinite(tb_), hit)
    np.testing.assert_allclose(tb_[hit], ja[hit], rtol=1e-5)
    _ids_agree(a["primitive_ids"], b["primitive_ids"].numpy(), ja, tb_)
    same = np.asarray(a["primitive_ids"]) == b["primitive_ids"].numpy()
    np.testing.assert_array_equal(b["geometry_ids"].numpy(), np.asarray(a["geometry_ids"]))
    np.testing.assert_allclose(b["primitive_normals"].numpy()[same],
                               np.asarray(a["primitive_normals"])[same], atol=1e-5)
    np.testing.assert_allclose(b["primitive_uvs"].numpy()[same],
                               np.asarray(a["primitive_uvs"])[same], atol=1e-4)
    # counts: rays of many directions (the general route) and of one (occupancy's)
    np.testing.assert_array_equal(ts.count_intersections(torch.from_numpy(rays)).numpy(),
                                  np.asarray(js.count_intersections(jnp.asarray(rays))))
    q = rng.uniform(-1.5, 3.0, (400, 3)).astype(np.float32)
    a, b = js.compute_closest_points(jnp.asarray(q)), ts.compute_closest_points(torch.from_numpy(q))
    np.testing.assert_allclose(b["distance2"].numpy(), np.asarray(a["distance2"]), atol=1e-5)
    _ids_agree(a["primitive_ids"], b["primitive_ids"].numpy(), a["distance2"],
               b["distance2"].numpy())
    same = np.asarray(a["primitive_ids"]) == b["primitive_ids"].numpy()
    np.testing.assert_allclose(b["points"].numpy()[same], np.asarray(a["points"])[same],
                               atol=1e-5)
    np.testing.assert_array_equal(b["geometry_ids"].numpy(), np.asarray(a["geometry_ids"]))
    occ = ts.compute_occupancy(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(js.compute_occupancy(jnp.asarray(q))))
    assert 10 < occ.sum() < 390
    np.testing.assert_allclose(ts.compute_signed_distance(torch.from_numpy(q)).numpy(),
                               np.asarray(js.compute_signed_distance(jnp.asarray(q))),
                               atol=1e-5)
    np.testing.assert_allclose(ts.compute_distance(torch.from_numpy(q)).numpy(),
                               np.asarray(js.compute_distance(jnp.asarray(q))), atol=1e-5)


def test_create_rays_pinhole_matches_reference():
    E = np.array([[0.96, -0.28, 0.0, 0.1], [0.28, 0.96, 0.0, -0.2], [0, 0, 1, 0.3], [0, 0, 0, 1]],
                 np.float32)
    a = jrc.create_rays_pinhole(JIntr(64, 48, 50.0, 50.0, 31.5, 23.5), jnp.asarray(E), 64, 48)
    b = trc.create_rays_pinhole(TIntr(64, 48, 50.0, 50.0, 31.5, 23.5), torch.from_numpy(E), 64, 48)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    # camera-frame z = 1: a ray's t is the depth
    cam = b[..., 3:] @ torch.from_numpy(E)[:3, :3].T
    np.testing.assert_allclose(cam[..., 2].numpy(), 1.0, atol=1e-6)


# ---- tests/test_bvh.py and tests/test_raycasting.py on the port -------------


def test_ref_bvh_matches_bruteforce(sphere):
    v, t = sphere
    rng = np.random.default_rng(0)
    origins = np.tile([[0.0, 0.0, 3.0]], (64, 1)).astype(np.float32)
    dirs = np.concatenate([rng.normal(0, 0.25, (64, 2)), -np.ones((64, 1))], -1).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tb, _, _ = tbvh.cast_rays(tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t)),
                              torch.from_numpy(origins), torch.from_numpy(dirs))
    scene = trc.RaycastingScene(bvh_threshold=1 << 30, device="cpu")
    scene.add_triangles(v, t)
    t_ref = scene.cast_rays(np.concatenate([origins, dirs], -1))["t_hit"].numpy()
    hit_ref, t_bvh = np.isfinite(t_ref), tb.numpy()
    np.testing.assert_array_equal(t_bvh < 1e30, hit_ref)
    np.testing.assert_allclose(t_bvh[hit_ref], t_ref[hit_ref], rtol=1e-4)


def test_ref_scene_routes_through_bvh(sphere):
    v, t = sphere
    scene = trc.RaycastingScene(bvh_threshold=1, device="cpu")
    scene.add_triangles(v, t)
    res = scene.cast_rays(torch.tensor([[0.1, 0, 3, 0, 0, -1], [0, 0, 3, 0, 0, 1]]))
    tt = res["t_hit"].numpy()
    assert abs(tt[0] - (3.0 - np.sqrt(1.0 - 0.01))) < 1e-2
    assert np.isinf(tt[1])
    assert int(res["geometry_ids"][0]) == 0 and int(res["geometry_ids"][1]) == -1


def test_ref_closest_points_match_bruteforce(sphere):
    v, t = sphere
    q = np.random.default_rng(1).uniform(-1.6, 1.6, (48, 3)).astype(np.float32)
    _, _, dist = tbvh.closest_points(tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t)),
                                     torch.from_numpy(q))
    scene = trc.RaycastingScene(bvh_threshold=1 << 30, device="cpu")
    scene.add_triangles(v, t)
    d_ref = np.sqrt(scene.compute_closest_points(q)["distance2"].numpy())
    np.testing.assert_allclose(dist.numpy(), d_ref, atol=2e-4)


def test_ref_sphere_distance_analytic(sphere):
    v, t = sphere
    _, _, dist = tbvh.closest_points(tbvh.build_bvh(torch.from_numpy(v), torch.from_numpy(t)),
                                     torch.tensor([[0.0, 0.0, 0.5], [0.0, 0.0, 2.0]]))
    np.testing.assert_allclose(dist.numpy(), [0.5, 1.0], atol=5e-3)


def _cube_scene():
    s = trc.RaycastingScene(tile=8, device="cpu")
    s.add_triangles(*ref_rc._unit_cube())
    return s


def test_ref_cast_rays_hit_and_miss():
    out = _cube_scene().cast_rays(torch.tensor([[0, 0, -5, 0, 0, 1], [0, 0, -5, 0, 0, -1],
                                                [5, 5, 5, 0, 0, 1]], dtype=torch.float32))
    t = out["t_hit"].numpy()
    assert abs(t[0] - 4.5) < 1e-4
    assert np.isinf(t[1]) and np.isinf(t[2])
    assert out["geometry_ids"][0] == 0 and out["geometry_ids"][1] == -1
    assert abs(abs(float(out["primitive_normals"][0, 2])) - 1.0) < 1e-5


def test_ref_count_intersections_parity():
    s = _cube_scene()
    assert int(s.count_intersections(torch.tensor([[0.03, 0.07, 0.01, 1, 0.11, 0.05]]))[0]) == 1
    assert int(s.count_intersections(torch.tensor([[0.03, 0.07, -5, 0.011, 0.007, 1]]))[0]) == 2


def test_ref_closest_points_and_distance():
    s = _cube_scene()
    q = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 0.0], [1.5, 0.0, 0.0]])
    cp = s.compute_closest_points(q)["points"].numpy()
    np.testing.assert_allclose(cp[0], [0, 0, 0.5], atol=1e-5)
    np.testing.assert_allclose(cp[2], [0.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(s.compute_distance(q).numpy(), [1.5, 0.5, 1.0], atol=1e-5)


def test_ref_signed_distance_and_occupancy():
    s = _cube_scene()
    q = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0], [0.3, 0.3, 0.3]])
    np.testing.assert_allclose(s.compute_occupancy(q).numpy(), [1.0, 0.0, 1.0])
    sd = s.compute_signed_distance(q).numpy()
    assert abs(sd[0] + 0.5) < 1e-5 and abs(sd[1] - 1.5) < 1e-5 and sd[2] < 0


def test_ref_create_rays_pinhole_center_ray():
    rays = trc.create_rays_pinhole(TIntr(64, 48, 50.0, 50.0, 31.5, 23.5), torch.eye(4), 64, 48)
    assert rays.shape == (48, 64, 6)
    center = rays[24, 32].numpy()
    np.testing.assert_allclose(center[:3], 0.0, atol=1e-6)
    assert center[5] > 0.99 * np.linalg.norm(center[3:])


def test_ref_two_geometries_ids():
    s = trc.RaycastingScene(tile=8, device="cpu")
    v, f = ref_rc._unit_cube()
    s.add_triangles(v, f)
    s.add_triangles(v + np.array([3.0, 0, 0], np.float32), f)
    out = s.cast_rays(torch.tensor([[3.0, 0, -5, 0, 0, 1], [0.0, 0, -5, 0, 0, 1]]))
    gids = out["geometry_ids"].numpy()
    assert gids[0] == 1 and gids[1] == 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Built from host arrays with no device named, the scene, the tree and
    the rays go to the card, which is missing here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f = ref_rc._unit_cube()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trc.RaycastingScene().add_triangles(v, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbvh.build_bvh(v, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trc.create_rays_pinhole(TIntr(8, 6, 5.0, 5.0, 3.5, 2.5), np.eye(4), 8, 6)
    s = trc.RaycastingScene()
    s.add_triangles(torch.from_numpy(v), torch.from_numpy(f))  # tensors keep their device
    assert s.cast_rays(torch.zeros((1, 6)))["t_hit"].device.type == "cpu"
