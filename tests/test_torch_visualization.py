"""Port of visualization/ (the RPC client and draw): the five cases of
tests/test_visualization.py on the port's geometries, the frames the port
builds against the JAX package's bytes for the same geometry, and the
`draw` command through tools.cli.main.

Bars: every frame byte-equal to the JAX package's; the PNG non-empty. The
ZeroMQ cases bind a random localhost port (the reference's fixed one may
be taken by its own test running beside this file).
"""

import os
import threading

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from open3d_tpu.geometry.pointcloud import PointCloud as JCloud
from open3d_tpu.geometry.trianglemesh import TriangleMesh as JMesh
from open3d_tpu.visualization import rpc as jrpc
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh
from open3d_tpu_torch.visualization import rpc

torch.set_num_threads(2)


def test_set_mesh_data_frame_roundtrip():
    buf = rpc.BufferConnection()
    v = np.arange(12, dtype=np.float32).reshape(4, 3)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rpc.set_mesh_data(path="scene/mesh", time=7, vertices=torch.as_tensor(v), faces=f,
                      vertex_attributes={"colors": torch.ones((4, 3))},
                      o3d_type="TriangleMesh", connection=buf)
    assert len(buf.frames) == 1
    msg_id, body = rpc.unpack_request(buf.frames[0])
    assert msg_id == "set_mesh_data"
    assert body["path"] == "scene/mesh" and body["time"] == 7
    data = body["data"]
    np.testing.assert_array_equal(rpc.decode_array(data["vertices"]), v)
    np.testing.assert_array_equal(rpc.decode_array(data["faces"]), f)
    assert data["vertices"]["type"] == "<f4"
    assert rpc.decode_array(data["vertex_attributes"]["colors"]).shape == (4, 3)


def test_set_point_cloud_respects_mask():
    pcd = PointCloud.create(torch.tensor([[0.0, 0, 0], [1, 1, 1], [2, 2, 2]]),
                            colors=torch.ones((3, 3)))
    pcd = pcd.select_by_mask(torch.tensor([True, False, True]))
    buf = rpc.BufferConnection()
    rpc.set_point_cloud(pcd, path="pcd", connection=buf)
    _, body = rpc.unpack_request(buf.frames[0])
    assert rpc.decode_array(body["data"]["vertices"]).shape[0] == 2
    assert body["data"]["o3d_type"] == "PointCloud"


def _rep_server(zmq, replies):
    """A REP socket on a random localhost port answering one request."""
    rep = zmq.Context.instance().socket(zmq.REP)
    port = rep.bind_to_random_port("tcp://127.0.0.1")
    got = {}

    def serve():
        got["msg"] = rpc.unpack_request(rep.recv())
        rep.send(replies)
        rep.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return f"tcp://127.0.0.1:{port}", th, got


def test_zmq_loopback():
    import zmq

    addr, th, got = _rep_server(zmq, msgpack.packb({"msg_id": "status"})
                                + msgpack.packb({"code": 0, "str": "OK"}))
    conn = rpc.Connection(addr, timeout_ms=10000)
    try:
        reply = rpc.set_mesh_data(path="x", vertices=np.zeros((2, 3), np.float32),
                                  connection=conn)
    finally:
        conn.close()
    th.join(timeout=10)
    assert not th.is_alive()
    assert reply == {"code": 0, "str": "OK"} and got["msg"][0] == "set_mesh_data"


def test_draw_writes_png(tmp_path):
    from open3d_tpu_torch.visualization import draw as drw

    pcd = PointCloud.create(torch.rand((100, 3), generator=torch.Generator().manual_seed(0)),
                            device="cpu")
    out = drw.draw([pcd], output_path=str(tmp_path / "scene.png"))
    assert os.path.getsize(out) > 1000


def test_set_point_cloud_over_socket():
    zmq = pytest.importorskip("zmq")
    addr, th, got = _rep_server(zmq, msgpack.packb("status", use_bin_type=True)
                                + msgpack.packb({"status": {"code": 0, "str": "OK"}}))
    pts = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    conn = rpc.Connection(addr, timeout_ms=5000)
    try:
        rpc.set_point_cloud(PointCloud.create(pts, device="cpu"), path="test/pcd", connection=conn)
    finally:
        conn.close()
    th.join(timeout=5)
    assert not th.is_alive()
    msg_id, body = got["msg"]
    assert msg_id == "set_mesh_data"
    assert rpc.decode_array(body["data"]["vertices"]).shape == (32, 3)


# ---- the frames against the JAX package's ---------------------------------

def _geometry(seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.uniform(size=50) > 0.3
    v = rng.normal(size=(20, 3)).astype(np.float32)
    t = rng.integers(0, 20, (30, 3)).astype(np.int32)
    tmask = rng.uniform(size=30) > 0.2
    return (dict(positions=pos, mask=mask, colors=col, normals=nrm),
            dict(vertices=v, triangles=t, triangle_mask=tmask))


def test_frames_equal_the_reference():
    c, m = _geometry()
    tc = PointCloud.create(c["positions"], mask=c["mask"], colors=c["colors"],
                           normals=c["normals"], device="cpu")
    jc = JCloud.create(jnp.asarray(c["positions"]), mask=jnp.asarray(c["mask"]),
                       colors=jnp.asarray(c["colors"]), normals=jnp.asarray(c["normals"]))
    tm = TriangleMesh.create(m["vertices"], m["triangles"], triangle_mask=m["triangle_mask"],
                             device="cpu")
    jm = JMesh.create(jnp.asarray(m["vertices"]), jnp.asarray(m["triangles"]),
                      triangle_mask=jnp.asarray(m["triangle_mask"]))
    frames = {}
    for name, mod, cloud, mesh in (("port", rpc, tc, tm), ("jax", jrpc, jc, jm)):
        buf = mod.BufferConnection()
        mod.set_point_cloud(cloud, path="a/cloud", time=3, layer="L", connection=buf)
        mod.set_triangle_mesh(mesh, path="a/mesh", time=4, connection=buf)
        mod.set_mesh_data(path="m", vertices=m["vertices"], faces=m["triangles"],
                          lines=m["triangles"][:, :2], connection=buf)
        mod.set_time(9, connection=buf)
        mod.set_active_camera("cam", connection=buf)
        frames[name] = buf.frames
    assert len(frames["port"]) == 5
    assert frames["port"] == frames["jax"]
    _, body = rpc.unpack_request(frames["port"][0])
    assert rpc.decode_array(body["data"]["vertices"]).shape == (int(c["mask"].sum()), 3)
    _, body = rpc.unpack_request(frames["port"][1])
    assert rpc.decode_array(body["data"]["faces"]).shape == (int(m["triangle_mask"].sum()), 3)


def test_cli_draw_writes_png(tmp_path, capsys):
    from open3d_tpu_torch.io import write_point_cloud
    from open3d_tpu_torch.tools import cli

    c, _ = _geometry(2)
    src = str(tmp_path / "c.ply")
    write_point_cloud(src, PointCloud.create(c["positions"], colors=c["colors"], device="cpu"))
    cli.main(["draw", src, "--device", "cpu"])
    out = str(tmp_path / "c.png")
    assert os.path.getsize(out) > 1000 and f"wrote {out}" in capsys.readouterr().out
    cli.main(["draw", src, "--output", str(tmp_path / "d.png"), "--device", "cpu"])
    assert os.path.getsize(tmp_path / "d.png") > 1000
