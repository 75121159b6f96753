"""msgpack-over-ZeroMQ geometry streaming (port of
open3d_tpu/visualization/rpc.py), in the shape of Open3D's RPC protocol
(io/rpc/Messages.h: Array :104, MeshData :255, SetMeshData :391,
Request/Reply/Status :508-543; the client io/rpc/Connection.cpp).

A request is two msgpack objects in one ZeroMQ message, {"msg_id": name}
and the body; the reply is {"msg_id": "status"} and {"code": 0, "str":
"OK"}. Arrays carry numpy's typestr ("<f4", "<i4"), their shape and their
bytes, as Messages.h's Array does. The port's geometries are copied to
the host with `.cpu()` first, so a frame holds the bytes the JAX package
sends for the same geometry.
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    """A numpy array of a host array or a tensor on any device."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _encode_array(a) -> dict:
    a = np.ascontiguousarray(_host(a))
    return {"type": a.dtype.str, "shape": list(a.shape), "data": a.tobytes()}


def decode_array(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["type"])).reshape(d["shape"])


def _mesh_data(
    vertices=None,
    faces=None,
    vertex_attributes=None,
    face_attributes=None,
    lines=None,
    o3d_type: str = "",
) -> dict:
    """MeshData payload (ref: Messages.h:255)."""
    msg = {
        "vertices": _encode_array(vertices) if vertices is not None else None,
        "vertex_attributes": {
            k: _encode_array(v) for k, v in (vertex_attributes or {}).items()
        },
        "faces": _encode_array(faces) if faces is not None else None,
        "face_attributes": {
            k: _encode_array(v) for k, v in (face_attributes or {}).items()
        },
        "lines": _encode_array(lines) if lines is not None else None,
        "o3d_type": o3d_type,
    }
    return {k: v for k, v in msg.items() if v is not None}


def _pack_request(msg_id: str, body: dict) -> bytes:
    import msgpack

    return msgpack.packb({"msg_id": msg_id}) + msgpack.packb(body)


def unpack_request(raw: bytes):
    """Decode a two-object request frame -> (msg_id, body). Server/test side."""
    import msgpack

    unpacker = msgpack.Unpacker(raw=False)
    unpacker.feed(raw)
    head = unpacker.unpack()
    body = unpacker.unpack()
    return head["msg_id"], body


class BufferConnection:
    """In-memory connection collecting raw frames
    (ref: io/rpc/BufferConnection.cpp — used by the reference's own tests)."""

    def __init__(self):
        self.frames: list[bytes] = []

    def send(self, raw: bytes) -> dict:
        self.frames.append(raw)
        return {"code": 0, "str": "OK"}

    def close(self):
        pass


class Connection:
    """ZeroMQ REQ client (ref: io/rpc/Connection.cpp; default endpoint
    tcp://127.0.0.1:51454 as in the reference)."""

    def __init__(self, address: str = "tcp://127.0.0.1:51454", timeout_ms: int = 5000):
        import zmq

        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.SNDTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(address)

    def send(self, raw: bytes) -> dict:
        import msgpack

        self._sock.send(raw)
        reply = self._sock.recv()
        unpacker = msgpack.Unpacker(raw=False)
        unpacker.feed(reply)
        _ = unpacker.unpack()  # {"msg_id": "status"}
        return unpacker.unpack()

    def close(self):
        self._sock.close()


def set_mesh_data(
    path: str = "",
    time: int = 0,
    layer: str = "",
    vertices=None,
    vertex_attributes=None,
    faces=None,
    face_attributes=None,
    lines=None,
    o3d_type: str = "",
    connection=None,
) -> dict:
    """(ref: io/rpc/RemoteFunctions.cpp set_mesh_data / Messages.h SetMeshData
    :391). Returns the status reply dict."""
    conn = connection or BufferConnection()
    body = {
        "path": path,
        "time": int(time),
        "layer": layer,
        "data": _mesh_data(
            vertices, faces, vertex_attributes, face_attributes, lines, o3d_type
        ),
    }
    return conn.send(_pack_request("set_mesh_data", body))


def set_point_cloud(pcd, path: str = "", time: int = 0, layer: str = "",
                    connection=None) -> dict:
    """Ship a (masked) PointCloud (ref: RemoteFunctions.cpp
    SetPointCloud)."""
    pos = _host(pcd.positions)
    keep = _host(pcd.mask)
    attrs = {}
    for k, v in pcd.attrs.items():
        v = _host(v)
        if v.ndim >= 1 and v.shape[0] == pos.shape[0]:
            attrs[k] = v[keep]
    return set_mesh_data(
        path=path, time=time, layer=layer, vertices=pos[keep].astype(np.float32),
        vertex_attributes=attrs, o3d_type="PointCloud", connection=connection,
    )


def set_triangle_mesh(mesh, path: str = "", time: int = 0, layer: str = "",
                      connection=None) -> dict:
    """Ship a TriangleMesh (ref: RemoteFunctions.cpp SetTriangleMesh)."""
    v = _host(mesh.vertices).astype(np.float32)
    f = _host(mesh.triangles).astype(np.int32)
    if getattr(mesh, "triangle_mask", None) is not None:
        f = f[_host(mesh.triangle_mask)]
    return set_mesh_data(
        path=path, time=time, layer=layer, vertices=v, faces=f,
        o3d_type="TriangleMesh", connection=connection,
    )


def set_time(time: int, connection=None) -> dict:
    """(ref: Messages.h SetTime :478)"""
    conn = connection or BufferConnection()
    return conn.send(_pack_request("set_time", {"time": int(time)}))


def set_active_camera(path: str, connection=None) -> dict:
    """(ref: Messages.h SetActiveCamera :487)"""
    conn = connection or BufferConnection()
    return conn.send(_pack_request("set_active_camera", {"path": path}))
