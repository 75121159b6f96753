"""open3d_tpu_torch.visualization: the viewer bridge and debug rendering
(port of open3d_tpu/visualization/).

A thin client that ships geometry to any viewer speaking Open3D's
msgpack-over-ZeroMQ RPC protocol (rpc.py), and headless matplotlib /
plotly rendering (draw.py). Geometries on the card are copied to the host
with `.cpu()`; msgpack, zmq, matplotlib and plotly are imported when a
function needs them.
"""

from open3d_tpu_torch.visualization.rpc import (  # noqa: F401
    BufferConnection,
    Connection,
    set_mesh_data,
    set_point_cloud,
    set_triangle_mesh,
)
