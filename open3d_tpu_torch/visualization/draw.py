"""Debug rendering on the host (port of open3d_tpu/visualization/draw.py;
Open3D's python/open3d/visualization/draw.py `draw()` and
draw_plotly.py): a headless matplotlib PNG, a plotly figure, or the
geometry sent to a viewer over RPC. Geometries on the card are copied to
the host with `.cpu()`.
"""

from __future__ import annotations

import numpy as np

from open3d_tpu_torch.visualization.rpc import _host


def _as_plottable(geometry):
    """-> (points (N,3), colors (N,3) or None, triangles or None)."""
    if hasattr(geometry, "positions"):  # PointCloud
        keep = _host(geometry.mask)
        pos = _host(geometry.positions)[keep]
        col = None
        if "colors" in geometry.attrs:
            col = _host(geometry.attrs["colors"])[keep]
        return pos, col, None
    if hasattr(geometry, "vertices"):  # TriangleMesh
        v = _host(geometry.vertices)
        f = _host(geometry.triangles)
        if getattr(geometry, "triangle_mask", None) is not None:
            f = f[_host(geometry.triangle_mask)]
        return v, None, f
    raise TypeError(f"not drawable: {type(geometry)}")


def draw(geometries, output_path: str | None = None, point_size: float = 1.0,
         max_points: int = 200_000):
    """Render geometry list (ref: visualization/draw.py `draw()`); headless:
    saves a PNG via matplotlib 3D scatter, subsampled to max_points."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not isinstance(geometries, (list, tuple)):
        geometries = [geometries]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for g in geometries:
        pos, col, tris = _as_plottable(g)
        if len(pos) > max_points:
            sel = np.random.default_rng(0).choice(len(pos), max_points, replace=False)
            pos = pos[sel]
            col = col[sel] if col is not None else None
        if tris is not None and len(tris):
            ax.plot_trisurf(pos[:, 0], pos[:, 1], pos[:, 2], triangles=tris,
                            alpha=0.7, linewidth=0.1)
        else:
            ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=point_size,
                       c=np.clip(col, 0, 1) if col is not None else None)
    ax.set_box_aspect((1, 1, 1))
    out = output_path or "draw.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def draw_plotly(geometries):
    """(ref: python/open3d/visualization/draw_plotly.py) Returns a plotly
    figure; raises ImportError when plotly is absent (gated dependency)."""
    import plotly.graph_objects as go  # gated: not a baked-in dependency

    if not isinstance(geometries, (list, tuple)):
        geometries = [geometries]
    traces = []
    for g in geometries:
        pos, col, tris = _as_plottable(g)
        if tris is not None and len(tris):
            traces.append(
                go.Mesh3d(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                          i=tris[:, 0], j=tris[:, 1], k=tris[:, 2], opacity=0.8)
            )
        else:
            marker = dict(size=2)
            if col is not None:
                marker["color"] = [
                    f"rgb({int(r*255)},{int(g_*255)},{int(b*255)})"
                    for r, g_, b in np.clip(col, 0, 1)
                ]
            traces.append(
                go.Scatter3d(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                             mode="markers", marker=marker)
            )
    return go.Figure(data=traces)


class ExternalVisualizer:
    """RPC client facade (ref: python/open3d/visualization/_external_visualizer.py
    `EV`): ev.set(geometry, path=...) ships to a listening viewer."""

    def __init__(self, address: str = "tcp://127.0.0.1:51454"):
        self.address = address

    def set(self, obj=None, path: str = "", time: int = 0, layer: str = ""):
        from open3d_tpu_torch.visualization import rpc

        conn = rpc.Connection(self.address)
        try:
            if hasattr(obj, "positions"):
                return rpc.set_point_cloud(obj, path, time, layer, connection=conn)
            return rpc.set_triangle_mesh(obj, path, time, layer, connection=conn)
        finally:
            conn.close()
