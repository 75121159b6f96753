"""Surface reconstruction from point clouds (port of
open3d_tpu/pipelines/surface_reconstruction.py).

- marching_tetrahedra_dense: the iso-surface of a dense field, six
  tetrahedra a cube as in the TSDF extractor. The JAX package builds every
  cube's 12 triangle slots at once, (C, 6, 2, 3, 3) over all C = (n-1)^3
  cubes, which is tens of GB at n = 256. Here one pass computes each
  tetrahedron's case over slabs of cubes, and a second builds only the
  live triangles, in batches; the soup comes in the JAX package's order
  (cube-major, tetrahedron, slot) and does not depend on the batch sizes.
- reconstruct_poisson_fft: the FFT indicator solve (Kazhdan, SGP'05): the
  normals splatted trilinearly into a vector field (core.masking's
  deterministic scatter-add, so the same cloud gives the same bits on every
  run), one forward and one inverse 3-D FFT (torch.fft, as the JAX package
  uses jnp.fft), then the marching above at the mean indicator value of
  the samples.
- reconstruct_alpha_shape: scipy's Delaunay on the host, as the reference.

No module here holds a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from open3d_tpu_torch.core.masking import _scatter_add
from open3d_tpu_torch.geometry import voxel_block_grid as _vbg
from open3d_tpu_torch.geometry.trianglemesh import TriangleMesh

_CHUNK_CUBES = 1 << 21  # cubes a step of the case pass
_CHUNK_TRIS = 1 << 20  # triangles a step of the build pass


def _cases(field: torch.Tensor, iso: float, chunk_cubes: int) -> torch.Tensor:
    """(C * 6,) uint8: each cube's six tetrahedron cases, cube-major in the
    (x, y, z) order of a meshgrid with indexing "ij"."""
    X, Y, Z = field.shape
    slab = max(1, chunk_cubes // max((Y - 1) * (Z - 1), 1))
    tets = _vbg._CUBE_TETS.tolist()
    out = []
    for x0 in range(0, X - 1, slab):
        m = min(slab, X - 1 - x0)
        f = field[x0:x0 + m + 1]
        # corner c = dx | dy << 1 | dz << 2
        inside = [(f[dx:dx + m, dy:dy + Y - 1, dz:dz + Z - 1] < iso).to(torch.uint8)
                  for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        case = torch.stack([inside[a] | (inside[b] << 1) | (inside[c] << 2) | (inside[d] << 3)
                            for a, b, c, d in tets], dim=-1)  # (m, Y-1, Z-1, 6)
        out.append(case.reshape(-1))
    return torch.cat(out)


def marching_tetrahedra_dense(field: torch.Tensor, iso: float = 0.0,
                              origin=(0.0, 0.0, 0.0), spacing: float = 1.0,
                              triangle_capacity: int = 131072) -> TriangleMesh:
    """Iso-surface of a dense (X, Y, Z) scalar field as a fixed-capacity
    triangle soup: the live triangles in scan order (cube, tetrahedron,
    slot), the first `triangle_capacity` kept; unused rows are zero and
    masked out."""
    return _marching(field, iso, origin, spacing, triangle_capacity, _CHUNK_CUBES, _CHUNK_TRIS)


def _marching(field, iso, origin, spacing, triangle_capacity, chunk_cubes, chunk_tris):
    X, Y, Z = field.shape
    dev = field.device
    Tcap = int(triangle_capacity)
    tet_edges, tet_count = _vbg._TET_EDGES.to(dev), _vbg._TET_COUNT.to(dev)
    cube_tets, offs = _vbg._CUBE_TETS.to(dev), _vbg._CORNER_OFFSETS.to(dev).to(torch.int64)
    org = torch.as_tensor(origin, dtype=torch.float32, device=dev)

    cases = _cases(field, iso, chunk_cubes)
    cell = torch.nonzero((cases != 0) & (cases != 15)).reshape(-1)  # (cube, tet), scan order
    n_tri = tet_count[cases[cell].to(torch.int64)]
    kept = min(int(n_tri.sum()), Tcap)
    tri_cell = torch.repeat_interleave(cell, n_tri)[:kept]
    slot = (torch.arange(kept, device=dev)
            - torch.repeat_interleave(torch.cumsum(n_tri, 0) - n_tri, n_tri)[:kept])

    out = torch.zeros((Tcap, 3, 3), dtype=torch.float32, device=dev)
    for s in range(0, kept, chunk_tris):
        c, sl = tri_cell[s:s + chunk_tris], slot[s:s + chunk_tris]
        cube, tet = c // 6, c % 6
        base = torch.stack([cube // ((Y - 1) * (Z - 1)), (cube // (Z - 1)) % (Y - 1),
                            cube % (Z - 1)], dim=-1)  # (m, 3)
        pairs = tet_edges[cases[c].to(torch.int64), sl]  # (m, 3, 2) tetrahedron corners
        corner = base[:, None, None, :] + offs[cube_tets[tet[:, None, None], pairs]]  # (m, 3, 2, 3)
        vals = field[corner[..., 0], corner[..., 1], corner[..., 2]]  # (m, 3, 2)
        pos = corner.to(torch.float32) * spacing + org
        va, vb = vals[..., 0], vals[..., 1]
        t = (iso - va) / torch.where(torch.abs(vb - va) > 1e-12, vb - va, 1.0)
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        pa, pb = pos[:, :, 0], pos[:, :, 1]
        out[s:s + c.numel()] = pa + t * (pb - pa)
    return TriangleMesh.from_triangle_soup(out, torch.arange(Tcap, device=dev) < kept)


def reconstruct_poisson_fft(
    positions: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor | None = None,
    depth: int = 6,
    padding: float = 0.1,
    triangle_capacity: int = 131072,
):
    """Indicator-function surface reconstruction on a (2^depth)^3 grid: one
    forward and one inverse 3-D FFT. Returns (mesh, chi_grid, origin,
    spacing)."""
    n = 1 << depth
    dev = positions.device
    if mask is None:
        mask = torch.ones(positions.shape[0], dtype=torch.bool, device=dev)
    w = mask.to(torch.float32)
    lo = torch.where(mask[:, None], positions, float("inf")).amin(0)
    hi = torch.where(mask[:, None], positions, float("-inf")).amax(0)
    span = (hi - lo).amax() * (1.0 + 2.0 * padding)
    origin = (lo + hi) / 2.0 - span / 2.0
    spacing = span / torch.full((), n, dtype=torch.float32, device=dev)  # divided, on every device

    # trilinear splat of the normals into V (n, n, n, 3), corner-major
    g = (positions - origin) / spacing - 0.5
    g0 = torch.floor(g).to(torch.int64)
    frac = g - g0.to(torch.float32)
    lins, vals = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cell = g0 + torch.tensor([dx, dy, dz], device=dev)
                wt = ((frac[:, 0] if dx else 1 - frac[:, 0])
                      * (frac[:, 1] if dy else 1 - frac[:, 1])
                      * (frac[:, 2] if dz else 1 - frac[:, 2])) * w
                ok = torch.all((cell >= 0) & (cell < n), dim=-1)
                lins.append(torch.where(ok, (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2], -1))
                vals.append(normals * wt[:, None])
    V = _scatter_add(torch.cat(vals), torch.cat(lins), n * n * n).reshape(n, n, n, 3)

    # lap(chi) = div(V) in Fourier space: chi_hat = (i k . V_hat) / -|k|^2,
    # with a mild Gaussian screen
    k = torch.fft.fftfreq(n, device=dev) * 2.0 * torch.pi  # radians a cell
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    k2 = kx * kx + ky * ky + kz * kz
    Vh = torch.fft.fftn(V.permute(3, 0, 1, 2), dim=(1, 2, 3))
    div_h = 1j * (kx * Vh[0] + ky * Vh[1] + kz * Vh[2])
    del Vh
    chi_h = torch.where(k2 > 1e-12, div_h / -torch.clamp(k2, min=1e-12), 0.0)
    chi_h = chi_h * torch.exp(-0.5 * k2)
    chi = torch.fft.ifftn(chi_h, dim=(0, 1, 2)).real

    # the iso level: chi's mean at the samples
    gi = torch.clamp(torch.round(g).to(torch.int64), 0, n - 1)
    chi_at = chi[gi[:, 0], gi[:, 1], gi[:, 2]]
    iso = (chi_at * w).sum() / torch.clamp(w.sum(), min=1.0)

    mesh = marching_tetrahedra_dense(chi - iso, 0.0, origin=origin, spacing=float(spacing),
                                     triangle_capacity=triangle_capacity)
    return mesh, chi, origin, spacing


def reconstruct_alpha_shape(positions: np.ndarray, alpha: float,
                            mask: np.ndarray | None = None):
    """Alpha-shape mesh on the host: scipy's Delaunay tetrahedralisation,
    the tetrahedra of circumradius under `alpha`, and the faces that only
    one of them uses, oriented away from the centroid. Returns (vertices
    (V, 3) f32, triangles (T, 3) i32), numpy."""
    from scipy.spatial import Delaunay

    pts = np.asarray(positions.cpu().numpy() if isinstance(positions, torch.Tensor)
                     else positions, np.float64)
    if mask is not None:
        pts = pts[np.asarray(mask.cpu().numpy() if isinstance(mask, torch.Tensor) else mask,
                             bool)]
    simp = Delaunay(pts).simplices  # (M, 4)
    a, b, c, d = (pts[simp[:, i]] for i in range(4))

    ba, ca, da = b - a, c - a, d - a
    det = np.einsum("ij,ij->i", ba, np.cross(ca, da))
    num = (np.einsum("ij,ij->i", ba, ba)[:, None] * np.cross(ca, da)
           + np.einsum("ij,ij->i", ca, ca)[:, None] * np.cross(da, ba)
           + np.einsum("ij,ij->i", da, da)[:, None] * np.cross(ba, ca))
    safe = np.abs(det) > 1e-12
    circ = np.full(len(simp), np.inf)
    circ[safe] = np.linalg.norm(num[safe], axis=1) / (2.0 * np.abs(det[safe]))

    faces = {}
    for s in simp[circ < alpha]:
        for f in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            key = tuple(sorted((s[f[0]], s[f[1]], s[f[2]])))
            faces[key] = faces.get(key, 0) + 1
    boundary = np.array([k for k, v in faces.items() if v == 1], np.int32)
    if len(boundary) == 0:
        return pts.astype(np.float32), np.zeros((0, 3), np.int32)

    centroid = pts.mean(0)
    va, vb, vc = pts[boundary[:, 0]], pts[boundary[:, 1]], pts[boundary[:, 2]]
    flip = np.einsum("ij,ij->i", np.cross(vb - va, vc - va), (va + vb + vc) / 3 - centroid) < 0
    boundary[flip] = boundary[flip][:, [0, 2, 1]]
    return pts.astype(np.float32), boundary
