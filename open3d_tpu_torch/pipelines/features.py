"""FPFH features and feature matching (port of
open3d_tpu/pipelines/features.py).

Open3D's ComputeFPFHFeature and CorrespondencesFromFeatures: each point's
SPFH is three 11-bin histograms of the Darboux-frame angles (alpha, phi,
theta) of its pairs with its neighbours; its FPFH adds the distance-weighted
sum of its neighbours' SPFHs, each 11-bin group of that sum renormalised
to 100. The histograms are one-hot bins summed over the neighbour axis
(whole counts, so their order of additions does not matter), and feature
matching is the brute-force 1-NN of core/nns.py in 33 dimensions.
"""

from __future__ import annotations

import math

import torch

from open3d_tpu_torch.core import nns
from open3d_tpu_torch.core.masking import _div
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.ops.pointcloud import gather_neighbors

_EPS = 1e-12


def _pair_features(p1, n1, p2, n2):
    """Darboux-frame pair features (f1 = theta, f2 = alpha, f3 = phi, f4 = d)
    of point pairs, over any leading dimensions. Returns (f1, f2, f3, f4,
    valid)."""
    dp = p2 - p1
    d = torch.linalg.norm(dp, dim=-1)
    valid = d > _EPS
    du = dp / torch.where(valid, d, 1.0)[..., None]

    angle1 = torch.sum(n1 * du, dim=-1)
    angle2 = torch.sum(n2 * du, dim=-1)
    # order the pair so the source normal makes the smaller angle with the segment
    swap = (torch.abs(angle1) < torch.abs(angle2))[..., None]
    n1c = torch.where(swap, n2, n1)
    n2c = torch.where(swap, n1, n2)
    du = torch.where(swap, -du, du)
    f3 = torch.where(swap[..., 0], angle2, angle1)

    v = torch.linalg.cross(du, n1c, dim=-1)
    vnorm = torch.linalg.norm(v, dim=-1)
    valid = valid & (vnorm > _EPS)
    v = v / torch.where(vnorm > _EPS, vnorm, 1.0)[..., None]
    w = torch.linalg.cross(n1c, v, dim=-1)
    f2 = torch.sum(v * n2c, dim=-1)
    f1 = torch.atan2(torch.sum(w * n2c, dim=-1), torch.sum(n1c * n2c, dim=-1))
    zero = torch.zeros_like(d)
    return (torch.where(valid, f1, zero), torch.where(valid, f2, zero),
            torch.where(valid, f3, zero), torch.where(valid, d, zero), valid)


def _bin11(f, lo, hi):
    """Map a feature to one of 11 bins of [lo, hi] -> (..., 11) one-hot f32.
    The quotient is rounded once on every device (a tensor divisor), so the
    card and the CPU bin alike."""
    idx = torch.floor(_div(11.0 * (f - lo), hi - lo)).to(torch.int64)
    return torch.nn.functional.one_hot(torch.clamp(idx, 0, 10), 11).to(torch.float32)


def _spfh(pos, normals, idx, self_index):
    """Per-point SPFH 33-vector from the neighbour index table (N, K): each
    valid pair adds 100 / (neighbours - 1) to one bin of each group."""
    nbr_p = gather_neighbors(pos, idx)  # (N, K, 3)
    nbr_n = gather_neighbors(normals, idx)
    f1, f2, f3, _, pf_valid = _pair_features(pos[:, None, :], normals[:, None, :], nbr_p, nbr_n)
    nbr = (idx >= 0) & (idx != self_index[:, None])
    w = (nbr & pf_valid).to(torch.float32)[..., None]  # (N, K, 1)
    cnt = nbr.sum(1).to(torch.float32)
    hist_incr = 100.0 / torch.clamp(cnt, min=1.0)
    groups = [_bin11(f1, -math.pi, math.pi), _bin11(f2, -1.0, 1.0), _bin11(f3, -1.0, 1.0)]
    spfh = torch.cat([(h * w).sum(1) for h in groups], dim=-1)  # theta, alpha, phi
    return spfh * hist_incr[:, None], cnt


def compute_fpfh_feature(
    pcd: PointCloud,
    radius: float = 0.25,
    max_nn: int = 100,
    nns_grid_threshold: int | None = 65536,
    nns_max_per_cell: int = 64,
) -> torch.Tensor:
    """33-dim FPFH per point -> (N, 33) f32, zero rows where masked out:
    FPFH_i = SPFH_i + the sum over neighbours k of SPFH_k / d2_ik, each
    11-bin group of that sum renormalised to 100."""
    pos = pcd.positions
    normals = pcd.attrs["normals"]
    N = pos.shape[0]
    idx, d2, _ = nns.hybrid_search(
        pos, pos, radius, max_nn, target_mask=pcd.mask,
        grid_threshold=nns_grid_threshold, max_per_cell=nns_max_per_cell,
    )
    self_index = torch.arange(N, dtype=torch.int32, device=pos.device)
    spfh, _ = _spfh(pos, normals, idx, self_index)

    # distance-weighted aggregation of the neighbours' SPFHs
    nbr = (idx >= 0) & (idx != self_index[:, None]) & (d2 > _EPS)
    wgt = torch.where(nbr, 1.0 / torch.clamp(d2, min=_EPS), 0.0)
    agg = (gather_neighbors(spfh, idx) * wgt[..., None]).sum(1).reshape(N, 3, 11)
    group_sum = agg.sum(-1, keepdim=True)
    scale = torch.where(group_sum > _EPS, 100.0 / torch.clamp(group_sum, min=_EPS), 0.0)
    fpfh = (agg * scale).reshape(N, 33) + spfh
    return torch.where(pcd.mask[:, None], fpfh, 0.0)


def correspondences_from_features(
    source_features: torch.Tensor,
    target_features: torch.Tensor,
    mutual_filter: bool = False,
    source_mask: torch.Tensor | None = None,
    target_mask: torch.Tensor | None = None,
):
    """1-NN in feature space. Returns (corres (N,) int32 target row per
    source row, valid (N,) bool); with mutual_filter, valid also asks that
    the target's own nearest source is that row."""
    nn_st, _ = nns.one_nn_search(source_features, target_features, target_mask=target_mask)
    valid = nn_st >= 0
    if source_mask is not None:
        valid = valid & source_mask
    if mutual_filter:
        nn_ts, _ = nns.one_nn_search(target_features, source_features, target_mask=source_mask)
        back = nn_ts[torch.clamp(nn_st, min=0).to(torch.int64)]
        valid = valid & (back == torch.arange(nn_st.shape[0], dtype=torch.int32, device=back.device))
    return torch.where(valid, nn_st, -1), valid
