"""Global registration: batched RANSAC and Fast Global Registration (port
of open3d_tpu/pipelines/global_registration.py).

- RANSAC (Open3D's RegistrationRANSACBasedOnCorrespondence /
  ...BasedOnFeatureMatching) runs in rounds of `batch_size` hypotheses:
  each round draws the samples, runs the edge-length and distance checkers
  and scores every surviving hypothesis against all correspondences as one
  batched transform and reduction. The confidence early exit reads the
  best fitness once a round, at most ceil(max_iteration / batch_size)
  host reads.
- FGR (Zhou, Park, Koltun, ECCV 2016): mutual matching and the tuple test,
  then graduated non-convexity on a scaled Geman-McClure objective, a fixed
  number of Gauss-Newton iterations with no host read.

`key` is a torch.Generator; without one, a generator seeded 0 on the
clouds' device. The draws are not JAX's, so a sampled result differs from
the JAX package's within the same bars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from open3d_tpu_torch.core import lie, linalg
from open3d_tpu_torch.core.masking import _div
from open3d_tpu_torch.geometry.pointcloud import PointCloud
from open3d_tpu_torch.pipelines import features as feat_mod
from open3d_tpu_torch.pipelines.registration import RegistrationResult, _weighted_umeyama


@dataclasses.dataclass(frozen=True)
class RANSACConvergenceCriteria:
    """Open3D's defaults: max_iteration 100000, confidence 0.999."""
    max_iteration: int = 100000
    confidence: float = 0.999


def _generator(key, device) -> torch.Generator:
    return key if key is not None else torch.Generator(device=device).manual_seed(0)


def _sample_compaction(valid):
    """Stable compaction: order[i] = row of the i-th valid correspondence."""
    order = torch.argsort((~valid).to(torch.int8), stable=True).to(torch.int32)
    return order, valid.to(torch.int32).sum()


def _check_edge_length(ps, qs, similarity: float):
    """Every sampled edge passes the edge-length similarity test (Open3D's
    CorrespondenceCheckerBasedOnEdgeLength, default 0.9): ps, qs (B, n, 3)
    -> (B,) bool."""
    dp = torch.linalg.norm(ps[:, :, None, :] - ps[:, None, :, :], dim=-1)
    dq = torch.linalg.norm(qs[:, :, None, :] - qs[:, None, :, :], dim=-1)
    k = ps.shape[1]
    offdiag = ~torch.eye(k, dtype=torch.bool, device=ps.device)[None]
    ok = (dp > similarity * dq) & (dq > similarity * dp)
    return torch.all(ok | ~offdiag, dim=2).all(1)


def registration_ransac_from_correspondences(
    source: PointCloud,
    target: PointCloud,
    corres: torch.Tensor,
    corres_valid: torch.Tensor,
    max_correspondence_distance: float,
    ransac_n: int = 3,
    criteria: RANSACConvergenceCriteria = RANSACConvergenceCriteria(),
    similarity_threshold: float = 0.9,
    batch_size: int = 512,
    key: Optional[torch.Generator] = None,
) -> RegistrationResult:
    """Batched-hypothesis RANSAC on given source -> target correspondences."""
    src = source.positions
    dev = src.device
    gen = _generator(key, dev)
    dmax2 = max_correspondence_distance**2
    tgt = target.positions
    order, count = _sample_compaction(corres_valid)
    # the draws' bound: the valid count does not change inside the loop,
    # so it is read once
    n_valid = max(int(count), 1)
    countf = float(n_valid)
    n_rounds = max(1, -(-int(criteria.max_iteration) // batch_size))
    corres_safe = torch.clamp(corres, min=0).to(torch.int64)
    all_q = tgt[corres_safe]  # (N, 3)

    def score_batch():
        ids = torch.randint(0, n_valid, (batch_size, ransac_n), generator=gen, device=gen.device)
        cid = order[ids.to(dev)].to(torch.int64)  # (B, n) correspondence rows
        ps = src[cid]  # (B, n, 3)
        qs = tgt[corres_safe[cid]]
        ok = _check_edge_length(ps, qs, similarity_threshold)
        Ts = _weighted_umeyama(ps, qs, torch.ones(ps.shape[:2], dtype=torch.float32, device=dev))
        R, t = Ts[:, :3, :3], Ts[:, None, :3, 3]
        # the distance checker on the sampled set
        ps_t = torch.einsum("bij,bnj->bni", R, ps) + t
        ok = ok & torch.all(torch.sum((ps_t - qs) ** 2, dim=-1) <= dmax2, dim=1)
        # every hypothesis over the whole correspondence set
        e2 = torch.sum((torch.einsum("bij,nj->bni", R, src) + t - all_q) ** 2, dim=-1)  # (B, N)
        inlier = (e2 <= dmax2) & corres_valid[None, :]
        n_in = inlier.sum(1).to(torch.float32)
        fitness = torch.where(ok, n_in / countf, -1.0)
        rmse = torch.sqrt(torch.where(inlier, e2, 0.0).sum(1) / torch.clamp(n_in, min=1.0))
        b = torch.argmax(fitness - 1e-6 * rmse)
        return Ts[b], fitness[b], rmse[b]

    best_fit = torch.full((), -1.0, device=dev)
    best_rmse = torch.full((), 1e30, device=dev)
    best_T = torch.eye(4, dtype=torch.float32, device=dev)
    for rnd in range(n_rounds):
        if rnd > 0:
            # confidence early exit: the hypotheses needed so that
            # 1 - (1 - fitness^n)^iters >= confidence
            p_good = min(max(float(best_fit), 1e-9), 1.0 - 1e-9) ** ransac_n
            if rnd * batch_size >= math.log1p(-criteria.confidence) / math.log1p(-p_good):
                break
        T, fit, rmse = score_batch()
        better = (fit > best_fit) | ((fit == best_fit) & (rmse < best_rmse))
        best_fit = torch.where(better, fit, best_fit)
        best_rmse = torch.where(better, rmse, best_rmse)
        best_T = torch.where(better, T, best_T)
    return RegistrationResult(
        transformation=best_T,
        fitness=torch.clamp(best_fit, min=0.0),
        inlier_rmse=torch.where(best_fit > 0, best_rmse, 0.0),
        num_iterations=torch.zeros((), dtype=torch.int32, device=dev),
    )


def registration_ransac_based_on_feature_matching(
    source: PointCloud,
    target: PointCloud,
    source_features: torch.Tensor,
    target_features: torch.Tensor,
    max_correspondence_distance: float,
    mutual_filter: bool = True,
    ransac_n: int = 3,
    criteria: RANSACConvergenceCriteria = RANSACConvergenceCriteria(),
    key: Optional[torch.Generator] = None,
) -> RegistrationResult:
    """RANSAC on the (mutual) FPFH matches."""
    corres, valid = feat_mod.correspondences_from_features(
        source_features, target_features, mutual_filter=mutual_filter,
        source_mask=source.mask, target_mask=target.mask,
    )
    return registration_ransac_from_correspondences(
        source, target, corres, valid, max_correspondence_distance,
        ransac_n=ransac_n, criteria=criteria, key=key,
    )


# ---------------------------------------------------------------------------
# Fast Global Registration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FGROption:
    """Open3D's FastGlobalRegistrationOption."""
    division_factor: float = 1.4
    maximum_correspondence_distance: float = 0.025
    iteration_number: int = 64
    tuple_scale: float = 0.95
    maximum_tuple_count: int = 1000
    tuple_test: bool = True


def _tuple_test(src, tgt, corres, valid, scale: float, n_tuples: int, key):
    """Random 3-tuple rigidity test: keep the correspondences that belong
    to at least one tuple whose three edge-length ratios all lie in
    [scale, 1/scale]. `key` is a torch.Generator."""
    order, count = _sample_compaction(valid)
    ids = torch.randint(0, max(int(count), 1), (n_tuples, 3), generator=key, device=key.device)
    cid = order[ids.to(src.device)].to(torch.int64)  # (T, 3) correspondence rows
    p = src[cid]
    q = tgt[torch.clamp(corres, min=0).to(torch.int64)[cid]]

    def edge_ok(a, b):
        dp = torch.linalg.norm(p[:, a] - p[:, b], dim=-1)
        dq = torch.linalg.norm(q[:, a] - q[:, b], dim=-1)
        r = dp / torch.clamp(dq, min=1e-12)
        return (r > scale) & (r < 1.0 / scale)

    passed = edge_ok(0, 1) & edge_ok(1, 2) & edge_ok(2, 0)
    # a row drawn by several tuples is kept if any of them passed (a max,
    # not a last write)
    keep = torch.zeros(valid.shape, dtype=torch.int32, device=src.device).scatter_reduce(
        0, cid.reshape(-1), passed[:, None].expand(cid.shape).reshape(-1).to(torch.int32), "amax")
    return valid & (keep > 0)


def registration_fgr_based_on_feature_matching(
    source: PointCloud,
    target: PointCloud,
    source_features: torch.Tensor,
    target_features: torch.Tensor,
    option: FGROption = FGROption(),
    key: Optional[torch.Generator] = None,
) -> RegistrationResult:
    """Fast Global Registration: mu starts at the squared extent of the
    source and is divided by division_factor every 4 iterations (not below
    the squared maximum correspondence distance); each correspondence gets
    the line-process weight l = (mu / (mu + r^2))^2, and each iteration
    solves a point-to-point Gauss-Newton step."""
    corres, valid = feat_mod.correspondences_from_features(
        source_features, target_features, mutual_filter=True,
        source_mask=source.mask, target_mask=target.mask,
    )
    if option.tuple_test:
        corres_valid = _tuple_test(
            source.positions, target.positions, corres, valid, option.tuple_scale,
            max(option.maximum_tuple_count * 100, 4096), _generator(key, source.positions.device),
        )
        # the mutual set, where the tuple test kept nothing
        corres_valid = torch.where(torch.any(corres_valid), corres_valid, valid)
    else:
        corres_valid = valid

    p = source.positions
    q = target.positions[torch.clamp(corres, min=0).to(torch.int64)]
    w_valid = corres_valid.to(torch.float32)
    dmax2 = option.maximum_correspondence_distance**2
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)

    span = torch.amax(source.get_max_bound() - source.get_min_bound())
    mu = torch.clamp(span * span, min=dmax2)
    T = torch.eye(4, dtype=torch.float32, device=p.device)
    for it in range(option.iteration_number):
        pt = lie.transform_points(T, p)
        r = pt - q  # (N, 3)
        l = (mu / (mu + torch.sum(r * r, dim=-1))) ** 2 * w_valid  # line-process weight
        J = torch.cat([-lie.hat(pt), eye], dim=-1)  # (N, 3, 6): [-[pt]x | I]
        Jw = J * l[:, None, None]
        JtJ = torch.einsum("nai,naj->ij", Jw, J)
        Jtr = torch.einsum("nai,na->i", Jw, r)
        T = lie.se3_exp(linalg.solve_gn_6x6(JtJ, Jtr)) @ T
        if (it + 1) % 4 == 0:
            mu = torch.clamp(_div(mu, option.division_factor), min=dmax2)

    e2 = torch.sum((lie.transform_points(T, p) - q) ** 2, dim=-1)
    inlier = (e2 <= dmax2) & corres_valid
    n_in = inlier.sum().to(torch.float32)
    n_tot = torch.clamp(corres_valid.sum().to(torch.float32), min=1.0)
    return RegistrationResult(
        transformation=T,
        fitness=n_in / n_tot,
        inlier_rmse=torch.sqrt(torch.where(inlier, e2, 0.0).sum() / torch.clamp(n_in, min=1.0)),
        num_iterations=torch.tensor(option.iteration_number, dtype=torch.int32, device=p.device),
    )
