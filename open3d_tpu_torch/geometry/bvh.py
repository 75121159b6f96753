"""Morton-ordered implicit BVH for ray casting and closest-point queries
(port of open3d_tpu/geometry/bvh.py).

The build is the reference's: Morton-30 codes of the triangle centroids,
one stable sort, a complete binary tree over the sorted leaves whose level
boxes are pairwise min / max reductions; padded leaves are far-point boxes
at 3e38. The traversal is the reference's per-ray loop (a fixed-depth
stack, near child first, pruned against the running best), run as one
batched loop over all rays: a lane whose stack is empty or whose step
count reached `max_steps` is frozen by `torch.where`, so each lane ends
where the reference's `while_loop` lane ends. The loop reads whether any
lane is live once every `_CHECK_EVERY` steps, and then drops the finished
lanes from the working set when they are most of it; on the card those
steps replay from a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from open3d_tpu_torch.core.platform import default_device

_INF = 3.0e38
# the traversals read their live lanes every this many steps
_CHECK_EVERY = 16


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 bit spread, in int64 with every step masked
    to 32 bits (the masks fit in 32 bits, so the wrap-around is exact)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(p01: torch.Tensor) -> torch.Tensor:
    """(N, 3) floats in [0, 1] -> 30-bit Morton codes (int32)."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    code = (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])
    return code.to(torch.int32)


class BVH(NamedTuple):
    node_min: torch.Tensor  # (2 * L - 1, 3) f32, heap order, root = 0
    node_max: torch.Tensor  # (2 * L - 1, 3)
    order: torch.Tensor  # (L,) int32 sorted triangle ids (pad = -1)
    n_leaves: int  # L (power of two)
    v0: torch.Tensor  # (L, 3) leaf triangle data, sorted order
    e1: torch.Tensor
    e2: torch.Tensor


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (3), summed left to right, so that a
    tensor on the card and its CPU copy give the same bits."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _sq(x: torch.Tensor) -> torch.Tensor:
    return _dot(x, x)


def build_bvh(vertices, triangles, tri_mask=None, device=None) -> BVH:
    """The tree over `triangles` (T, 3) of `vertices` (V, 3); `tri_mask`
    leaves triangles out. `device` defaults to that of `vertices` when it is
    a tensor, else to the card."""
    dev = vertices.device if device is None and isinstance(vertices, torch.Tensor) \
        else default_device(device)
    verts = torch.as_tensor(vertices, dtype=torch.float32, device=dev)
    tris = torch.as_tensor(triangles, device=dev).to(torch.int64)
    T = tris.shape[0]
    tri_mask = (torch.ones(T, dtype=torch.bool, device=dev) if tri_mask is None
                else torch.as_tensor(tri_mask, dtype=torch.bool, device=dev))
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    cen = (a + b + c) / torch.full((), 3.0, device=dev)
    m = tri_mask[:, None]
    lo = torch.where(m, cen, _INF).amin(0)
    hi = torch.where(m, cen, -_INF).amax(0)
    span = torch.clamp(hi - lo, min=1e-9)
    codes = torch.where(tri_mask, morton3((cen - lo) / span), 0x7FFFFFFF)  # pad to tail
    order = torch.sort(codes, stable=True).indices
    order = torch.where(tri_mask[order], order, -1)

    L = 1 << max(int(np.ceil(np.log2(max(T, 2)))), 1)
    if L > T:
        order = torch.cat([order, order.new_full((L - T,), -1)])
    safe = torch.clamp(order, min=0)
    live = (order >= 0)[:, None]
    # padded leaves are far-away POINT boxes: an empty (inf, -inf) box
    # passes the slab test and would drag every ray through its subtree
    leaf_min = torch.where(live, torch.minimum(torch.minimum(a[safe], b[safe]), c[safe]), _INF)
    leaf_max = torch.where(live, torch.maximum(torch.maximum(a[safe], b[safe]), c[safe]), _INF)
    mins, maxs = [leaf_min], [leaf_max]
    while mins[-1].shape[0] > 1:
        mins.append(mins[-1].reshape(-1, 2, 3).amin(1))
        maxs.append(maxs[-1].reshape(-1, 2, 3).amax(1))
    node_min = torch.cat(mins[::-1], dim=0)  # heap order: root first
    node_max = torch.cat(maxs[::-1], dim=0)
    v0 = torch.where(live, a[safe], 0.0)
    e1 = torch.where(live, b[safe] - a[safe], 0.0)
    e2 = torch.where(live, c[safe] - a[safe], 0.0)
    return BVH(node_min, node_max, order.to(torch.int32), L, v0, e1, e2)


def _slab(o, inv_d, bmin, bmax, t_best):
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tlo = torch.minimum(t1, t2).amax(-1)
    thi = torch.maximum(t1, t2).amin(-1)
    return (thi >= torch.clamp(tlo, min=0.0)) & (tlo < t_best), tlo


def _tri_hit(o, d, v0, e1, e2):
    """Moller-Trumbore; returns (t, u, v) with t = 3e38 on a miss."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    big = det.abs() > 1e-12
    inv = 1.0 / torch.where(big, det, 1e-12)
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    ok = big & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return torch.where(ok, t, _INF), u, v


def _box_d2(p, bmin, bmax):
    return _sq(torch.minimum(torch.maximum(p, bmin), bmax) - p)


def _closest_on_tri(p, a, b, c):
    """Closest point on triangle abc to p (Ericson 5.1.5): the nearest of
    the face point (when the projection lands inside), the three edge
    points and the three corners, the first at a tie."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = vb / denom
    w = vc / denom
    cand_face = a + ab * v[..., None] + ac * w[..., None]
    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0, 1)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0, 1)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-30), 0, 1)
    inside = ((va >= 0) & (vb >= 0) & (vc >= 0))[..., None]
    cands = torch.stack([torch.where(inside, cand_face, 1e30), a + t_ab[..., None] * ab,
                         a + t_ac[..., None] * ac, b + t_bc[..., None] * (c - b), a, b, c],
                        dim=-2)
    best = _sq(cands - p[..., None, :]).argmin(-1)
    return torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]


def _window(bvh: BVH, s: dict, max_steps: int, step) -> dict:
    """`_CHECK_EVERY` traversal steps from the state `s`: the lanes' stack
    (updated in place), stack pointers "sp", step counts "it", and their
    inputs and best-so-far tensors. `step(node, is_leaf, li, c0, c1, s)`
    returns (keep, the best-so-far updates, the children's keys, whether
    each child is worth a visit). A lane whose stack is empty or that took
    `max_steps` steps is frozen. Returns the next state."""
    L = bvh.v0.shape[0]
    n_max = 2 * L - 2
    s = dict(s)
    stack = s["stack"]
    S = stack.shape[1]
    for _ in range(_CHECK_EVERY):
        sp, it = s["sp"], s["it"]
        act = (sp > 0) & (it < max_steps)
        top = torch.clamp(sp - 1, min=0)
        node = stack.gather(1, top[:, None])[:, 0]
        is_leaf = node >= L - 1
        li = torch.clamp(node - (L - 1), 0, L - 1)
        c0 = torch.clamp(2 * node + 1, max=n_max)  # a leaf's are never pushed
        c1 = torch.clamp(2 * node + 2, max=n_max)
        keep, upd, (k0, k1), (h0, h1) = step(node, is_leaf, li, c0, c1, s)
        for k, v in upd.items():
            s[k] = torch.where(act.view(-1, *([1] * (v.dim() - 1))), v, s[k])
        h0 = h0 & keep & ~is_leaf
        h1 = h1 & keep & ~is_leaf
        near_is_0 = k0 <= k1
        near = torch.where(near_is_0, c0, c1)
        far = torch.where(near_is_0, c1, c0)
        h_near = torch.where(near_is_0, h0, h1).to(torch.int64)
        h_far = torch.where(near_is_0, h1, h0).to(torch.int64)
        # pop, push far then near (a write past the top is harmless: the
        # slot is above the stack pointer)
        stack.scatter_(1, torch.clamp(top, max=S - 1)[:, None], far[:, None])
        sp2 = top + h_far
        stack.scatter_(1, torch.clamp(sp2, max=S - 1)[:, None], near[:, None])
        s["sp"] = torch.where(act, sp2 + h_near, sp)
        s["it"] = it + act.to(torch.int64)
    return s


def _capture(bvh: BVH, s: dict, max_steps: int, step) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of one `_window` that advances the state tensors `s` in
    place at each replay: a window is some 2 000 small launches, which the
    card runs far faster replayed than issued one by one."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nxt = _window(bvh, s, max_steps, step)
        for k, v in nxt.items():
            if v is not s[k]:
                s[k].copy_(v)
    return graph


def _traverse(bvh: BVH, state: dict, max_steps: int, step) -> dict:
    """Run `_window`s over every lane of `state` (the lanes' inputs and
    best-so-far tensors) until each lane's stack is empty or it took
    `max_steps` steps; returns `state`'s tensors at the end, in lane order,
    with "steps" (R,), the steps each lane took. After each window the
    finished lanes leave the working set once they are three quarters of
    it. On the card a window is replayed from a CUDA graph, captured anew
    for each working set after one window run as it is: a capture costs
    about three windows' launches, and a frozen lane little, so the set
    shrinks rarely."""
    L = bvh.v0.shape[0]
    R = next(iter(state.values())).shape[0]
    dev = bvh.v0.device
    out = {k: v.clone() for k, v in state.items()}
    out["steps"] = torch.zeros(R, dtype=torch.int64, device=dev)
    lane = torch.arange(R, device=dev)
    s = {**state, "stack": torch.zeros((R, 2 * (int(np.log2(L)) + 2) + 4), dtype=torch.int64,
                                       device=dev),
         "sp": torch.ones(R, dtype=torch.int64, device=dev),
         "it": torch.zeros(R, dtype=torch.int64, device=dev)}
    graph = None
    while True:
        if graph is not None:
            graph.replay()
        else:
            s = _window(bvh, s, max_steps, step)
            if dev.type == "cuda":
                graph = _capture(bvh, s, max_steps, step)
        for k in state:
            out[k][lane] = s[k]
        out["steps"][lane] = s["it"]
        live = (s["sp"] > 0) & (s["it"] < max_steps)
        n_live = int(live.sum())
        if n_live == 0:
            return out
        if n_live * 4 <= lane.numel():
            lane = lane[live]
            s = {k: v[live] for k, v in s.items()}
            graph = None
def cast_rays(bvh: BVH, origins, directions, max_steps: int = 2048):
    """(R, 3) origins / directions -> (t_hit (R,), prim_id (R,), uv (R, 2));
    t_hit = 3e38 and prim_id = -1 on a miss."""
    dev = bvh.v0.device
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
    R = o.shape[0]
    inv_d = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    order = bvh.order.to(torch.int64)

    def step(node, is_leaf, li, c0, c1, s):
        o, d, inv_d, t_best = s["o"], s["d"], s["inv_d"], s["t"]
        keep, _ = _slab(o, inv_d, bvh.node_min[node], bvh.node_max[node], t_best)
        t, u, v = _tri_hit(o, d, bvh.v0[li], bvh.e1[li], bvh.e2[li])
        take = keep & is_leaf & (t < t_best) & (order[li] >= 0)
        t_best = torch.where(take, t, t_best)
        upd = {"t": t_best, "i": torch.where(take, order[li], s["i"]),
               "uv": torch.where(take[:, None], torch.stack([u, v], -1), s["uv"])}
        h0, t0 = _slab(o, inv_d, bvh.node_min[c0], bvh.node_max[c0], t_best)
        h1, t1 = _slab(o, inv_d, bvh.node_min[c1], bvh.node_max[c1], t_best)
        return keep, upd, (t0, t1), (h0, h1)

    state = {"o": o, "d": d, "inv_d": inv_d,
             "t": torch.full((R,), _INF, device=dev),
             "i": torch.full((R,), -1, dtype=torch.int64, device=dev),
             "uv": torch.zeros((R, 2), device=dev)}
    out = _traverse(bvh, state, max_steps, step)
    return out["t"], out["i"].to(torch.int32), out["uv"]


def closest_points(bvh: BVH, queries, max_steps: int = 4096):
    """(Q, 3) -> (points (Q, 3), prim_id (Q,), dist (Q,))."""
    dev = bvh.v0.device
    p = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    Q = p.shape[0]
    order = bvh.order.to(torch.int64)

    def step(node, is_leaf, li, c0, c1, s):
        p, best_d2 = s["p"], s["d2"]
        keep = _box_d2(p, bvh.node_min[node], bvh.node_max[node]) < best_d2
        v0 = bvh.v0[li]
        cp = _closest_on_tri(p, v0, v0 + bvh.e1[li], v0 + bvh.e2[li])
        d2 = _sq(cp - p)
        take = keep & is_leaf & (d2 < best_d2) & (order[li] >= 0)
        best_d2 = torch.where(take, d2, best_d2)
        upd = {"d2": best_d2, "pt": torch.where(take[:, None], cp, s["pt"]),
               "i": torch.where(take, order[li], s["i"])}
        d20 = _box_d2(p, bvh.node_min[c0], bvh.node_max[c0])
        d21 = _box_d2(p, bvh.node_min[c1], bvh.node_max[c1])
        return keep, upd, (d20, d21), (d20 < best_d2, d21 < best_d2)

    state = {"p": p, "d2": torch.full((Q,), _INF, device=dev),
             "pt": torch.zeros((Q, 3), device=dev),
             "i": torch.full((Q,), -1, dtype=torch.int64, device=dev)}
    out = _traverse(bvh, state, max_steps, step)
    return out["pt"], out["i"].to(torch.int32), torch.sqrt(out["d2"])
