"""Mesh-sharded point-cloud operations on the points axis: ring kNN,
distributed ICP (point-to-point, point-to-plane, GICP, batched), the
distributed Morton sort with the sharded window normals, the sharded
voxel and outlier filters, and the sharded FPFH → matching → RANSAC
chain.

Counterpart of the points-axis part of ``threecrate_tpu.parallel
.sharded``, with its names, signatures and defaults. Every
``make_sharded_*`` takes a :class:`~.mesh.Mesh` and returns a callable
(``collectives.shard_map``): point arguments are ``Sharded`` values on
the points axis, or tensors / arrays split as JAX reshards an unsharded
array; sharded outputs come back as ``Sharded``, replicated ones as
tensors on the mesh's first device. The ``*_local`` building blocks are
bodies over the shards: each argument is a list with one tensor a shard,
and they take the mesh as the keyword ``mesh``.

Neighbour search against a sharded database is a ring pass, as in JAX:
each shard keeps its queries and the database shards rotate one step at
a time (``collectives.ppermute``), each step merging a (queries ×
database shard) tile of squared distances ‖q‖² + ‖p‖² − 2 q·p (the
product as ``ops.neighbors._cross`` forms it) into a running top-k whose
order is ``lax.top_k``'s: by value, ties to the earlier candidate.
Global reductions (Kabsch moments, normal equations, MSE, outlier
statistics) are ``psum``. The JAX ``while_loop``s run on the host: each
iteration reads the reduced moments back as one small tensor per group
of the axis (one host sync an iteration on a 1-D mesh), solves the 3x3
SVD or the 6x6 system there and sends the pose back, as the port's
single-device ICP does.

One departure from the reference: its odd-even block sort merges
``[own, received]``, so where equal keys straddle a pair's boundary both
partners keep the same rows and others are lost (a row of the sorted
cloud then carries another row's ``gid``). Here both partners merge
``[lower block, upper block]`` with a stable sort, so every round is a
permutation and the result equals the stable sort of the input by key;
on keys without ties the two agree bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.transform import se3_exp
from ..ops import linalg, morton, neighbors, segmented
from ..ops.registration import _limits, _pose_to
from .collectives import (all_gather, axis_index, axis_size, pmax, pmin, ppermute,
                          psum, shard_map)
from .mesh import POINTS_AXIS, Mesh, P, Sharded

_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# ring building blocks (bodies over the shards of one mesh axis)
# ---------------------------------------------------------------------------

def _ring_perm(nd: int):
    return [(i, (i + 1) % nd) for i in range(nd)]


def _sq_norms(x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """‖x‖² per row. On the CPU with ``fused``, a chain of fused
    multiply-adds over the columns in order, formed as
    ``neighbors._cross`` forms its product: the bits XLA:CPU gives
    ``sum(x * x, -1)`` on 3-d rows where it fuses the reduction into the
    distance tile, so the ring's d² of a point pair is mostly the JAX
    package's (a self pair's d² is rounding noise, which FPFH's 1/d
    weight magnifies). The JAX top-1 ring forms its query norms before
    its loop, as a plain sum. On the card a plain sum."""
    if x.device.type != "cpu" or not fused:
        return (x * x).sum(-1)
    xd = x.to(torch.float64)
    acc = (xd[:, 0] * xd[:, 0]).to(torch.float32)
    for r in range(1, x.shape[1]):
        acc = torch.addcmul(acc.to(torch.float64), xd[:, r], xd[:, r]).to(torch.float32)
    return acc


def _neg_d2(q, qn, db, db_mask, clamp=True):
    """−d² of the (queries × database shard) tile, −inf at masked columns.
    ``clamp`` clamps d² at 0 first, as the top-k ring does (the top-1
    match ring compares the unclamped values)."""
    pn = _sq_norms(db)
    d2 = qn[:, None] + pn[None, :] - 2.0 * neighbors._cross(q, db)
    if clamp:
        d2 = torch.clamp_min(d2, 0.0)
    return torch.where(db_mask[None, :], -d2, -torch.inf)


def _tile_topk(neg, k):
    """The k best columns of each row of ``neg`` ordered by value, ties to
    the lower column (the order of ``lax.top_k``), as (values, columns).
    The value's order-preserving int32 image and the reversed column pack
    into one int64 key, so the top-k has no ties and needs no sort of the
    whole row."""
    n_col = neg.shape[1]
    k = min(k, n_col)
    if k == 1:
        col = neg.argmax(1, keepdim=True)       # the first maximal column
        return torch.gather(neg, 1, col), col
    bits = neg.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    cols = torch.arange(n_col - 1, -1, -1, device=neg.device, dtype=torch.int64)
    key = (ordered << 32) + cols[None, :]
    top = torch.topk(key, k, dim=1).values
    col = (n_col - 1) - (top & 0xFFFFFFFF)
    return torch.gather(neg, 1, col), col


def _ring_topk(q, db, db_mask, payloads, k, mesh, axis_name):
    """The top-k ring: per shard (−d² (Qs, k), [rows of each payload
    (Qs, k, E)], global row ids (Qs, k) int64), merged step by step as
    ``lax.top_k`` over [best, tile] (a stable descending sort of the
    running best and the tile's own best k)."""
    nd = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    perm = _ring_perm(nd)
    s = db[0].shape[0]
    qn = [_sq_norms(x) for x in q]
    best = []
    for i, x in enumerate(q):
        pay0 = [torch.zeros((x.shape[0], k) + p[i].shape[1:], dtype=torch.float32,
                            device=x.device) for p in payloads]
        best.append((torch.full((x.shape[0], k), -torch.inf, device=x.device), pay0,
                     torch.zeros((x.shape[0], k), dtype=torch.int64, device=x.device)))
    cur_db, cur_mask, cur_pay = db, db_mask, list(payloads)
    for step in range(nd):
        for i in range(len(q)):
            neg = _neg_d2(q[i], qn[i], cur_db[i], cur_mask[i])
            t_val, t_col = _tile_topk(neg, k)
            b_neg, b_pay, b_idx = best[i]
            vals, pos = torch.sort(torch.cat([b_neg, t_val], 1), dim=1, descending=True,
                                   stable=True)
            vals, pos = vals[:, :k], pos[:, :k]
            src = (me[i] - step) % nd
            ids = torch.gather(torch.cat([b_idx, t_col + src * s], 1), 1, pos)
            pays = []
            for bp, cp in zip(b_pay, cur_pay):
                cand = torch.cat([bp, cp[i][t_col]], 1)
                pays.append(torch.gather(cand, 1, pos.view(pos.shape + (1,) * (cand.ndim - 2))
                                         .expand(pos.shape + cand.shape[2:])))
            best[i] = (vals, pays, ids)
            del neg
        if step + 1 < nd:
            cur_db = ppermute(cur_db, mesh, axis_name, perm)
            cur_mask = ppermute(cur_mask, mesh, axis_name, perm)
            cur_pay = [ppermute(p, mesh, axis_name, perm) for p in cur_pay]
    return best


def ring_knn_local(q, db_shard, db_mask_shard, k, axis_name=POINTS_AXIS, *, mesh):
    """Ring all-shards kNN. q: per shard (Qs, 3) queries; db_shard: per
    shard (Ns, 3) database rows. Returns per shard lists (neg_sq_dist
    (Qs, k), matched points (Qs, k, 3), global indices (Qs, k) int64)."""
    best = _ring_topk(q, db_shard, db_mask_shard, [db_shard], k, mesh, axis_name)
    return ([b[0] for b in best], [b[1][0] for b in best], [b[2] for b in best])


def ring_knn_payload_local(q, db_shard, db_mask_shard, payload_shard, k,
                           axis_name: str = POINTS_AXIS, *, mesh):
    """Ring kNN carrying an (S, E) payload per database row through the
    merge (neighbour normals for FPFH, target coordinates for descriptor
    matching); any row width. Returns per shard lists (neg_sq_dist
    (Q, k), db rows (Q, k, D), payload (Q, k, E), global ids (Q, k))."""
    best = _ring_topk(q, db_shard, db_mask_shard, [db_shard, payload_shard], k, mesh,
                      axis_name)
    return ([b[0] for b in best], [b[1][0] for b in best], [b[1][1] for b in best],
            [b[2] for b in best])


def ring_match1_local(q, db_shard, db_mask_shard, payload_shard,
                      axis_name: str = POINTS_AXIS, *, mesh):
    """Top-1 ring match carrying an (Ns, E) payload per database row
    (target normals, 6 covariance columns) through the same argmax. The
    tile's −d² is not clamped, as in JAX; a tile replaces the running
    best only where its best is strictly larger. Returns per shard lists
    (neg_sq_dist (Qs,), matched points (Qs, 3), payload (Qs, E))."""
    nd = axis_size(mesh, axis_name)
    perm = _ring_perm(nd)
    qn = [_sq_norms(x, False) for x in q]
    best = [(torch.full((x.shape[0],), -torch.inf, device=x.device),
             torch.zeros((x.shape[0], 3), device=x.device),
             torch.zeros((x.shape[0], p.shape[1]), device=x.device))
            for x, p in zip(q, payload_shard)]
    cur_db, cur_mask, cur_pay = db_shard, db_mask_shard, payload_shard
    for step in range(nd):
        for i in range(len(q)):
            neg = _neg_d2(q[i], qn[i], cur_db[i], cur_mask[i], clamp=False)
            tile_best = neg.amax(1)
            arg = neg.argmax(1)     # the first maximal column
            b_neg, b_pts, b_pay = best[i]
            better = tile_best > b_neg
            best[i] = (torch.where(better, tile_best, b_neg),
                       torch.where(better[:, None], cur_db[i][arg], b_pts),
                       torch.where(better[:, None], cur_pay[i][arg], b_pay))
            del neg
        if step + 1 < nd:
            cur_db = ppermute(cur_db, mesh, axis_name, perm)
            cur_mask = ppermute(cur_mask, mesh, axis_name, perm)
            cur_pay = ppermute(cur_pay, mesh, axis_name, perm)
    return [b[0] for b in best], [b[1] for b in best], [b[2] for b in best]


def ring_gather_rows_local(ids, table_shard, axis_name: str = POINTS_AXIS, *, mesh):
    """Gather GLOBAL rows of a points-sharded table: per shard (Q, k)
    global ids → (Q, k, E) rows, one ring rotation of the table."""
    nd = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    perm = _ring_perm(nd)
    s = table_shard[0].shape[0]
    out = [torch.zeros(i.shape + table_shard[0].shape[1:], dtype=table_shard[0].dtype,
                       device=i.device) for i in ids]
    cur = table_shard
    for step in range(nd):
        for i in range(len(ids)):
            loc = ids[i] - ((me[i] - step) % nd) * s
            inb = (loc >= 0) & (loc < s)
            rows = cur[i][loc.clamp(0, s - 1)]
            out[i] = torch.where(inb[..., None], rows, out[i])
        if step + 1 < nd:
            cur = ppermute(cur, mesh, axis_name, perm)
    return out


def global_stats_local(values, mask, axis_name=POINTS_AXIS, *, mesh):
    """Distributed mean / σ of a masked per-point quantity (one psum each
    for the count, the sum and the squared deviations). Returns per shard
    lists (mu, sigma) of () tensors."""
    cnt = psum([m.to(torch.float32).sum() for m in mask], mesh, axis_name)
    cnt = [torch.clamp_min(c, 1.0) for c in cnt]
    tot = psum([torch.where(m, v, 0.0).sum() for v, m in zip(values, mask)], mesh,
               axis_name)
    mu = [t / c for t, c in zip(tot, cnt)]
    dev = psum([torch.where(m, (v - u) ** 2, 0.0).sum()
                for v, m, u in zip(values, mask, mu)], mesh, axis_name)
    return mu, [torch.sqrt(d / c) for d, c in zip(dev, cnt)]


# ---------------------------------------------------------------------------
# the host loops of the ICP family
# ---------------------------------------------------------------------------

def _host(xs, mesh, axis_name):
    """One host copy per group of the axis, of the group's first shard
    (every shard of a group holds the same bits)."""
    return [xs[g[0]].cpu() for g in mesh.axis_groups(axis_name)]


def _per_shard(values, mesh, axis_name):
    """Per-group values → per-shard list."""
    out = [None] * mesh.size
    for v, g in zip(values, mesh.axis_groups(axis_name)):
        for i in g:
            out[i] = v
    return out


def _host_loop(mesh, axis_name, init, max_iterations, step, converged):
    """The JAX ``while_loop`` per group of the axis, on the host. ``init``
    is a per-group list of (4, 4) poses; ``step(poses per shard)`` returns
    per group host tensors (delta (4, 4), mse, criterion), and
    ``converged(criterion, previous criterion or None)`` ends a group's
    loop. A finished group stops updating while the others go on, as
    JAX's batched ``while_loop`` does. Returns per group lists (pose,
    mse, iterations, converged)."""
    n_g = len(init)
    pose = [t.to(torch.float32).cpu() for t in init]
    mse = [torch.tensor(math.inf)] * n_g
    crit = [None] * n_g
    it = [0] * n_g
    conv = [False] * n_g
    while any(i < max_iterations and not c for i, c in zip(it, conv)):
        results = step(_per_shard(pose, mesh, axis_name))
        for g in range(n_g):
            if it[g] >= max_iterations or conv[g]:
                continue
            delta, mse[g], c = results[g]
            pose[g] = linalg.fp32_matmul(delta, pose[g])
            conv[g] = converged(c, crit[g])
            crit[g] = c
            it[g] += 1
    return pose, mse, it, conv


def _host_const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small host value on ``device``; on the card the copy leaves from
    pinned memory without blocking, so it costs no host sync."""
    return _pose_to(torch.as_tensor(values, dtype=dtype), device)


def _replicated(mesh, axis_name, like, pose, mse, it, conv):
    """Per-group host results → per-shard lists of device tensors (pose
    (4, 4), mse (), iterations () int32, converged () bool)."""
    devs = [x.device for x in like]
    pose, mse, it, conv = (_per_shard(v, mesh, axis_name) for v in (pose, mse, it, conv))
    return ([_host_const(p, d) for p, d in zip(pose, devs)],
            [_host_const(m, d) for m, d in zip(mse, devs)],
            [_host_const(i, d, torch.int32) for i, d in zip(it, devs)],
            [_host_const(c, d, torch.bool) for c, d in zip(conv, devs)])


def _mse_converged(thresh):
    thresh = torch.tensor(thresh, dtype=torch.float32)
    inf = torch.tensor(math.inf)
    return lambda c, prev: bool(torch.abs(c - (inf if prev is None else prev)) < thresh)


def _icp_moments(src, src_mask, tgt, tgt_mask, t_dev, max_corr_dist, axis_name, mesh):
    """One point-to-point iteration on the device: the ring top-1, then
    the Kabsch moments reduced in two psum passes (means, then the cross
    covariance about them). Per shard (17,) [μs, μt, H (9), Σw, mse,
    n_corr]."""
    moved = [linalg.transform_points(t, s) for t, s in zip(t_dev, src)]
    neg, pts, _ = ring_knn_local(moved, tgt, tgt_mask, 1, axis_name, mesh=mesh)
    dist = [torch.sqrt(torch.clamp_min(-n[:, 0], 0.0)) for n in neg]
    ok = [torch.isfinite(d) & m & (d <= max_corr_dist) for d, m in zip(dist, src_mask)]
    w = [o.to(torch.float32) for o in ok]
    matched = [p[:, 0] for p in pts]
    wsum = [torch.clamp_min(x, 1e-12) for x in psum([x.sum() for x in w], mesh, axis_name)]
    mu_s = [x / ws for x, ws in zip(psum([(m * x[:, None]).sum(0)
                                          for m, x in zip(moved, w)], mesh, axis_name), wsum)]
    mu_t = [x / ws for x, ws in zip(psum([(m * x[:, None]).sum(0)
                                          for m, x in zip(matched, w)], mesh, axis_name), wsum)]
    h = psum([linalg.fp32_matmul(((m - ms) * x[:, None]).T, t - mt)
              for m, t, x, ms, mt in zip(moved, matched, w, mu_s, mu_t)], mesh, axis_name)
    sq = psum([torch.where(o, d * d, 0.0).sum() for o, d in zip(ok, dist)], mesh, axis_name)
    n_corr = psum([o.to(torch.int32).sum() for o in ok], mesh, axis_name)
    return [torch.cat([a, b, c.reshape(9), ws[None], (q / ws)[None],
                       nc.to(torch.float32)[None]])
            for a, b, c, ws, q, nc in zip(mu_s, mu_t, h, wsum, sq, n_corr)]


def icp_sharded_step(src, src_mask, tgt, tgt_mask, t_mat, max_corr_dist,
                     axis_name=POINTS_AXIS, *, mesh):
    """One distributed ICP iteration: ring top-1 correspondence + psum
    Kabsch. ``t_mat`` is a per-shard list of (4, 4) poses. Returns per
    shard lists (delta (4, 4), mse (), n_corr ()) on the host, one copy a
    group."""
    t_dev = [_pose_to(t.to(torch.float32), s.device) for t, s in zip(t_mat, src)]
    mcd = _limits(max_corr_dist)[0]
    host = _host(_icp_moments(src, src_mask, tgt, tgt_mask, t_dev, mcd, axis_name, mesh),
                 mesh, axis_name)
    out = [(linalg.kabsch_from_moments(h[:15]), h[16], h[17].to(torch.int32))
           for h in host]
    return tuple(_per_shard([o[j] for o in out], mesh, axis_name) for j in range(3))


def icp_sharded_loop(src, src_mask, tgt, tgt_mask, init, max_iterations,
                     conv_thresh, max_corr_dist, axis_name=POINTS_AXIS, *, mesh):
    """Full distributed ICP loop: ``icp_sharded_step`` until |ΔMSE| <
    ``conv_thresh`` or ``max_iterations``. ``init`` is a (4, 4) pose or a
    per-shard list of them. Returns per shard lists (pose (4, 4), mse (),
    iterations (), converged ()) on each shard's device."""
    groups = mesh.axis_groups(axis_name)
    init = list(init) if isinstance(init, (list, tuple)) else [init] * mesh.size

    def step(poses):
        delta, mse, _ = icp_sharded_step(src, src_mask, tgt, tgt_mask, poses, max_corr_dist,
                                         axis_name, mesh=mesh)
        return [(delta[g[0]], mse[g[0]], mse[g[0]]) for g in groups]

    res = _host_loop(mesh, axis_name, [init[g[0]] for g in groups], max_iterations, step,
                     _mse_converged(conv_thresh))
    return _replicated(mesh, axis_name, src, *res)


# ---------------------------------------------------------------------------
# entry points over a Mesh
# ---------------------------------------------------------------------------

def _f32(xs):
    return [x.to(torch.float32) for x in xs]


def _bool(xs):
    return [x.to(torch.bool) for x in xs]


def _eye_per_group(mesh, axis_name):
    return [torch.eye(4)] * len(mesh.axis_groups(axis_name))


def _solve_step(host, negate=False):
    """Host (44,) [H (36), g (6), Σw, Σ squared residuals] → (se3_exp(ξ),
    mse, |ξ|) with ξ = ±solve_psd(H, g) (damping 1e-6)."""
    xi = linalg.solve_psd(host[:36].reshape(6, 6), host[36:42], damping=1e-6)
    if negate:
        xi = -xi
    mse = host[43] / torch.clamp_min(host[42], 1.0)
    return se3_exp(xi), mse, torch.linalg.vector_norm(xi)


def make_sharded_icp_p2plane(mesh: Mesh, max_iterations: int = 20,
                             convergence_threshold: float = 1e-6,
                             max_correspondence_distance: float = math.inf,
                             axis_name: str = POINTS_AXIS):
    """Distributed point-to-plane ICP: ring correspondence with the target
    normals as payload, psum-reduced Chen & Medioni 6x6 normal equations.
    Inputs: src, mask, tgt, mask, tgt_normals, all sharded on axis 0.
    Returns (transform, mse, iterations, converged), replicated."""
    spec = P(axis_name)
    mcd = _limits(max_correspondence_distance)[0]

    def body(src, src_mask, tgt, tgt_mask, tgt_normals):
        src, tgt, nrm = _f32(src), _f32(tgt), _f32(tgt_normals)
        src_mask, tgt_mask = _bool(src_mask), _bool(tgt_mask)

        def step(poses):
            moved = [linalg.transform_points(_pose_to(t, s.device), s)
                     for t, s in zip(poses, src)]
            neg, pts, n_m = ring_match1_local(moved, tgt, tgt_mask, nrm, axis_name,
                                              mesh=mesh)
            packs = []
            for mv, ng, pt, nm, sm in zip(moved, neg, pts, n_m, src_mask):
                dist = torch.sqrt(torch.clamp_min(-ng, 0.0))
                ok = torch.isfinite(dist) & sm & (dist <= mcd)
                w = ok.to(torch.float32)
                r = ((mv - pt) * nm).sum(1)
                a = torch.cat([torch.linalg.cross(mv, nm), nm], 1)
                aw = a * w[:, None]
                packs.append(torch.cat([
                    linalg.fp32_matmul(aw.T, a).reshape(36),
                    -linalg.fp32_matmul(aw.T, r[:, None])[:, 0],
                    w.sum()[None], torch.where(ok, r * r, 0.0).sum()[None]]))
            return [_solve_step(h) for h in _host(psum(packs, mesh, axis_name), mesh,
                                                   axis_name)]

        res = _host_loop(mesh, axis_name, _eye_per_group(mesh, axis_name), max_iterations,
                         step, _mse_converged(convergence_threshold))
        return _replicated(mesh, axis_name, src, *res)

    return shard_map(body, mesh, (spec,) * 5, (P(),) * 4)


def make_sharded_gicp(mesh: Mesh, max_iterations: int = 30,
                      convergence_threshold: float = 1e-6,
                      max_correspondence_distance: float = math.inf,
                      k_covariances: int = 20,
                      axis_name: str = POINTS_AXIS):
    """Distributed GICP: per-point covariances from the ring kNN
    (``k_covariances`` neighbours, + 1e-4·I), then a Gauss-Newton loop
    whose correspondence carries the matched target's 6 covariance columns
    through the ring and whose 6x6 system psum-reduces; it stops when
    |ξ| < ``convergence_threshold``. Inputs: src, mask, tgt, mask sharded;
    returns (transform, mse, iterations, converged) replicated."""
    from ..ops.gicp import (_cols_to_cov, _cov_to_cols, _normal_equations, _rotate_cov,
                            inv3x3)

    spec = P(axis_name)
    mcd = _limits(max_correspondence_distance)[0]
    thresh = torch.tensor(convergence_threshold, dtype=torch.float32)

    def shard_covariances(pts, mask):
        neg, nbr, _ = ring_knn_local(pts, pts, mask, k_covariances, axis_name, mesh=mesh)
        covs, oks = [], []
        for ng, nb, m in zip(neg, nbr, mask):
            okn = torch.isfinite(ng)
            _, cov = linalg.weighted_covariance(nb, okn.to(torch.float32))
            covs.append(cov + 1e-4 * torch.eye(3, device=cov.device))
            oks.append(m & (okn.sum(1) >= 4))
        return covs, oks

    def body(src, src_mask, tgt, tgt_mask):
        src, tgt = _f32(src), _f32(tgt)
        src_cov, src_ok = shard_covariances(src, _bool(src_mask))
        tgt_cov, tgt_ok = shard_covariances(tgt, _bool(tgt_mask))
        tgt_cols = [_cov_to_cols(c) for c in tgt_cov]

        def step(poses):
            t_dev = [_pose_to(t, s.device) for t, s in zip(poses, src)]
            moved = [linalg.transform_points(t, s) for t, s in zip(t_dev, src)]
            neg, pts, cols = ring_match1_local(moved, tgt, tgt_ok, tgt_cols, axis_name,
                                               mesh=mesh)
            packs = []
            for t, mv, ng, pt, cl, cs, so in zip(t_dev, moved, neg, pts, cols, src_cov,
                                                  src_ok):
                dist = torch.sqrt(torch.clamp_min(-ng, 0.0))
                ok = torch.isfinite(dist) & so & (dist <= mcd)
                w = ok.to(torch.float32)
                m = _cols_to_cov(cl.T) + _rotate_cov(t[:3, :3], cs)
                r = mv - pt
                h, g = _normal_equations(mv, r, inv3x3(m) * w[:, None, None])
                packs.append(torch.cat([h.reshape(36), g, w.sum()[None],
                                        torch.where(ok, (r * r).sum(1), 0.0).sum()[None]]))
            return [_solve_step(h, negate=True)
                    for h in _host(psum(packs, mesh, axis_name), mesh, axis_name)]

        res = _host_loop(mesh, axis_name, _eye_per_group(mesh, axis_name), max_iterations,
                         step, lambda c, prev: bool(c < thresh))
        return _replicated(mesh, axis_name, src, *res)

    return shard_map(body, mesh, (spec,) * 4, (P(),) * 4)


def make_sharded_icp(mesh: Mesh, max_iterations: int = 20,
                     convergence_threshold: float = 1e-6,
                     max_correspondence_distance: float = math.inf,
                     axis_name: str = POINTS_AXIS):
    """Distributed point-to-point ICP over ``mesh``. Inputs: src, mask,
    tgt, mask sharded on axis 0; returns (transform (4, 4), mse,
    iterations, converged), replicated."""
    spec = P(axis_name)

    def body(src, src_mask, tgt, tgt_mask):
        return icp_sharded_loop(_f32(src), _bool(src_mask), _f32(tgt), _bool(tgt_mask),
                                torch.eye(4), max_iterations, convergence_threshold,
                                max_correspondence_distance, axis_name, mesh=mesh)

    return shard_map(body, mesh, (spec,) * 4, (P(),) * 4)


def make_sharded_batch_icp(mesh: Mesh, max_iterations: int = 20,
                           convergence_threshold: float = 1e-6,
                           max_correspondence_distance: float = math.inf,
                           batch_axis: str = "batch",
                           points_axis: str = POINTS_AXIS):
    """Composed parallelism on a 2-D (batch × points) mesh: cloud pairs
    shard over ``batch_axis``, each pair's points over ``points_axis``
    (ring correspondence and psum within a row of the mesh). Inputs:
    src / tgt (B, N, 3) and masks (B, N) sharded (batch, points); returns
    per-pair (B, 4, 4) transforms, mse, iterations and converged flags,
    sharded on the batch axis. JAX's ``vmap`` over a shard's pairs is a
    loop here, each pair's iterations its own."""
    spec_in = P(batch_axis, points_axis)

    def body(src, src_mask, tgt, tgt_mask):
        src, tgt, src_mask, tgt_mask = _f32(src), _f32(tgt), _bool(src_mask), _bool(tgt_mask)
        per_pair = [icp_sharded_loop([s[j] for s in src], [m[j] for m in src_mask],
                                     [t[j] for t in tgt], [m[j] for m in tgt_mask],
                                     torch.eye(4), max_iterations, convergence_threshold,
                                     max_correspondence_distance, points_axis, mesh=mesh)
                    for j in range(src[0].shape[0])]
        return tuple([torch.stack([pair[o][i] for pair in per_pair])
                      for i in range(mesh.size)] for o in range(4))

    return shard_map(body, mesh, (spec_in,) * 4, (P(batch_axis),) * 4)


def make_sharded_knn(mesh: Mesh, k: int, axis_name: str = POINTS_AXIS):
    """Ring kNN with queries and database both sharded over the mesh.
    Returns (distances (Q, k), global indices (Q, k) int32) sharded like
    the queries."""
    spec = P(axis_name)

    def body(q, db, db_mask):
        neg, _, idx = ring_knn_local(_f32(q), _f32(db), _bool(db_mask), k, axis_name,
                                     mesh=mesh)
        return ([torch.sqrt(torch.clamp_min(-n, 0.0)) for n in neg],
                [i.to(torch.int32) for i in idx])

    return shard_map(body, mesh, (spec,) * 3, (spec, spec))


def make_sharded_normals(mesh: Mesh, k: int = 10,
                         viewpoint=(0.0, 0.0, 0.0),
                         orient: bool = True,
                         axis_name: str = POINTS_AXIS):
    """Distributed normal estimation over a points-sharded cloud: a k+1
    ring kNN over the cloud itself (the self match takes one column), then
    the local PCA of the exact path per shard. Returns unit normals
    (N, 3) sharded like the input, 0 where masked or degenerate."""
    from ..ops.normals import _pca_normals

    spec = P(axis_name)

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        neg, nbr, _ = ring_knn_local(pts, pts, mask, k + 1, axis_name, mesh=mesh)
        out = []
        for p, m, ng, nb in zip(pts, mask, neg, nbr):
            ok = ng > -torch.inf
            vp = _host_const(viewpoint, p.device)
            normal, _ = _pca_normals(nb, ok, p, vp, orient)
            out.append(torch.where((m & (ok.sum(1) >= 3))[:, None], normal, 0.0))
        return out

    return shard_map(body, mesh, (spec, spec), spec)


# ---------------------------------------------------------------------------
# the distributed Morton sort and the sharded window normals
# ---------------------------------------------------------------------------

def morton_presort(points, mask, n_devices: int, tile: int = 256):
    """Host-side prep for the presorted sharded-normals path: a stable
    Morton sort (pass 0) of the whole cloud, padded so every shard is a
    contiguous slice of the sorted order with size % tile == 0. Returns
    numpy (points (N', 3), mask (N',), perm (N',)) with perm the input row
    of each sorted row (-1 for padding). The keys are formed on the
    tensor's device (numpy input: the CPU)."""
    pts = torch.as_tensor(points).to(torch.float32)
    m = torch.as_tensor(mask).to(device=pts.device, dtype=torch.bool)
    keys = morton.morton_keys(pts, m, pass_index=0)
    order = torch.sort(keys, stable=True).indices.cpu().numpy()
    pts_np = pts.cpu().numpy()[order]
    m_np = m.cpu().numpy()[order]
    n = pts_np.shape[0]
    unit = n_devices * tile
    pad = (n + unit - 1) // unit * unit - n
    pts_np = np.pad(pts_np, ((0, pad), (0, 0)))
    m_np = np.pad(m_np, (0, pad))
    perm = np.pad(order.astype(np.int32), (0, pad), constant_values=-1)
    return pts_np, m_np, perm


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by ``keys[0]``, then ``keys[1]``, ...
    stably (ties keep row order): one stable sort per key, last key
    first."""
    perm = torch.sort(keys[-1], stable=True).indices
    for key in reversed(keys[:-1]):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _local_sort(operands, num_keys=1):
    """Sort every shard's operands by the first ``num_keys`` of them."""
    out = [list(o) for o in operands]
    for i in range(len(out[0])):
        order = _lexsort([o[i] for o in out[:num_keys]])
        for o in out:
            o[i] = o[i][order]
    return tuple(out)


def _oddeven_block_sort(operands, axis_name: str, n_dev: int, num_keys: int = 1, *,
                        mesh):
    """Globally sort equal-size sorted shard blocks over the mesh axis by
    block odd-even transposition: ``n_dev`` rounds, each pairing
    neighbours (0-1, 2-3, ... then 1-2, 3-4, ...); a pair's merge-split
    keeps the lower half of the merged 2s rows on the lower partner and
    the upper half on the upper one. Both halves come from one stable
    sort of [lower block, upper block] by the keys (run on the lower
    partner's device, the upper half sent back), so every round is a
    permutation and the result is the stable sort of the input order.
    ``operands`` is a sequence of per-shard lists, the first ``num_keys``
    the keys; each shard's operands must be sorted already."""
    devs = mesh.device_list
    ops = [list(o) for o in operands]
    s = ops[0][0].shape[0]
    for r in range(n_dev):
        pairs = [(i, i + 1) for i in range(r % 2, n_dev - 1, 2)]
        for group in mesh.axis_groups(axis_name):
            for lo, hi in pairs:
                a, b = group[lo], group[hi]
                merged = [torch.cat([o[a], o[b].to(devs[a])]) for o in ops]
                order = _lexsort(merged[:num_keys])
                for o, mg in zip(ops, merged):
                    srt = mg[order]
                    o[a], o[b] = srt[:s], srt[s:].to(devs[b])
    return tuple(ops)


def _frame_keys(pts, mask, pass_index, axis_name, mesh):
    """Morton keys of every shard in the frame of the whole masked cloud
    (its min and extent a pmin / pmax over the axis)."""
    mn = pmin([torch.where(m[:, None], p, torch.inf).amin(0) for p, m in zip(pts, mask)],
              mesh, axis_name)
    mx = pmax([torch.where(m[:, None], p, -torch.inf).amax(0) for p, m in zip(pts, mask)],
              mesh, axis_name)
    out = []
    for p, m, lo, hi in zip(pts, mask, mn, mx):
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        hi = torch.where(torch.isfinite(hi), hi, 0.0)
        out.append(morton.keys_in_frame_pass(p, m, lo, torch.clamp_min(hi - lo, 1e-6),
                                             pass_index))
    return out


def _gids(pts, axis_name, mesh):
    """Each shard's rows' global row ids (int32)."""
    s = pts[0].shape[0]
    return [me * s + torch.arange(s, dtype=torch.int32, device=p.device)
            for me, p in zip(axis_index(mesh, axis_name), pts)]


def make_distributed_morton_sort(mesh: Mesh, pass_index: int = 0,
                                 axis_name: str = POINTS_AXIS):
    """Distributed Morton sort of an arbitrarily sharded cloud:
    ``fn(points (N, 3), mask (N,)) -> (points, mask, gid)``, the globally
    Morton-sorted cloud as contiguous equal shard slices (the
    ``morton_presort`` layout, built on the devices) and each sorted row's
    original global row (int32). The lattice frame is a pmin / pmax over
    the axis; invalid rows carry INT32_MAX keys and sink to the trailing
    shards. Equal keys keep input order, so ``gid`` is a permutation."""
    spec = P(axis_name)
    n_dev = mesh.shape[axis_name]

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        keys = _frame_keys(pts, mask, pass_index, axis_name, mesh)
        ops = _local_sort((keys, pts, mask, _gids(pts, axis_name, mesh)))
        _, pts, mask, gid = _oddeven_block_sort(ops, axis_name, n_dev, mesh=mesh)
        return pts, mask, gid

    return shard_map(body, mesh, (spec, spec), (spec, spec, spec))


def make_sharded_normals_window(mesh: Mesh, k: int = 10,
                                viewpoint=(0.0, 0.0, 0.0),
                                orient: bool = True, tile: int = 256,
                                band: int = 16, presorted: bool = False,
                                axis_name: str = POINTS_AXIS):
    """Fused-kernel distributed normals over a points-sharded cloud.

    With ``presorted=False`` (default) the input sharding is arbitrary:
    the distributed Morton sort (``make_distributed_morton_sort``) lays
    the cloud out first and a second odd-even sort keyed on the carried
    global row routes the results back to input order.
    ``presorted=True`` skips both (the ``morton_presort`` layout) and
    returns results in sorted order.

    Each shard launches the fused window-normals kernel
    (``kernels.knn.window_normals_tiles``, band ``band``) once, on its
    slice with a one-tile halo from each neighbour (``ppermute``; the end
    shards receive zeros, an invalid halo). Shard size must be a multiple
    of ``tile``. Returns (normals (N, 3), valid (N,)) sharded."""
    from ..kernels.knn import window_normals_tiles
    from ..ops.normals import _orient

    spec = P(axis_name)
    n_dev = mesh.shape[axis_name]
    fwd = [(i, i + 1) for i in range(n_dev - 1)]    # send right
    bwd = [(i + 1, i) for i in range(n_dev - 1)]    # send left

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        s = pts[0].shape[0]
        gid = _gids(pts, axis_name, mesh)
        if not presorted:
            keys = _frame_keys(pts, mask, 0, axis_name, mesh)
            _, pts, mask, gid = _oddeven_block_sort(
                _local_sort((keys, pts, mask, gid)), axis_name, n_dev, mesh=mesh)
        mf = [m.to(torch.float32) for m in mask]
        left_p = ppermute([p[-tile:] for p in pts], mesh, axis_name, fwd)
        left_m = ppermute([m[-tile:] for m in mf], mesh, axis_name, fwd)
        right_p = ppermute([p[:tile] for p in pts], mesh, axis_name, bwd)
        right_m = ppermute([m[:tile] for m in mf], mesh, axis_name, bwd)
        normals, valids = [], []
        for p, m, v, lp, lm, rp, rm in zip(pts, mask, mf, left_p, left_m, right_p, right_m):
            ext = torch.cat([lp, p, rp]).T.contiguous()
            ext_m = torch.cat([lm, v, rm])[None].contiguous()
            out = window_normals_tiles(ext, ext_m, k, tile, band)[:, tile:tile + s]
            valid = m & (out[4] >= 3)
            vp = _host_const(viewpoint, p.device)
            normal = _orient(out[0:3].T, p, vp, orient)
            normals.append(torch.where(valid[:, None], normal, 0.0))
            valids.append(valid)
        if not presorted:
            _, normals, valids = _oddeven_block_sort(
                _local_sort((gid, normals, valids)), axis_name, n_dev, mesh=mesh)
        return normals, valids

    return shard_map(body, mesh, (spec, spec), (spec, spec))


# ---------------------------------------------------------------------------
# the sharded filters
# ---------------------------------------------------------------------------

def _run_sums(key, values):
    """``sorted_run_sums`` over the key runs of rows sorted by ``key`` (n, 3),
    the INT32_MAX rows (last) left out: one run of padding rows would be
    one long segment, reduced serially. The valid count is read on the
    host (one sync). Returns (sums (n, C + 1) at run-start rows, run-start
    flags of the valid rows)."""
    head = (key != torch.roll(key, 1, 0)).any(1)
    head[0] = True
    nv = int((key[:, 2] != _INT32_MAX).sum())
    sums = torch.zeros((key.shape[0], values.shape[1] + 1), dtype=torch.float32,
                       device=key.device)
    sums[:nv] = segmented.sorted_run_sums(values[:nv], head[:nv],
                                          torch.ones_like(head[:nv]))
    runs = head.clone()
    runs[nv:] = False
    return sums, runs


def _key_sorted_segments(coords3, payload3):
    """Sort rows by (z, y, x) voxel key (stable), sum the payload over key
    runs (``ops.segmented.sorted_run_sums``) and compact the run rows to
    the front in run order. Returns (run keys (n, 3) INT32_MAX-padded,
    payload sums (n, 3), counts (n,))."""
    n = coords3.shape[0]
    order = _lexsort([coords3[:, 2], coords3[:, 1], coords3[:, 0]])
    key = coords3[order]
    sums, runs = _run_sums(key, payload3[order])
    front = torch.sort(torch.where(runs, 0, 1), stable=True).indices
    run_valid = torch.arange(n, device=key.device) < runs.sum()
    run_keys = torch.where(run_valid[:, None], key[front], _INT32_MAX)
    sums = sums[front]
    return run_keys, sums[:, :3], sums[:, 3]


def make_sharded_voxel_filter(mesh: Mesh, voxel_size: float,
                              axis_name: str = POINTS_AXIS):
    """Distributed voxel-grid downsample over a points-sharded cloud.

    Two-level segment reduction: each shard sorts its points by voxel key
    (floor((p − min) / voxel), the min a pmin over the axis, the division
    a true fp32 one by a device scalar) and sums the coordinates relative
    to the min over each voxel; the compacted tables ``all_gather`` along
    the axis and a second sort and run sum merges voxels that several
    shards hold. That second merge is replicated in JAX; here it runs
    once, on the axis's first device, and each shard receives its slice.
    Output: (N, 3) centroids and a bool mask sharded like the input, the
    valid centroids packed to the front of shard 0 onward."""
    spec = P(axis_name)

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        ns = pts[0].shape[0]
        devs = mesh.device_list
        mn = pmin([torch.where(m[:, None], p, torch.inf).amin(0)
                   for p, m in zip(pts, mask)], mesh, axis_name)
        mn = [torch.where(torch.isfinite(x), x, 0.0) for x in mn]
        tables = []
        for p, m, lo in zip(pts, mask, mn):
            rel = p - lo
            vsize = _host_const(voxel_size, p.device)
            coords = torch.where(m[:, None], torch.floor(rel / vsize).to(torch.int32),
                                 _INT32_MAX)
            tables.append(_key_sorted_segments(coords, rel))
        cent, out_mask = [None] * mesh.size, [None] * mesh.size
        for group in mesh.axis_groups(axis_name):
            home = devs[group[0]]
            keys_g, sums_g, cnt_g = (torch.cat([tables[i][j].to(home) for i in group])
                                     for j in range(3))
            order = _lexsort([keys_g[:, 2], keys_g[:, 1], keys_g[:, 0]])
            merged, runs = _run_sums(keys_g[order],
                                     torch.cat([sums_g[order], cnt_g[order][:, None]], 1))
            merged = merged[torch.sort(torch.where(runs, 0, 1), stable=True).indices]
            n2 = merged.shape[0]
            c = merged[:, :3] / torch.clamp_min(merged[:, 3], 1.0)[:, None] + mn[group[0]]
            keep = torch.arange(n2, device=home) < runs.sum()
            c = torch.where(keep[:, None], c, 0.0)
            for pos, i in enumerate(group):
                cent[i] = c[pos * ns:(pos + 1) * ns].to(devs[i])
                out_mask[i] = keep[pos * ns:(pos + 1) * ns].to(devs[i])
        return cent, out_mask

    return shard_map(body, mesh, (spec, spec), (spec, spec))


def make_sharded_outlier_stats(mesh: Mesh, k: int,
                               axis_name: str = POINTS_AXIS):
    """Distributed statistical-outlier pass: each point's mean distance to
    its k nearest others (a k+1 ring kNN over the cloud, the self match
    dropped), the global mean and σ of those means over the masked points
    (``global_stats_local``), and the inlier mask mean ≤ μ +
    std_multiplier·σ. ``fn(points, mask, std_multiplier)``, the multiplier
    replicated; returns the mask sharded."""
    spec = P(axis_name)

    def body(pts, mask, std_multiplier):
        pts, mask = _f32(pts), _bool(mask)
        neg, _, _ = ring_knn_local(pts, pts, mask, k + 1, axis_name, mesh=mesh)
        mean_d = []
        for ng in neg:
            d = torch.sqrt(torch.clamp_min(-ng, 0.0))
            fin = torch.isfinite(d)
            cnt = fin.sum(1) - 1
            mean_d.append(torch.where(fin, d, 0.0).sum(1) / torch.clamp_min(cnt, 1))
        mu, sigma = global_stats_local(mean_d, mask, axis_name, mesh=mesh)
        return [m & (md <= u + sm.to(torch.float32) * sg)
                for m, md, u, sm, sg in zip(mask, mean_d, mu, std_multiplier, sigma)]

    return shard_map(body, mesh, (spec, spec, P()), spec)


# ---------------------------------------------------------------------------
# the x-slab block-sparse TSDF
# ---------------------------------------------------------------------------

class ShardedTsdfState(NamedTuple):
    """Block-sparse TSDF partitioned over a mesh: shard *d* owns the x-slab
    ``bx ∈ [d·gx/D, (d+1)·gx/D)`` of the virtual block grid, a contiguous
    block-key range. Every field is a ``Sharded`` value on the axis
    (``max_blocks_per_shard`` rows a shard)."""

    block_keys: Sharded   # (D·mb,) int32 sorted within each shard, INT32_MAX-padded
    n_blocks: Sharded     # (D,) int32 allocated count per shard
    tsdf: Sharded         # (D·mb, (B+1)^3) f32
    weight: Sharded       # (D·mb, (B+1)^3) f32


class ShardedTsdf(NamedTuple):
    """What :func:`make_sharded_tsdf` returns."""

    init: Callable              # () -> ShardedTsdfState
    integrate: Callable         # (state, depth, intr, pose) -> state
    extract_surface: Callable   # (state) -> (points (D·rows, 3), mask), sharded
    marching_cubes: Callable    # (state) -> (vertices (D·rows, 3), mask), sharded
    # (state, intr, pose, height, width, ...) -> replicated
    # (depth, vertices, normals, mask, confident) maps
    raycast: Callable = None


def _per_copy(fn, *shards):
    """``fn`` over each distinct copy of replicated per-shard values:
    shards whose arguments are the same objects (the one copy a
    collective builds for the shards of a device) share one result, as
    JAX's replicated computation gives every device the same bits."""
    memo, out = {}, []
    for args in zip(*shards):
        key = tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def make_sharded_tsdf(mesh: Mesh, grid_blocks: Tuple[int, int, int],
                      voxel_size: float, origin=(0.0, 0.0, 0.0),
                      block: int = 8, max_blocks_per_shard: int = 2048,
                      truncation: Optional[float] = None,
                      update_fraction: float = 0.5,
                      ray_samples: int = 3, max_weight: float = 64.0,
                      min_weight: float = 1.0,
                      axis_name: str = POINTS_AXIS) -> ShardedTsdf:
    """Block-sparse TSDF fusion over a mesh (the sharded analog of
    ``ops.tsdf_sparse``).

    The virtual block grid is split into x-slabs, contiguous block-key
    ranges, one a shard. Every shard receives the whole (replicated)
    depth frame, runs ``sparse_integrate`` restricted to its own key
    range and stores only its slab's blocks: fusion needs no collective.
    Extraction and marching cubes run per block, and the (B+1)³ apron
    makes each block self-contained (an apron voxel gets the same
    projective update as the neighbour's interior, bit for bit), so they
    need none either and are seamless across slab boundaries.

    ``raycast`` marches the whole image on every shard against its slab
    and one halo block layer from each x-neighbour, then keeps each
    pixel's nearest hit (a ``pmin`` of the depth, the lowest shard index
    on a tie) and sums the winner's maps (``psum``); it is cached by
    (height, width, near, far, max_steps, coarse_factor).

    Requires ``grid_blocks[0]`` divisible by the mesh axis size."""
    from ..ops import tsdf_raycast, tsdf_sparse as sp
    from ..ops.tsdf import _valid_first_order

    gx, gy, gz = grid_blocks
    n_dev = mesh.shape[axis_name]
    if gx % n_dev != 0:
        raise ValueError(
            f"grid_blocks[0]={gx} must be divisible by the "
            f"'{axis_name}' mesh axis size {n_dev}")
    slab = gx // n_dev
    gyz = gy * gz
    mb = max_blocks_per_shard
    s = (block + 1) ** 3
    trunc = truncation if truncation is not None else 4.0 * voxel_size
    spec = P(axis_name)
    consts = {}

    def _local_vol(keys, nb, tsdf, weight):
        dev = keys.device
        if dev not in consts:      # (origin, voxel size, truncation) on the device
            consts[dev] = tuple(_host_const(v, dev) for v in (origin, voxel_size, trunc))
        return sp.SparseTsdfVolume(keys, nb[0], tsdf, weight, *consts[dev], None)

    def _init() -> ShardedTsdfState:
        def full(shape, value, dtype):
            return Sharded(mesh, spec, [torch.full(shape, value, dtype=dtype, device=d)
                                        for d in mesh.device_list])
        return ShardedTsdfState(full((mb,), _INT32_MAX, torch.int32),
                                full((1,), 0, torch.int32),
                                full((mb, s), 1.0, torch.float32),
                                full((mb, s), 0.0, torch.float32))

    def _integrate(keys, nb, tsdf, weight, depth, intr, pose):
        out = ([], [], [], [])
        for me, k, n, t, w, d, i, p in zip(axis_index(mesh, axis_name), keys, nb, tsdf,
                                            weight, depth, intr, pose):
            lo = me * slab * gyz
            vol = sp.sparse_integrate(
                _local_vol(k, n, t, w), d, i, p, grid_blocks=grid_blocks, block=block,
                ray_samples=ray_samples, max_weight=max_weight,
                update_fraction=update_fraction, key_range=(lo, lo + slab * gyz))
            for o, v in zip(out, (vol.block_keys, vol.n_blocks[None], vol.tsdf, vol.weight)):
                o.append(v)
        return out

    def _extract(keys, nb, tsdf, weight):
        pts, msk = [], []
        for k, n, t, w in zip(keys, nb, tsdf, weight):
            surf = sp.sparse_extract_surface(_local_vol(k, n, t, w), grid_blocks,
                                             block=block, min_weight=min_weight)
            pts.append(surf.cloud.points)
            msk.append(surf.cloud.mask)
        return pts, msk

    def _mc(keys, nb, tsdf, weight):
        verts, msk = [], []
        for k, n, t, w in zip(keys, nb, tsdf, weight):
            soup = sp.sparse_marching_cubes_soup(_local_vol(k, n, t, w), grid_blocks,
                                                 block=block, min_weight=min_weight)
            verts.append(soup.vertices)
            msk.append(soup.mask.repeat_interleave(3))
        return verts, msk

    integrate_fn = shard_map(_integrate, mesh, (spec,) * 4 + (P(),) * 3, (spec,) * 4)
    extract_fn = shard_map(_extract, mesh, (spec,) * 4, (spec, spec))
    mc_fn = shard_map(_mc, mesh, (spec,) * 4, (spec, spec))

    def integrate(st: ShardedTsdfState, depth, intr, pose) -> ShardedTsdfState:
        return ShardedTsdfState(*integrate_fn(st.block_keys, st.n_blocks, st.tsdf,
                                              st.weight, depth, intr, pose))

    def extract_surface(st: ShardedTsdfState):
        return extract_fn(st.block_keys, st.n_blocks, st.tsdf, st.weight)

    def marching_cubes(st: ShardedTsdfState):
        return mc_fn(st.block_keys, st.n_blocks, st.tsdf, st.weight)

    def _halo_extend(keys, nb, tsdf, weight):
        """Append the x-neighbours' boundary block layers (one ppermute
        each way) so marches can cross slab boundaries: a surface between
        slab d's last x-layer and slab d+1's first lies in blocks of two
        shards, and without the halo both see a hole there mid-ray (JAX
        measured vertical stripes of missed hits at every slab boundary).
        Halo keys lie outside the owner's range, so the extended table has
        no duplicates and one stable key sort restores the sorted keys.
        Returns one ``SparseTsdfVolume`` a shard."""
        me = axis_index(mesh, axis_name)
        left, right = [], []
        for d, k, n, t, w in zip(me, keys, nb, tsdf, weight):
            lo = d * slab * gyz
            hi = lo + slab * gyz
            alloc = torch.arange(mb, device=k.device) < n[0]
            for side, sel in ((left, k < lo + gyz), (right, (k >= hi - gyz) & (k < hi))):
                sel = sel & alloc
                take = _valid_first_order(sel)[:gyz]      # the layer's rows first
                live = torch.arange(take.shape[0], device=k.device) < sel.sum()
                side.append((torch.where(live, k[take], _INT32_MAX), t[take], w[take]))
        up = [(i, i + 1) for i in range(n_dev - 1)]
        down = [(i, i - 1) for i in range(1, n_dev)]
        # d-1's right layer arrives as d's left halo, d+1's left layer as its
        # right halo; ppermute zero-fills the edge receivers, and a zero KEY
        # would alias block 0, so theirs become the sentinel (their weights
        # arrive 0, unobserved)
        halo_l = [ppermute([x[j] for x in right], mesh, axis_name, up) for j in range(3)]
        halo_r = [ppermute([x[j] for x in left], mesh, axis_name, down) for j in range(3)]
        out = []
        for i, (d, k, n, t, w) in enumerate(zip(me, keys, nb, tsdf, weight)):
            kl, kr = halo_l[0][i], halo_r[0][i]
            if d == 0:
                kl = torch.full_like(kl, _INT32_MAX)
            if d == n_dev - 1:
                kr = torch.full_like(kr, _INT32_MAX)
            keys_e = torch.cat([k, kl, kr])
            order = torch.sort(keys_e, stable=True).indices
            n_ext = n[0] + (kl < _INT32_MAX).sum() + (kr < _INT32_MAX).sum()
            vol = _local_vol(k, n, t, w)
            out.append(vol._replace(
                block_keys=keys_e[order], n_blocks=n_ext.to(torch.int32),
                tsdf=torch.cat([t, halo_l[1][i], halo_r[1][i]])[order],
                weight=torch.cat([w, halo_l[2][i], halo_r[2][i]])[order]))
        return out

    @functools.lru_cache(maxsize=8)
    def _make_raycast(height, width, near, far, max_steps, coarse_factor):
        def _rc(keys, nb, tsdf, weight, intr, pose):
            # every shard marches the WHOLE image against its slab plus one
            # halo block layer each side (other slabs read as unallocated
            # and are skipped); any crossing the global march would find
            # lies in some shard's own or halo blocks, so the global first
            # hit is the min over the shards' first hits. Refinement and
            # normals are slab-local: the apron makes boundary blocks
            # self-contained.
            res = [tsdf_raycast.sparse_raycast(
                vol, i, p, height, width, grid_blocks=grid_blocks, block=block, near=near,
                far=far, max_steps=max_steps, coarse_factor=coarse_factor, materialize=False)
                for vol, i, p in zip(_halo_extend(keys, nb, tsdf, weight), intr, pose)]
            t = [torch.where(r.mask, r.depth, torch.inf) for r in res]
            tmin = pmin(t, mesh, axis_name)
            win = [r.mask & (ti == tm) for r, ti, tm in zip(res, t, tmin)]
            me = axis_index(mesh, axis_name)
            wid = pmin([torch.full_like(w, 2 ** 30, dtype=torch.int32).masked_fill_(w, d)
                        for w, d in zip(win, me)], mesh, axis_name)
            winner = [w & (i == d) for w, i, d in zip(win, wid, me)]  # one winner a pixel
            depth = psum([torch.where(w, r.depth, 0.0) for w, r in zip(winner, res)], mesh,
                         axis_name)
            pts = psum([torch.where(w[..., None], r.vertices, 0.0)
                        for w, r in zip(winner, res)], mesh, axis_name)
            nrm = psum([torch.where(w[..., None], r.normals, 0.0)
                        for w, r in zip(winner, res)], mesh, axis_name)
            okf = psum([w.to(torch.float32) for w in winner], mesh, axis_name)
            conf = psum([torch.where(w, r.confident.to(torch.float32), 0.0)
                         for w, r in zip(winner, res)], mesh, axis_name)
            return depth, pts, nrm, [o > 0.0 for o in okf], [c > 0.0 for c in conf]

        return shard_map(_rc, mesh, (spec,) * 4 + (P(), P()), (P(),) * 5)

    def raycast(st: ShardedTsdfState, intr, pose, height: int, width: int,
                near: float = 0.1, far: float = 10.0, max_steps: int = 96,
                coarse_factor: int = 4):
        """Sharded raycast: per-slab marches and one pmin / psum combine;
        returns replicated (depth, vertices, normals, mask, confident)
        maps on the mesh's first device."""
        fn = _make_raycast(height, width, float(near), float(far), int(max_steps),
                           int(coarse_factor))
        return fn(st.block_keys, st.n_blocks, st.tsdf, st.weight, intr, pose)

    return ShardedTsdf(_init, integrate, extract_surface, marching_cubes, raycast)


class ShardedFrameToModelOdometry:
    """KinectFusion odometry over a mesh-sharded map: the x-slab
    block-sparse TSDF (``make_sharded_tsdf``) is the model; frames are
    tracked against its sharded raycast and fused in without a
    collective. Mirrors ``ops.frame_to_model.FrameToModelOdometry``'s
    ``register_frame`` surface; the map's scale is the only difference
    (``max_blocks_per_shard`` × the axis size blocks).

    Tracking runs once, on the mesh's first device, on the combined
    raycast maps (replicated), with the single-device projective
    point-to-plane tracker. Depth frames are expected in metres (the
    sharded integrate does not rescale). ``register_frame`` returns the
    (4, 4) world pose on the first device."""

    def __init__(self, mesh: Mesh, intrinsics, height: int, width: int,
                 voxel_size: float = 0.02, origin=(-2.0, -2.0, 0.0),
                 grid_blocks: Tuple[int, int, int] = (32, 32, 32),
                 block: int = 8, max_blocks_per_shard: int = 4096,
                 config=None, axis_name: str = POINTS_AXIS):
        from ..ops.frame_to_model import FrameToModelConfig
        from ..ops.tsdf import _to_device

        self.config = config or FrameToModelConfig()
        self.height, self.width = height, width
        self.device = mesh.device_list[0]
        intr = ([intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy]
                if hasattr(intrinsics, "fx") else intrinsics)
        self._intr_host = _to_device(intr, "cpu", torch.float32)
        self.intr = _pose_to(self._intr_host, self.device)
        self.fac = make_sharded_tsdf(
            mesh, grid_blocks, voxel_size, origin=origin, block=block,
            max_blocks_per_shard=max_blocks_per_shard,
            update_fraction=self.config.update_fraction, axis_name=axis_name)
        self.state = self.fac.init()
        self._pose_host = torch.eye(4)
        self._prev_delta = torch.eye(4)
        self.pose = _pose_to(self._pose_host, self.device)
        self.n_frames = 0
        self.last_track = None

    def register_frame(self, depth) -> torch.Tensor:
        """Track + fuse one depth frame; returns the (4, 4) world pose."""
        from ..core.transform import Transform
        from ..ops.frame_to_model import _track
        from ..ops.tsdf import _to_device
        from ..ops.tsdf_raycast import RaycastResult

        cfg = self.config
        dev = self.device
        depth = _to_device(depth, dev)
        if self.n_frames > 0:
            # constant-velocity seed, then the sharded raycast from it
            seed = linalg.fp32_matmul(self._pose_host, self._prev_delta)
            s = cfg.model_render_scale
            ih = self._intr_host
            if s == 1:
                mintr = ih
            else:
                half = (s - 1.0) / 2.0
                mintr = torch.stack([ih[0] / s, ih[1] / s, (ih[2] - half) / s,
                                     (ih[3] - half) / s])
            maps = self.fac.raycast(self.state, _pose_to(mintr, dev), _pose_to(seed, dev),
                                    self.height // s, self.width // s, near=cfg.near,
                                    far=cfg.far, max_steps=cfg.max_steps)
            model = RaycastResult(*maps)
            ts = cfg.track_stride
            if ts > 1:
                tdepth, tintr = depth[::ts, ::ts], ih / ts
                min_px = max(1, cfg.min_valid_pixels // (ts * ts))
            else:
                tdepth, tintr, min_px = depth, ih, cfg.min_valid_pixels
            tr, new_pose = _track(model, seed, tdepth, tintr, seed, cfg.max_iterations,
                                  cfg.dist_gate, cfg.normal_gate, 1.0, min_px, mintr)
            self.last_track = tr
            self._prev_delta = linalg.fp32_matmul(
                Transform(self._pose_host).inverse().matrix, new_pose)
            self._pose_host = new_pose
            self.pose = tr.cam_to_world
        self.state = self.fac.integrate(self.state, depth, self.intr, self.pose)
        self.n_frames += 1
        return self.pose

    def render(self, cam_to_world=None):
        """Sharded raycast of the current map (default: from the current
        pose); returns replicated (depth, vertices, normals, mask,
        confident) maps."""
        from ..ops.tsdf import _to_device

        pose = self.pose if cam_to_world is None else \
            _to_device(cam_to_world, self.device, torch.float32)
        return self.fac.raycast(self.state, self.intr, pose, self.height, self.width,
                                near=self.config.near, far=self.config.far,
                                max_steps=self.config.max_steps)


# ---------------------------------------------------------------------------
# the sharded feature → pose chain
# ---------------------------------------------------------------------------

def _fp32_const(x: float) -> float:
    """``x`` rounded to fp32, as a Python float (JAX's weak-typed scalar
    against an fp32 array)."""
    return torch.tensor(x, dtype=torch.float32).item()


def sharded_fpfh_local(pts, mask, nrm, radius, k, axis_name: str = POINTS_AXIS,
                       n_bins: int = 11, *, mesh):
    """FPFH of a points-sharded cloud over two ring passes: a k+1 ring kNN
    with the normals as payload gives each query its neighbours'
    coordinates and normals, so SPFH (three hard-binned Darboux-angle
    histograms) is shard-local; FPFH(p) = SPFH(p) + (1/k)·Σ (1/dᵢ)·SPFH(qᵢ)
    gathers the neighbours' SPFH rows by their global ids
    (``ring_gather_rows_local``). Returns per shard lists (descriptors
    (Qs, 3·n_bins), valid (Qs,))."""
    from ..ops.features import _hist, pair_features

    r2 = _fp32_const(float(radius) * float(radius))
    tiny = _fp32_const(1e-18)
    neg, nbr_pts, nbr_nrm, nbr_idx = ring_knn_payload_local(pts, pts, mask, nrm, k + 1,
                                                            axis_name, mesh=mesh)
    spfh, oks, d2s = [], [], []
    for p, m, n, ng, npt, nn in zip(pts, mask, nrm, neg, nbr_pts, nbr_nrm):
        d2 = torch.clamp_min(-ng, 0.0)
        ok = (ng > -torch.inf) & (d2 <= r2) & (d2 > tiny) & m[:, None]
        w = ok.to(torch.float32)
        f1, f2, f3, _ = pair_features(p[:, None, :], n[:, None, :], npt, nn)
        h = torch.cat([_hist(f1, -math.pi, math.pi, n_bins, w),
                       _hist(f2, -1.0, 1.0, n_bins, w),
                       _hist(f3, -1.0, 1.0, n_bins, w)], -1)
        spfh.append(h / torch.clamp_min(w.sum(1, keepdim=True), 1.0))
        oks.append(ok)
        d2s.append(d2)
    nbr_spfh = ring_gather_rows_local(nbr_idx, spfh, axis_name, mesh=mesh)
    descs, valids = [], []
    for sp, ns, ok, d2, m in zip(spfh, nbr_spfh, oks, d2s, mask):
        dist = torch.sqrt(d2)
        inv_d = torch.where(ok & (dist > 1e-12), 1.0 / torch.clamp_min(dist, 1e-12), 0.0)
        k_eff = torch.clamp_min(ok.sum(1), 1)[:, None]
        fpfh = sp + torch.einsum("nk,nkd->nd", inv_d, ns) / k_eff
        blocks = fpfh.reshape(fpfh.shape[0], 3, n_bins)
        desc = (blocks / torch.clamp_min(blocks.sum(-1, keepdim=True), 1e-12)
                * 100.0).reshape(fpfh.shape)
        valid = m & (ok.sum(1) >= 3)
        descs.append(torch.where(valid[:, None], desc, 0.0))
        valids.append(valid)
    return descs, valids


def make_sharded_fpfh(mesh: Mesh, radius: float, k: int = 64,
                      axis_name: str = POINTS_AXIS):
    """Sharded FPFH: points, mask, normals sharded on axis 0 →
    (descriptors (N, 33), valid (N,)) sharded the same way."""
    spec = P(axis_name)

    def body(pts, mask, nrm):
        return sharded_fpfh_local(_f32(pts), _bool(mask), _f32(nrm), radius, k, axis_name,
                                  mesh=mesh)

    return shard_map(body, mesh, (spec,) * 3, (spec, spec))


def make_sharded_match_descriptors(mesh: Mesh,
                                   axis_name: str = POINTS_AXIS):
    """Sharded descriptor matching: source descriptors as the queries,
    target descriptors as the ring database with the target points as
    payload. ``fn(desc_a, valid_a, desc_b, valid_b, tgt_pts)`` returns
    (global index into the target (int32), distance (inf where not ok),
    ok, matched target xyz), all sharded like the source."""
    spec = P(axis_name)

    def body(desc_a, valid_a, desc_b, valid_b, tgt_pts):
        valid_a = _bool(valid_a)
        neg, _, pay, idx = ring_knn_payload_local(_f32(desc_a), _f32(desc_b),
                                                  _bool(valid_b), _f32(tgt_pts), 1,
                                                  axis_name, mesh=mesh)
        outs = [[], [], [], []]
        for ng, py, ix, va in zip(neg, pay, idx, valid_a):
            ok = va & (ng[:, 0] > -torch.inf)
            dist = torch.sqrt(torch.clamp_min(-ng[:, 0], 0.0))
            for o, v in zip(outs, (ix[:, 0].to(torch.int32), torch.where(ok, dist, torch.inf),
                                   ok, py[:, 0])):
                o.append(v)
        return tuple(outs)

    return shard_map(body, mesh, (spec,) * 5, (spec,) * 4)


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s RANSAC generator: the first 64-bit
    word that ``numpy.random.SeedSequence([seed, shard])`` generates (the
    counterpart of JAX's ``fold_in(PRNGKey(seed), shard)``)."""
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), shard])
               .generate_state(1, np.uint64)[0])


def make_sharded_global_registration(
        mesh: Mesh, fpfh_radius: float = 0.25, k_normals: int = 10,
        k_fpfh: int = 64, distance_threshold: float = 0.05,
        hypotheses_per_device: int = 1024, query_stride: int = 4,
        refine_iterations: int = 15, seed: int = 0,
        axis_name: str = POINTS_AXIS):
    """Sharded FPFH + RANSAC global registration. Normals (ring kNN), FPFH
    (two ring passes) and matching (a ring over the target descriptors
    with the target points as payload) are sharded; the correspondences
    of every ``query_stride``-th source row are all-gathered, and each
    shard fits and scores its own ``hypotheses_per_device`` RANSAC
    hypotheses (``ops.global_registration.sample_hypotheses`` and
    ``score_hypotheses``) from a generator seeded with
    ``shard_seed(seed, shard)``; the best count wins (the first on ties)
    and distributed point-to-point ICP refines it. So the pose agrees
    with JAX's to the registration's accuracy, not bit for bit. Inputs:
    src, mask, tgt, mask sharded; returns (transform (4, 4), inlier
    count, inlier ratio) replicated."""
    from ..ops.global_registration import sample_hypotheses, score_hypotheses
    from ..ops.normals import _pca_normals

    spec = P(axis_name)

    def normals_of(pts, mask):
        neg, nbr, _ = ring_knn_local(pts, pts, mask, k_normals + 1, axis_name, mesh=mesh)
        return [_pca_normals(nb, ng > -torch.inf, p, torch.zeros(3, device=p.device),
                             True)[0] for p, ng, nb in zip(pts, neg, nbr)]

    def body(src, src_mask, tgt, tgt_mask):
        src, tgt, src_mask, tgt_mask = _f32(src), _f32(tgt), _bool(src_mask), _bool(tgt_mask)
        src_desc, src_dv = sharded_fpfh_local(src, src_mask, normals_of(src, src_mask),
                                              fpfh_radius, k_fpfh, axis_name, mesh=mesh)
        tgt_desc, tgt_dv = sharded_fpfh_local(tgt, tgt_mask, normals_of(tgt, tgt_mask),
                                              fpfh_radius, k_fpfh, axis_name, mesh=mesh)
        neg, _, pay, _ = ring_knn_payload_local(
            [d[::query_stride] for d in src_desc], tgt_desc, tgt_dv, tgt, 1, axis_name,
            mesh=mesh)
        ok_local = [v[::query_stride] & (ng[:, 0] > -torch.inf)
                    for v, ng in zip(src_dv, neg)]
        sp_all = all_gather([s[::query_stride] for s in src], mesh, axis_name, tiled=True)
        tp_all = all_gather([p[:, 0] for p in pay], mesh, axis_name, tiled=True)
        ok_all = all_gather(ok_local, mesh, axis_name, tiled=True)
        fits, counts = [], []
        for me, sp, tp, ok in zip(axis_index(mesh, axis_name), sp_all, tp_all, ok_all):
            gen = torch.Generator(device=sp.device)
            gen.manual_seed(shard_seed(seed, me))
            # with no valid pair, draw uniformly (every count is then 0), as
            # JAX's choice over all-zero weights draws without failing
            idx = sample_hypotheses(gen, ok | ~ok.any(), hypotheses_per_device)
            t, c = score_hypotheses(idx, sp, tp, ok, distance_threshold)
            fits.append(t)
            counts.append(c.to(torch.int32))
        counts = all_gather(counts, mesh, axis_name)
        fits = all_gather(fits, mesh, axis_name)
        best = [torch.argmax(c) for c in counts]
        t_best = [f[b] for f, b in zip(fits, best)]
        if refine_iterations > 0:
            t_best = icp_sharded_loop(src, src_mask, tgt, tgt_mask, t_best,
                                      refine_iterations, 1e-7, distance_threshold * 2.0,
                                      axis_name, mesh=mesh)[0]
        n_corr = [torch.clamp_min(ok.sum(), 1) for ok in ok_all]
        count = [c[b] for c, b in zip(counts, best)]
        return (t_best, count,
                [c.to(torch.float32) / n.to(torch.float32) for c, n in zip(count, n_corr)])

    return shard_map(body, mesh, (spec,) * 4, (P(),) * 3)


# ---------------------------------------------------------------------------
# sharded analysis entries: NDT, ground, clusters, SHOT, plane RANSAC, MLS,
# colorize
# ---------------------------------------------------------------------------

def _mom9(c: torch.Tensor) -> torch.Tensor:
    """First and second moments of centred rows: (n, 9) [c, xx yy zz xy
    xz yz]."""
    return torch.cat([c, torch.stack([c[:, 0] * c[:, 0], c[:, 1] * c[:, 1],
                                      c[:, 2] * c[:, 2], c[:, 0] * c[:, 1],
                                      c[:, 0] * c[:, 2], c[:, 1] * c[:, 2]], 1)], 1)


def _cov_of_moments(sums: torch.Tensor):
    """(mean of the centred rows (n, 3), weight (n,), sample covariance
    (n, 3, 3)) from rows [Σc (3), Σcc (6), Σw]."""
    wsum = sums[:, 9]
    mu = sums[:, :3] * (1.0 / torch.clamp_min(wsum, 1.0))[:, None]
    cc = (sums[:, 3:9] - wsum[:, None] * torch.stack(
        [mu[:, 0] * mu[:, 0], mu[:, 1] * mu[:, 1], mu[:, 2] * mu[:, 2],
         mu[:, 0] * mu[:, 1], mu[:, 0] * mu[:, 2], mu[:, 1] * mu[:, 2]], 1)) \
        / torch.clamp_min(wsum - 1.0, 1.0)[:, None]
    cov = torch.stack([torch.stack([cc[:, 0], cc[:, 3], cc[:, 4]], -1),
                       torch.stack([cc[:, 3], cc[:, 1], cc[:, 5]], -1),
                       torch.stack([cc[:, 4], cc[:, 5], cc[:, 2]], -1)], -2)
    return mu, wsum, cov


def _sorted_runs(key: torch.Tensor, values: torch.Tensor):
    """Sort rows by ``key`` (stable), sum ``values`` over each key's run
    (``ops.segmented.sorted_run_sums``) and compact the runs to the front
    in key order: (run keys (n,) INT32_MAX-padded, sums (n, C + 1), the
    last column the run's row count)."""
    from ..ops.tsdf import _valid_first_order

    sk, perm = torch.sort(key, stable=True)
    valid = sk != _INT32_MAX
    head = torch.ones_like(valid)
    head[1:] = sk[1:] != sk[:-1]
    head &= valid
    sums = segmented.sorted_run_sums(values[perm], head, valid)
    front = _valid_first_order(head)
    return torch.where(head[front], sk[front], _INT32_MAX), sums[front]


def make_sharded_ndt(mesh: Mesh, resolution: float,
                     max_iterations: int = 35, step_size: float = 0.1,
                     epsilon: float = 1e-4, min_points: int = 5,
                     subsample: int = 1, full_iters: int = 2,
                     axis_name: str = POINTS_AXIS):
    """Distributed NDT registration (the sharded analog of ``ops.ndt``).

    The cell Gaussians come from a two-level merge, as in
    ``make_sharded_voxel_filter``: each shard sort-reduces the
    CELL-CENTRE-relative first and second moments of its target points
    (shard-independent, and fp32-safe: |c| is at most a cell diagonal),
    the compact per-shard tables ``all_gather`` and one replicated sort
    and segmented sum merges cells that several shards hold. Each shard
    solves the 3×3 eigensystems and regularised inverses of 1/D of the
    merged table and the results ``all_gather`` back. The Gauss-Newton
    loop runs on the host, one ``psum`` of (score, gradient, Hessian) and
    one read-back an iteration: each shard scores its source slice
    against the replicated table by ``searchsorted``. ``subsample`` > 1
    strides each shard's source in all but the last ``full_iters``
    iterations, then the full shards polish; one final score.

    ``fn(src, src_mask, tgt, tgt_mask, init)``: clouds sharded on axis 0,
    ``init`` (4, 4) replicated. Returns (transform, score, iterations,
    converged), replicated."""
    from ..ops.gicp import _normal_equations, inv3x3

    spec, rep = P(axis_name), P()
    step = torch.tensor(step_size, dtype=torch.float32)
    eps = torch.tensor(epsilon, dtype=torch.float32)

    def cell_tables(tgt, tgt_mask, mn, dims, res_t):
        """The merged cell table, replicated: (keys (D·ns,) ascending,
        INT32_MAX-padded; sums (D·ns, 10) = [Σc (3), Σcc (6), count])."""
        keys1, sums1 = [], []
        for t, m, lo, dm, r in zip(tgt, tgt_mask, mn, dims, res_t):
            coords = torch.floor((t - lo) / r).to(torch.int32)
            inb = ((coords >= 0) & (coords < dm)).all(-1)
            key = (coords[:, 2] * dm[1] + coords[:, 1]) * dm[0] + coords[:, 0]
            key = torch.where(inb & m, key, _INT32_MAX)
            centers = (coords.to(torch.float32) + 0.5) * r + lo
            k1, s1 = _sorted_runs(key, _mom9(torch.where(m[:, None], t - centers, 0.0)))
            keys1.append(k1)
            sums1.append(s1)
        keys_g = all_gather(keys1, mesh, axis_name, tiled=True)
        sums_g = all_gather(sums1, mesh, axis_name, tiled=True)

        def merge(k, sm):
            # cols 0-8 the moments, col 9 the summed point counts; the run
            # sums' appended rows-per-run column is dropped
            keys, sums = _sorted_runs(k, sm)
            return keys, sums[:, :10]

        return _per_copy(merge, keys_g, sums_g)

    def body(src, src_mask, tgt, tgt_mask, init):
        src, tgt, src_mask, tgt_mask = _f32(src), _f32(tgt), _bool(src_mask), _bool(tgt_mask)
        ns = tgt[0].shape[0]
        n2 = ns * axis_size(mesh, axis_name)
        # the global grid frame from the target's bounding box
        mn = pmin([torch.where(m[:, None], t, torch.inf).amin(0)
                   for t, m in zip(tgt, tgt_mask)], mesh, axis_name)
        mx = pmax([torch.where(m[:, None], t, -torch.inf).amax(0)
                   for t, m in zip(tgt, tgt_mask)], mesh, axis_name)
        mn = [torch.where(torch.isfinite(x), x, 0.0) for x in mn]
        mx = [torch.where(torch.isfinite(x), x, 0.0) for x in mx]
        res_t = [_host_const(resolution, t.device) for t in tgt]
        dims = [torch.clamp_min(torch.floor((b - a) / r).to(torch.int32) + 1, 1)
                for a, b, r in zip(mn, mx, res_t)]
        tables = cell_tables(tgt, tgt_mask, mn, dims, res_t)

        # each shard's slice: means and regularised inverse covariances
        means_s, inv_s, valid_s = [], [], []
        for me, (ukeys, usums), lo, dm, r in zip(axis_index(mesh, axis_name), tables, mn,
                                                  dims, res_t):
            keys_s, sums_s = ukeys[me * ns:(me + 1) * ns], usums[me * ns:(me + 1) * ns]
            mu, cnt, covs = _cov_of_moments(sums_s)          # centre-relative mean
            kk = torch.clamp_min(keys_s, 0)
            cell = torch.stack([kk % dm[0], (kk // dm[0]) % dm[1], kk // (dm[0] * dm[1])], 1)
            means_s.append((cell.to(torch.float32) + 0.5) * r + lo + mu)
            vals, vecs = linalg.eigh3x3(covs)
            floor = 0.01 * torch.clamp_min(vals[..., 2:3], 1e-9)
            vals_r = torch.maximum(vals, floor)
            inv_s.append(inv3x3(linalg.fp32_matmul(vecs * vals_r[:, None, :],
                                                   vecs.transpose(1, 2))))
            valid_s.append((cnt >= min_points) & (keys_s != _INT32_MAX))
        means = all_gather(means_s, mesh, axis_name, tiled=True)
        inv_covs = all_gather(inv_s, mesh, axis_name, tiled=True)
        cvalid = all_gather(valid_s, mesh, axis_name, tiled=True)

        def score_terms(poses, pts, pmask):
            """psum'd [score, gradient (6), Hessian (36)] a shard."""
            packs = []
            for t_mat, p, pm, (ukeys, _), lo, dm, r, mu, b_all, cv in zip(
                    poses, pts, pmask, tables, mn, dims, res_t, means, inv_covs, cvalid):
                moved = linalg.transform_points(_pose_to(t_mat, p.device), p)
                coords = torch.floor((moved - lo) / r).to(torch.int32)
                inb = ((coords >= 0) & (coords < dm)).all(-1)
                key = (coords[:, 2] * dm[1] + coords[:, 1]) * dm[0] + coords[:, 0]
                key = torch.where(inb, key, _INT32_MAX)
                pos = torch.clamp_max(torch.searchsorted(ukeys, key), n2 - 1)
                ok = (ukeys[pos] == key) & (key != _INT32_MAX) & pm & cv[pos]
                d = moved - mu[pos]
                b = b_all[pos]
                q = (d * (b * d[:, None, :]).sum(2)).sum(1)
                s = torch.exp(-0.5 * q.clamp(0.0, 50.0)) * ok.to(torch.float32)
                hess, grad = _normal_equations(moved, d, b * s[:, None, None])
                packs.append(torch.cat([s.sum()[None], grad, hess.reshape(36)]))
            return psum(packs, mesh, axis_name)

        groups = mesh.axis_groups(axis_name)
        t_host = [init[g[0]].to(torch.float32).cpu() for g in groups]
        it = [0] * len(groups)
        phases = [(src, src_mask, max_iterations)]
        if subsample > 1 and max_iterations > full_iters:
            phases.insert(0, ([x[::subsample] for x in src], [m[::subsample] for m in src_mask],
                              max_iterations - full_iters))
        for pts, pmask, budget in phases:
            dn = [torch.tensor(torch.inf)] * len(groups)
            while True:
                live = [it[g] < budget and bool(dn[g] >= eps) for g in range(len(groups))]
                if not any(live):
                    break
                host = _host(score_terms(_per_shard(t_host, mesh, axis_name), pts, pmask),
                             mesh, axis_name)
                for g, h in enumerate(host):
                    if not live[g]:
                        continue
                    delta = -linalg.solve_psd(h[7:].reshape(6, 6), h[1:7], damping=1e-2)
                    norm = torch.linalg.vector_norm(delta)
                    delta = delta * torch.where(norm > step, step / torch.clamp_min(norm, 1e-12),
                                                1.0)
                    t_host[g] = linalg.fp32_matmul(se3_exp(delta), t_host[g])
                    dn[g] = torch.linalg.vector_norm(delta)
                    it[g] += 1
        score = score_terms(_per_shard(t_host, mesh, axis_name), src, src_mask)
        pose, _, its, conv = _replicated(mesh, axis_name, src, t_host, [0.0] * len(groups),
                                         it, [bool(x < eps) for x in dn])
        return pose, [s[0] for s in score], its, conv

    return shard_map(body, mesh, (spec,) * 4 + (rep,), (rep,) * 4)


def _czm_centres(config, radii, rings, sectors) -> np.ndarray:
    """The static CZM patch centroids (P + 1, 3): ring mid-radius, sector
    mid-angle, z = −sensor_height (the overflow row 0)."""
    n_zones = len(config.rings_per_zone)
    centers = np.zeros((config.n_patches + 1, 3), np.float32)
    row = 0
    for zi in range(n_zones):
        nr, nsec = int(rings[zi]), int(sectors[zi])
        for ri in range(nr):
            rmid = radii[zi] + (ri + 0.5) * (radii[zi + 1] - radii[zi]) / nr
            for si in range(nsec):
                amid = (si + 0.5) * 2.0 * np.pi / nsec - np.pi
                centers[row] = (rmid * np.cos(amid), rmid * np.sin(amid), -config.sensor_height)
                row += 1
    return centers


def make_sharded_ground(mesh: Mesh, config=None,
                        axis_name: str = POINTS_AXIS):
    """Distributed Patchwork++ ground segmentation over a points-sharded
    cloud (the sharded analog of ``ops.ground.patchwork_plus_plus``).

    1. A global (patch, z) sort: the odd-even block rounds
       (``_oddeven_block_sort`` with two keys) put every CZM patch into
       one globally contiguous, z-ascending run. Global seed ranks then
       cost one ``all_gather`` of per-patch counts: a row's rank plus the
       same patch's count on lower shards.
    2. R-GPF: each shard sums PATCH-CENTRE-relative first and second
       moments (the static CZM patch centroid, shard-independent; |c| is
       at most the patch extent, so the fp32 expansion is safe) over its
       runs into a (P+1, 10) table, ``psum``'d; the plane fits run
       replicated, the inlier re-selection per row.
    3. A second block sort keyed on the carried global row id routes the
       flags back to the input order.

    The port's block sort is stable, so on tied (patch, z) keys every
    row still gets exactly one flag (JAX's can lose rows there).

    Inputs: points (N, 3) and mask (N,) sharded on axis 0. Returns
    (ground_mask (N,) sharded like the input, patch_valid (P,) and
    patch_normals (P, 3) replicated)."""
    from ..ops import ground as ground_ops

    if config is None:
        config = ground_ops.PatchworkConfig()
    radii, rings, sectors, base = ground_ops._patch_tables(config)
    n_patches = config.n_patches
    n_zones = len(config.rings_per_zone)
    p1 = n_patches + 1                      # + the overflow bucket
    centers_np = _czm_centres(config, radii, rings, sectors)
    spec, rep = P(axis_name), P()
    n_dev = mesh.shape[axis_name]
    frac = _fp32_const(config.seed_fraction)
    dist_thresh = _fp32_const(config.distance_threshold)
    elev_max = _fp32_const(-config.sensor_height + config.elevation_threshold)
    n_iters = config.num_iterations

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        s = pts[0].shape[0]
        me = axis_index(mesh, axis_name)
        tables = {}
        for p in pts:
            if p.device not in tables:
                tables[p.device] = [torch.from_numpy(t).to(p.device) for t in
                                    (radii, rings, sectors, base, centers_np)]
        tab = [tables[p.device] for p in pts]
        seg = []
        for p, m, (r_t, ri_t, se_t, b_t, _) in zip(pts, mask, tab):
            pid = ground_ops._patch_ids(p, m, r_t, ri_t, se_t, b_t, n_zones)
            seg.append(torch.where(pid >= 0, pid, n_patches))
        gid = _gids(pts, axis_name, mesh)

        # ---- 1: the global (patch, z) sort ----------------------------------
        ops0 = _local_sort((seg, [p[:, 2] for p in pts], [p[:, 0] for p in pts],
                            [p[:, 1] for p in pts], gid), num_keys=2)
        seg_s, z_s, x_s, y_s, gid_s = _oddeven_block_sort(ops0, axis_name, n_dev, num_keys=2,
                                                          mesh=mesh)
        kc = min(s, p1)
        rows = []
        for sg in seg_s:
            pos = torch.arange(s, device=sg.device)
            head = torch.ones_like(sg, dtype=torch.bool)
            head[1:] = sg[1:] != sg[:-1]
            start_el = torch.cummax(torch.where(head, pos, -1), 0).values.clamp_min(0)
            sp = torch.where(head, pos, s)
            sp_next = torch.cat([sp[1:], sp.new_full((1,), s)])
            next_start = torch.flip(torch.cummin(torch.flip(sp_next, [0]), 0).values, [0])
            len_head = torch.where(head, next_start - pos, 0)
            # the head rows compacted to the front once; kc covers every
            # distinct local run
            cperm_h = torch.sort(torch.where(head, 0, 1), stable=True).indices[:kc]
            idx_h = torch.where(head[cperm_h], sg[cperm_h], p1).long()
            cnt = torch.zeros(p1 + 1, dtype=torch.int64, device=sg.device)
            cnt[idx_h] = len_head[cperm_h]
            rows.append((head, pos - start_el, cperm_h, idx_h, cnt[:p1]))
        cnt_all = all_gather([r[4] for r in rows], mesh, axis_name)     # (D, P+1)

        cnt_tot = _per_copy(lambda ca: ca.sum(0).to(torch.float32), cnt_all)
        pts_s, valid_s, w_seed, mom = [], [], [], []
        for d, sg, z, x, y, (head, rank, _, _, _), ca, ct, t5 in zip(
                me, seg_s, z_s, x_s, y_s, rows, cnt_all, cnt_tot, tab):
            seed_n = torch.clamp_min((ct * frac).to(torch.int32), config.min_seed_points)
            p = torch.stack([x, y, z], 1)
            v = sg < n_patches
            pts_s.append(p)
            valid_s.append(v)
            # the global rank: the local one plus the patch's rows on lower shards
            w_seed.append(((rank + ca[:d].sum(0)[sg]) < seed_n[sg]) & v)
            mom.append(_mom9(p - t5[4][sg]))

        # ---- 2: R-GPF on psum'd patch moments -------------------------------
        def fit_planes(w_bool):
            parts = []
            for m9, w, (head, _, cperm_h, idx_h, _) in zip(mom, w_bool, rows):
                sums = segmented.sorted_run_sums(m9, head, w)
                tbl = torch.zeros((p1 + 1, 10), dtype=torch.float32, device=m9.device)
                tbl[idx_h] = sums[cperm_h]
                parts.append(tbl[:p1])

            def solve(tbl, centers):
                mu, wsum, cov = _cov_of_moments(tbl)
                mean = centers + mu
                nrm, _ = linalg.smallest_eigenvector_sym3x3(cov)
                nrm = torch.where((nrm[:, 2] < 0)[:, None], -nrm, nrm)
                return nrm, -(nrm * mean).sum(1), mean, linalg.eigvals_sym3x3(cov), wsum

            return _per_copy(solve, psum(parts, mesh, axis_name), [t[4] for t in tab])

        def distance(fits):
            return [((p * f[0][sg]).sum(1) + f[1][sg]).abs()
                    for p, sg, f in zip(pts_s, seg_s, fits)]

        # n_iters refits; the selection stays fixed on the extra final pass,
        # so the emitted fit is the fit of the selection it was made on
        w_sel = w_seed
        for _ in range(n_iters):
            w_sel = [v & (dd <= dist_thresh) for v, dd in zip(valid_s, distance(fit_planes(w_sel)))]
        fits = fit_planes(w_sel)

        def accept(fit, ct):
            nrm, _, mean, vals, wsum = fit
            flat = torch.clamp_min(vals[:, 0], 0.0) / torch.clamp_min(vals.sum(1), 1e-12)
            return ((ct >= config.min_patch_points)
                    & (nrm[:, 2].abs() >= _fp32_const(config.uprightness_threshold))
                    & (mean[:, 2] <= elev_max)
                    & (flat <= _fp32_const(config.flatness_threshold))
                    & (wsum >= 3)
                    & (torch.arange(p1, device=nrm.device) < n_patches))

        ok_t = _per_copy(accept, fits, cnt_tot)
        ground_s = [o[sg] & (dd <= dist_thresh) & v
                    for o, sg, dd, v in zip(ok_t, seg_s, distance(fits), valid_s)]

        # ---- 3: back to the input order -------------------------------------
        _, gf = _oddeven_block_sort(_local_sort((gid_s, ground_s)), axis_name, n_dev,
                                    mesh=mesh)
        return gf, [o[:n_patches] for o in ok_t], [f[0][:n_patches] for f in fits]

    return shard_map(body, mesh, (spec, spec), (spec, rep, rep))


def make_sharded_clusters(mesh: Mesh, config=None,
                          axis_name: str = POINTS_AXIS):
    """Distributed Euclidean clustering over a points-sharded cloud (the
    sharded analog of ``ops.segmentation.extract_euclidean_clusters``).

    The same capped-radius graph as the single-device path: one ring kNN
    pass gives each point the GLOBAL ids of its ``max_neighbors`` nearest
    points, radius-filtered. Label propagation then repeats min over the
    neighbours and two pointer jumps until a psum'd change flag clears
    (one host read an iteration); every step is a ring rotation of the
    (S,) label column (``ring_gather_rows_local``). The ranking follows
    ``segmentation._rank_clusters`` over dense (N,) root-size tables, a
    local scatter-add each, ``psum``'d.

    Returns (labels (N,) sharded like the input: cluster id by size rank,
    −1 = noise or filtered; n_clusters; sizes (N,) replicated, sizes[i]
    the size of cluster i). Labels equal the single-device path's where
    the neighbour sets agree (distance ties can differ)."""
    from ..ops.segmentation import EuclideanClusterConfig

    if config is None:
        config = EuclideanClusterConfig()
    spec, rep = P(axis_name), P()
    n_dev = mesh.shape[axis_name]
    tol2 = _fp32_const(_fp32_const(config.tolerance) ** 2)
    k = config.max_neighbors
    min_sz = config.min_cluster_size
    max_sz = min(config.max_cluster_size, _INT32_MAX)

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        s = pts[0].shape[0]
        n = s * n_dev
        gid = _gids(pts, axis_name, mesh)
        neg, _, nbr_idx = ring_knn_local(pts, pts, mask, k, axis_name, mesh=mesh)
        nbr_gids = [torch.where((ng > -torch.inf) & (-ng <= tol2) & m[:, None], ix,
                                g[:, None].to(torch.int64))
                    for ng, ix, m, g in zip(neg, nbr_idx, mask, gid)]

        def jump(lab):
            got = ring_gather_rows_local([x.to(torch.int64)[:, None] for x in lab],
                                         [x[:, None] for x in lab], axis_name, mesh=mesh)
            return [x[:, 0, 0] for x in got]

        labels = [torch.where(m, g, n - 1) for m, g in zip(mask, gid)]
        it, changed = 0, True
        while changed and it < n:
            nbr_lab = ring_gather_rows_local(nbr_gids, [x[:, None] for x in labels],
                                             axis_name, mesh=mesh)
            new = [torch.where(m, torch.minimum(lab, nl[..., 0].amin(1)), lab)
                   for m, lab, nl in zip(mask, labels, nbr_lab)]
            new = jump(jump(new))
            flag = psum([(a != b).any().to(torch.int32)[None] for a, b in zip(new, labels)],
                        mesh, axis_name)
            changed = bool(torch.cat(_host(flag, mesh, axis_name)).sum() > 0)
            labels, it = new, it + 1
        roots = labels

        # ranking: dense (N,) tables, a local scatter-add each, psum'd
        def table(idx, w):
            return torch.zeros(n, dtype=torch.int32, device=idx.device).index_add_(
                0, idx.long(), w.to(torch.int32))

        sizes_by_root = psum([table(torch.where(m, r, n - 1), m) for m, r in zip(mask, roots)],
                             mesh, axis_name)
        keep = [m & (sb[r.long()] >= min_sz) & (sb[r.long()] <= max_sz)
                for m, r, sb in zip(mask, roots, sizes_by_root)]
        is_root = [(g == r) & kp for g, r, kp in zip(gid, roots, keep)]
        kept_root = psum([table(torch.where(ir, r, n - 1), ir) for ir, r in zip(is_root, roots)],
                         mesh, axis_name)

        def rank_table(sb, kr):
            root_size = torch.where(kr > 0, sb, -1)
            order = torch.argsort(-root_size, stable=True)
            rank = torch.empty(n, dtype=torch.int32, device=sb.device)
            rank[order] = torch.arange(n, dtype=torch.int32, device=sb.device)
            ranked = root_size[order]
            return (rank, (root_size > 0).sum().to(torch.int32),
                    torch.where(ranked > 0, ranked, 0))

        ranks = _per_copy(rank_table, sizes_by_root, kept_root)
        labels_out = [torch.where(kp, rk[0][r.long()], -1)
                      for kp, rk, r in zip(keep, ranks, roots)]
        return labels_out, [rk[1] for rk in ranks], [rk[2] for rk in ranks]

    return shard_map(body, mesh, (spec, spec), (spec, rep, rep))


def make_sharded_shot(mesh: Mesh, config=None, variant: str = "shot",
                      axis_name: str = POINTS_AXIS):
    """Distributed SHOT/USC descriptors over a points-sharded cloud (the
    sharded analog of the staged ``extract_shot_features`` /
    ``extract_usc_features``).

    One ring kNN pass with the normals as payload carries each query's
    ``max_neighbors`` nearest GLOBAL neighbours' coordinates and normals
    (one extra row, the query itself, masked out by global id); the
    descriptors then run locally on the gathered (S, k, ·) rows through
    the shared ``_shot_descriptor_block`` (the staged path's LRF and
    soft-binned histogram), 16,384 rows at a time. No kernel runs.

    Inputs: points (N, 3), mask (N,), normals (N, 3), sharded on axis 0.
    Returns (descriptors (N, 352|128), valid (N,)) sharded. Equal to the
    staged path's where the neighbour sets agree (distance ties can
    differ)."""
    from ..ops.features import USC_DIM, ShotConfig, _shot_descriptor_block

    if config is None:
        config = ShotConfig()
    if variant not in ("shot", "usc"):
        raise ValueError(f"variant must be 'shot' or 'usc', got {variant}")
    spec = P(axis_name)
    radius = _fp32_const(config.radius)
    r2 = _fp32_const(radius * radius)
    k = config.max_neighbors
    n_cos = config.n_cos_bins
    dim = 32 * n_cos if variant == "shot" else USC_DIM

    def body(pts, mask, normals):
        s = pts[0].shape[0]
        if mask[0].shape[0] != s or normals[0].shape[0] != s:
            raise ValueError(
                "points/mask/normals leading dims differ "
                f"({s}/{mask[0].shape[0]}/{normals[0].shape[0]}); note "
                "PointCloud buckets capacity — shard cloud.points/"
                "cloud.mask/cloud.normals, not the raw input array")
        pts, mask, normals = _f32(pts), _bool(mask), _f32(normals)
        gid = _gids(pts, axis_name, mesh)
        # the query rides along as its own nearest row: ask for one more and
        # mask it out by global id
        neg, rows, pay, ids = ring_knn_payload_local(pts, pts, mask, normals, k + 1,
                                                     axis_name, mesh=mesh)
        descs, valids = [], []
        for p, m, nr, g, ng, rw, py, ix in zip(pts, mask, normals, gid, neg, rows, pay, ids):
            ok = (ng > -torch.inf) & (-ng <= r2) & (ix != g[:, None]) & m[:, None]
            dist = torch.where(ok, torch.sqrt(torch.clamp_min(-ng, 0.0)), radius)
            block = min(16384, s)
            desc = torch.empty((s, dim), dtype=torch.float32, device=p.device)
            for b0 in range(0, s, block):
                sl = slice(b0, b0 + block)
                desc[sl] = _shot_descriptor_block(rw[sl], py[sl], ok[sl], dist[sl], p[sl],
                                                  nr[sl], radius, n_cos, variant)
            valid = m & (ok.sum(1) >= 5)
            descs.append(torch.where(valid[:, None], desc, 0.0))
            valids.append(valid)
        return descs, valids

    return shard_map(body, mesh, (spec,) * 3, (spec, spec))


# point-hypothesis pairs of one slab of the plane RANSAC's inlier sweep
# (4 bytes each: ~1 GiB)
_RANSAC_SWEEP_ELEMENTS = 2 ** 28


def make_sharded_plane_ransac(mesh: Mesh,
                              distance_threshold: float = 0.01,
                              max_iterations: int = 1000,
                              refine: bool = True,
                              axis_name: str = POINTS_AXIS):
    """Distributed RANSAC plane segmentation over a points-sharded cloud
    (the sharded analog of ``ops.segmentation.segment_plane``).

    Each shard fits ``ceil(max_iterations / D)`` hypotheses from random
    triples of its own rows, then one ``all_gather`` replicates the
    (H, 5) table (normal, offset, ok). Every shard counts its rows'
    inliers for ALL hypotheses in one (S, H) distance sweep, H chunked
    where a slab would pass ~1 GiB (the counts are integers, so the
    chunking changes no bit), and one ``psum`` gives the global counts;
    the first hypothesis of the largest count wins. The refinement is two
    moment ``psum``s (mean, then the covariance about the global mean)
    and a replicated 3×3 eigensolve.

    The draws are the port's own, as in ``segment_plane``: a CPU
    ``torch.Generator`` a shard, seeded with ``shard_seed(seed, shard)``
    (JAX folds the shard index into its key; torch cannot reproduce
    ``jax.random.choice``), so the winning plane is an equally valid
    draw, not JAX's. A shard with fewer than 3 valid rows contributes no
    hypothesis.

    Returns ``fn(points, mask, seed=0) -> PlaneSegmentationResult`` with
    the inlier mask sharded like the input and the model and count
    replicated."""
    from ..ops.segmentation import PlaneModel, PlaneSegmentationResult, _sample_triples

    spec, rep = P(axis_name), P()
    n_dev = mesh.shape[axis_name]
    h_local = -(-max_iterations // n_dev)
    thr = _fp32_const(distance_threshold)

    def dist(p, nrm, d):
        return torch.abs(neighbors._cross(p, nrm) + d)

    def body(pts, mask, *, seed):
        pts, mask = _f32(pts), _bool(mask)
        coefs = []
        for me, p, m in zip(axis_index(mesh, axis_name), pts, mask):
            enough = bool(m.sum() >= 3)
            idx = _sample_triples(m, h_local, shard_seed(seed, me))
            tri = p[idx]                                        # (h, 3, 3)
            nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
            nn = torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
            ok_h = (nn[:, 0] > 1e-12) & enough
            nrm = nrm / torch.clamp_min(nn, 1e-30)
            d = -(nrm * tri[:, 0]).sum(1)
            coefs.append(torch.cat([nrm, d[:, None], ok_h[:, None].to(torch.float32)], 1))
        all_coef = all_gather(coefs, mesh, axis_name, tiled=True)
        n_hyp = all_coef[0].shape[0]
        counts = []
        for p, m, c in zip(pts, mask, all_coef):
            step = max(1, _RANSAC_SWEEP_ELEMENTS // max(1, p.shape[0]))
            counts.append(torch.cat([((dist(p, c[h0:h0 + step, :3], c[h0:h0 + step, 3])
                                       <= thr) & m[:, None]).sum(0)
                                     for h0 in range(0, n_hyp, step)]))
        counts = psum(counts, mesh, axis_name)

        def pick(cnt, c):
            cnt = torch.where(c[:, 4] > 0.5, cnt, -1)
            first = torch.arange(n_hyp, device=c.device)
            best = torch.where(cnt == cnt.max(), first, n_hyp).amin()
            return c[best, :3], c[best, 3]

        model = _per_copy(pick, counts, all_coef)
        inl = [m & (dist(p, nb[None], db) <= thr)[:, 0]
               for p, m, (nb, db) in zip(pts, mask, model)]
        if refine:
            wi = [x.to(torch.float32) for x in inl]
            sw = [torch.clamp_min(x, 1.0) for x in psum([w.sum() for w in wi], mesh, axis_name)]
            mean = [x / w for x, w in zip(psum([linalg.fp32_matmul(w[None], p)[0]
                                                for w, p in zip(wi, pts)], mesh, axis_name), sw)]
            cov = psum([linalg.fp32_matmul(((p - mu) * w[:, None]).T, p - mu)
                        for p, w, mu in zip(pts, wi, mean)], mesh, axis_name)

            def refit(c, w, mu):
                nb = linalg.smallest_eigenvector_sym3x3(c / w)[0]
                return nb, -(nb * mu).sum()

            model = _per_copy(refit, cov, sw, mean)
            inl = [m & (dist(p, nb[None], db) <= thr)[:, 0]
                   for p, m, (nb, db) in zip(pts, mask, model)]
        count = psum([x.sum().to(torch.int32) for x in inl], mesh, axis_name)
        return [x[0] for x in model], [x[1] for x in model], inl, count

    def call(points, mask, seed: int = 0) -> PlaneSegmentationResult:
        run = shard_map(functools.partial(body, seed=int(seed)), mesh, (spec, spec),
                        (rep, rep, spec, rep))
        nb, db, inl, count = run(points, mask)
        return PlaneSegmentationResult(PlaneModel(nb, db), inl, count)

    return call


def make_sharded_mls(mesh: Mesh, config=None,
                     axis_name: str = POINTS_AXIS):
    """Distributed MLS projection over a points-sharded cloud (the
    sharded analog of ``reconstruction.mls_smooth``).

    One ring kNN pass collects each point's ``max_neighbors`` nearest
    GLOBAL neighbours (their coordinates ride the merge), then the
    weighted polynomial fit runs locally through the shared
    ``_mls_project_rows`` (the same local frame, dimensionless basis and
    scale-relative Tikhonov term as the single-device path).

    Inputs: points (N, 3) and mask (N,), sharded on axis 0. Returns
    (projected (N, 3), fitted normals (N, 3), valid (N,)) sharded. Equal
    to the single-device path where the neighbour sets agree (distance
    ties can differ)."""
    from ..reconstruction.moving_least_squares import MlsConfig, _mls_project_rows

    if config is None:
        config = MlsConfig()
    spec = P(axis_name)
    radius = _fp32_const(config.search_radius)
    r2 = _fp32_const(radius * radius)
    reg = _fp32_const(config.regularization)
    k = config.max_neighbors
    kernel, order = config.kernel, config.basis.value

    def body(pts, mask):
        pts, mask = _f32(pts), _bool(mask)
        neg, rows, _ = ring_knn_local(pts, pts, mask, k, axis_name, mesh=mesh)
        out = ([], [], [])
        for p, m, ng, rw in zip(pts, mask, neg, rows):
            ok = (ng > -torch.inf) & (-ng <= r2) & m[:, None]
            dist = torch.where(ok, torch.sqrt(torch.clamp_min(-ng, 0.0)), radius)
            for o, v in zip(out, _mls_project_rows(rw, ok, dist, p, m, radius, kernel, order,
                                                   reg)):
                o.append(v)
        return out

    return shard_map(body, mesh, (spec, spec), (spec, spec, spec))


def make_sharded_colorize(mesh: Mesh, height: int, width: int,
                          bilinear: bool = False,
                          axis_name: str = POINTS_AXIS):
    """Distributed multi-image colorization over a points-sharded cloud
    (the sharded analog of ``ops.colorization.colorize_from_images``).

    Projection and sampling are pointwise, so this is pure data
    parallelism: the view stack (images, intrinsics, extrinsics) is
    replicated, each shard colours its own points, and the views run in
    order, the first hit winning; no collective.

    Returns ``fn(points, mask, images (V, H, W, 3) f32, intrs (V, 4),
    w2cs (V, 4, 4)) -> (colors (N, 3), assigned (N,))`` sharded like the
    input; unassigned points keep colour 0 (the caller applies a
    default, as ``colorize_from_images`` does)."""
    from ..ops.colorization import _project_sample

    spec, rep = P(axis_name), P()

    def body(pts, mask, images, intrs, w2cs):
        pts, mask = _f32(pts), _bool(mask)
        colors, assigned = [], []
        for p, m, imgs, ins, ws in zip(pts, mask, images, intrs, w2cs):
            col = torch.zeros((p.shape[0], 3), dtype=torch.float32, device=p.device)
            got = torch.zeros((p.shape[0],), dtype=torch.bool, device=p.device)
            for img, intr, w2c in zip(imgs.to(torch.float32), ins.to(torch.float32),
                                      ws.to(torch.float32)):
                c, inside = _project_sample(p, m, img, intr, w2c, height, width, bilinear)
                take = inside & ~got
                col = torch.where(take[:, None], c, col)
                got = got | take
            colors.append(col)
            assigned.append(got)
        return colors, assigned

    return shard_map(body, mesh, (spec, spec, rep, rep, rep), (spec, spec))
