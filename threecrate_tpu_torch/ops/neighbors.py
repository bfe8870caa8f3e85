"""Exact nearest-neighbour search by blockwise brute force.

Counterpart of ``threecrate_tpu.ops.neighbors.knn``, ``radius_neighbors``
and ``nearest_one``. Queries go one chunk at a time, and each chunk
scans the database one ``db_tile`` of rows at a time: the (chunk ×
tile) squared distances are formed as ‖q‖² + ‖p‖² − 2 q·pᵀ (an fp32
matmul), ``torch.topk`` keeps each tile's k best and a 2k-wide top-k
merges them with the best so far. So no temporary is wider than
``db_tile`` columns, whatever the database size. Points of any
dimension work (descriptor matching sends 33-d FPFH rows).

These carry normal estimation below 65,536 points, ICP below 2^32
source×target pairs, the exact FPFH path and descriptor matching;
above those sizes the window kernels take over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .linalg import fp32_matmul


class KnnResult(NamedTuple):
    """indices ``(Q, k)`` int64 into the database (always in range, only
    meaningful where ``mask``); distances ``(Q, k)`` euclidean, ``inf``
    where invalid; mask ``(Q, k)`` bool slot validity."""

    indices: torch.Tensor
    distances: torch.Tensor
    mask: torch.Tensor


def _chunk_vs_db(q, q_rows, db_points, db_norms, db_mask, k, db_tile):
    """One query chunk against the database, tile by tile: (negated d²
    (qc, k), indices (qc, k)), best first. ``q_rows`` holds each query's
    own database row when the self pair is excluded, else None."""
    qn = (q * q).sum(-1)
    best_neg = best_idx = None
    for t0 in range(0, db_points.shape[0], db_tile):
        t1 = min(t0 + db_tile, db_points.shape[0])
        cross = fp32_matmul(q, db_points[t0:t1].T)
        d2 = torch.clamp_min(qn[:, None] + db_norms[None, t0:t1] - 2.0 * cross, 0.0)
        neg = torch.where(db_mask[None, t0:t1], -d2, -torch.inf)
        if q_rows is not None:
            cols = torch.arange(t0, t1, device=q.device)
            neg = torch.where(cols[None, :] == q_rows[:, None], -torch.inf, neg)
        top_neg, top_pos = torch.topk(neg, min(k, t1 - t0), dim=1)
        top_idx = top_pos + t0
        if best_neg is not None:
            cand_neg = torch.cat([best_neg, top_neg], 1)
            cand_idx = torch.cat([best_idx, top_idx], 1)
            top_neg, pos = torch.topk(cand_neg, min(k, cand_neg.shape[1]), dim=1)
            top_idx = torch.gather(cand_idx, 1, pos)
        best_neg, best_idx = top_neg, top_idx
    return best_neg, best_idx


def knn(db_points: torch.Tensor, db_mask: torch.Tensor,
        queries: torch.Tensor, query_mask: Optional[torch.Tensor] = None,
        k: int = 1, *, exclude_self: bool = False, query_chunk: int = 1024,
        db_tile: int = 262144) -> KnnResult:
    """Exact k-nearest neighbours. The query itself is a valid neighbour
    (distance 0) when the query set is the database, unless
    ``exclude_self`` drops each query's pair with the database row of
    its own index (only meaningful when queries is db_points)."""
    db_points = db_points.to(torch.float32)
    queries = queries.to(torch.float32)
    n_db = db_points.shape[0]
    k = min(k, n_db)
    pn = (db_points * db_points).sum(-1)
    negs, idxs = [], []
    for c0 in range(0, queries.shape[0], query_chunk):
        q = queries[c0:c0 + query_chunk]
        rows = (torch.arange(c0, c0 + q.shape[0], device=q.device)
                if exclude_self else None)
        neg, idx = _chunk_vs_db(q, rows, db_points, pn, db_mask, k, db_tile)
        negs.append(neg)
        idxs.append(idx)
    d2 = -torch.cat(negs)
    idx = torch.cat(idxs).clamp(0, n_db - 1)
    valid = torch.isfinite(d2)
    if query_mask is not None:
        valid = valid & query_mask[:, None]
    dist = torch.where(valid, torch.sqrt(torch.where(valid, d2, 0.0)), torch.inf)
    return KnnResult(idx, dist, valid)


def radius_neighbors(db_points: torch.Tensor, db_mask: torch.Tensor,
                     queries: torch.Tensor, query_mask: Optional[torch.Tensor],
                     radius, max_neighbors: int = 32, *,
                     exclude_self: bool = False, query_chunk: int = 2048,
                     db_tile: int = 2048) -> KnnResult:
    """Fixed-capacity radius search: up to ``max_neighbors`` nearest
    points within ``radius`` (compared in fp32); slots beyond the radius
    are masked out."""
    res = knn(db_points, db_mask, queries, query_mask, max_neighbors,
              exclude_self=exclude_self, query_chunk=query_chunk,
              db_tile=db_tile)
    r = torch.tensor(radius, dtype=torch.float32).item()
    inside = res.mask & (res.distances <= r)
    return KnnResult(res.indices, torch.where(inside, res.distances, torch.inf),
                     inside)


def radius_neighbors_window(points, mask, radius, max_neighbors: int = 32, *,
                            exclude_self: bool = False, tile: int = 128,
                            n_passes: int = 2) -> KnnResult:
    """The Morton-window self radius search of the JAX package: it runs
    on the ``knn_window_tiles`` kernel, which is not ported yet."""
    raise NotImplementedError(
        "radius_neighbors_window needs the knn_window_tiles kernel, still to "
        "be ported (ROADMAP.md, section 2, kernel 5)")


def nearest_one(db_points: torch.Tensor, db_mask: torch.Tensor,
                queries: torch.Tensor,
                max_distance: Optional[float] = None, **kw) -> KnnResult:
    """Top-1 correspondence search (the ICP inner loop below the window
    threshold)."""
    res = knn(db_points, db_mask, queries, None, 1, **kw)
    if max_distance is not None:
        inside = res.mask & (res.distances <= max_distance)
        res = KnnResult(res.indices,
                        torch.where(inside, res.distances, torch.inf), inside)
    return res
