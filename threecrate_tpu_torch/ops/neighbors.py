"""Exact nearest-neighbour search by blockwise brute force.

Counterpart of ``threecrate_tpu.ops.neighbors.knn`` and
``nearest_one``: the (queries × database) squared distances are formed
one query chunk at a time as ‖q‖² + ‖p‖² − 2 q·pᵀ (an fp32 matmul),
and ``torch.topk`` keeps the k best. These carry normal estimation
below 65,536 points and ICP below 2^32 source×target pairs; above
those sizes the window kernels take over.
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


def knn(db_points: torch.Tensor, db_mask: torch.Tensor,
        queries: torch.Tensor, query_mask: Optional[torch.Tensor] = None,
        k: int = 1, *, query_chunk: int = 1024) -> KnnResult:
    """Exact k-nearest neighbours; the query itself is a valid neighbour
    (distance 0) when the query set is the database."""
    db_points = db_points.to(torch.float32)
    queries = queries.to(torch.float32)
    k = min(k, db_points.shape[0])
    pn = (db_points * db_points).sum(-1)
    negs, idxs = [], []
    for q in torch.split(queries, query_chunk):
        qn = (q * q).sum(-1)
        cross = fp32_matmul(q, db_points.T)
        d2 = torch.clamp_min(qn[:, None] + pn[None, :] - 2.0 * cross, 0.0)
        neg = torch.where(db_mask[None, :], -d2, -torch.inf)
        top_neg, top_idx = torch.topk(neg, k, dim=1)
        negs.append(top_neg)
        idxs.append(top_idx)
    d2 = -torch.cat(negs)
    idx = torch.cat(idxs)
    valid = torch.isfinite(d2)
    if query_mask is not None:
        valid = valid & query_mask[:, None]
    dist = torch.where(valid, torch.sqrt(torch.where(valid, d2, 0.0)), torch.inf)
    return KnnResult(idx, dist, valid)


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
