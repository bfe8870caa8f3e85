"""Nearest-neighbour search: exact blockwise brute force and the
Morton-window approximation.

Counterpart of ``threecrate_tpu.ops.neighbors``. The exact searches
(``knn``, ``radius_neighbors``, ``nearest_one``) take queries one chunk
at a time, and each chunk scans the database one ``db_tile`` of rows at
a time: the (chunk × tile) squared distances are formed as ‖q‖² + ‖p‖²
− 2 q·pᵀ (an fp32 matmul on the card, an elementwise fp32 FMA chain on
the CPU: see ``_cross``), ``torch.topk`` keeps each tile's k best and
a 2k-wide top-k merges them with the best so far. So no temporary is
wider than ``db_tile`` columns, whatever the database size. Points of
any dimension work (descriptor matching sends 33-d FPFH rows). These
carry normal estimation below 65,536 points, ICP below 2^32
source×target pairs, the exact FPFH path and descriptor matching.

The window searches (``knn_window``, ``knn_window_sorted``,
``knn_window_cross``, ``radius_neighbors_window``) sort the cloud along
a Z-order curve per pass, search each tile's prev/self/next tiles with
the ``knn_window_tiles`` kernel and merge the passes (``_merge_topk``).
They carry ``method="window"`` normals, statistical outlier removal
above 262,144 points and the staged window FPFH.

``knn_grid`` searches the (2·ring+1)³ cells of the sorted voxel hash
(``ops.voxel_hash``) around each query; ``batch_distances_squared``
forms a full distance matrix; ``BruteForceSearch`` (alias ``KdTree``)
wraps the exact search around a cloud.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import padding
from . import morton, voxel_hash
from .linalg import fp32_matmul


class KnnResult(NamedTuple):
    """indices ``(Q, k)`` int64 into the database (always in range, only
    meaningful where ``mask``); distances ``(Q, k)`` euclidean, ``inf``
    where invalid; mask ``(Q, k)`` bool slot validity."""

    indices: torch.Tensor
    distances: torch.Tensor
    mask: torch.Tensor


def _cross(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """q·pᵀ in fp32: on the card a full-fp32 matmul; on the CPU a chain of
    fused multiply-adds over the columns in order (each product exact in
    float64, the running sum rounded to fp32 after each add), formed
    elementwise. That chain has the bits of XLA's CPU dot (and of the CPU
    BLAS in its usual state) and depends on no BLAS kernel: the CPU BLAS's
    fp32 product is not always true fp32 (one row of an (88 × 3)·(3 × 64)
    product was seen ~2^-16 of ‖q‖² + ‖p‖² off, under a thread state that
    did not recur), and the expanded d² passes such an error on whole."""
    if q.device.type != "cpu":
        return fp32_matmul(q, p.T)
    qd, pd = q.to(torch.float64), p.to(torch.float64)
    acc = (qd[:, :1] * pd[:, 0]).to(torch.float32)
    for r in range(1, q.shape[1]):
        acc = torch.addcmul(acc.to(torch.float64), qd[:, r:r + 1], pd[:, r]).to(torch.float32)
    return acc


def batch_distances_squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs squared distances ``(A, B)`` as ‖a‖² + ‖b‖² − 2 a·bᵀ in
    fp32 (the product as ``_cross`` forms it), clamped at 0. It forms the
    full matrix: for large sets use ``knn`` or ``knn_window``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    an = (a * a).sum(-1)
    bn = (b * b).sum(-1)
    return torch.clamp_min(an[:, None] + bn[None, :] - 2.0 * _cross(a, b), 0.0)


def _chunk_vs_db(q, q_rows, db_points, db_norms, db_mask, k, db_tile):
    """One query chunk against the database, tile by tile: (negated d²
    (qc, k), indices (qc, k)), best first. ``q_rows`` holds each query's
    own database row when the self pair is excluded, else None."""
    qn = (q * q).sum(-1)
    best_neg = best_idx = None
    for t0 in range(0, db_points.shape[0], db_tile):
        t1 = min(t0 + db_tile, db_points.shape[0])
        cross = _cross(q, db_points[t0:t1])
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
        db_tile: int = 262144, recall_target: float = 1.0) -> KnnResult:
    """Exact k-nearest neighbours. The query itself is a valid neighbour
    (distance 0) when the query set is the database, unless
    ``exclude_self`` drops each query's pair with the database row of
    its own index (only meaningful when queries is db_points).
    ``recall_target`` is accepted for the JAX signature, whose values
    below 1 select the TPU's approximate top-k (exact off the TPU); the
    port's top-k is always exact."""
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
    """Self radius search via the Morton window path (``knn_window``):
    the large-N replacement for ``radius_neighbors`` when the queries are
    the database."""
    res = knn_window(points, mask, max_neighbors, tile=tile, n_passes=n_passes,
                     exclude_self=exclude_self)
    r = torch.tensor(radius, dtype=torch.float32).item()
    inside = res.mask & (res.distances <= r)
    return KnnResult(res.indices, torch.where(inside, res.distances, torch.inf),
                     inside)


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


# ---------------------------------------------------------------------------
# Morton sliding-window kNN
# ---------------------------------------------------------------------------

_MERGE_ROWS = 16384   # rows per step of _merge_topk
_TENSOR_CHUNK_TILES = 256   # query tiles per step of _window_topk_tensor


def _merge_topk(neg_a, idx_a, neg_b, idx_b, k: int, pts_a=None, pts_b=None):
    """Merge two per-row best-first lists into the best k, with the JAX
    ``_merge_topk``'s result: b entries whose id equals a valid a entry's
    are dropped, ties place a before b, b keeps its own order, and
    unfilled slots hold −inf, id 0 (and zero coordinates). Here that is a
    stable descending sort of [a, b], ``_MERGE_ROWS`` rows at a time so
    the (rows, kb, ka) duplicate test stays small."""
    outs = []
    for r0 in range(0, neg_a.shape[0], _MERGE_ROWS):
        sl = slice(r0, r0 + _MERGE_ROWS)
        na, ia, nb, ib = neg_a[sl], idx_a[sl], neg_b[sl], idx_b[sl]
        dup = ((ib[:, :, None] == ia[:, None, :])
               & (na > -torch.inf)[:, None, :]).any(-1)
        nb = torch.where(dup, -torch.inf, nb)
        vals, pos = torch.sort(torch.cat([na, nb], 1), dim=1, descending=True,
                               stable=True)
        vals, pos = vals[:, :k], pos[:, :k]
        filled = vals > -torch.inf
        row = [vals, torch.where(filled, torch.gather(torch.cat([ia, ib], 1), 1, pos), 0)]
        if pts_a is not None:
            cand = torch.cat([pts_a[sl], pts_b[sl]], 1)
            row.append(torch.where(filled[..., None],
                                   torch.gather(cand, 1, pos[..., None].expand(-1, -1, 3)),
                                   0.0))
        outs.append(row)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _sort_perm(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device, dtype=perm.dtype)
    return inv


def _pad_rows(x: torch.Tensor, n_pad: int, fill=0):
    if x.shape[0] == n_pad:
        return x
    out = torch.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def _window_topk_tensor(sp, sv, perm_p, k, tile, window, exclude_self):
    """The window search without a kernel (``window`` tiles each side,
    wrapping around as ``jnp.roll`` does), exact top-k by a stable sort:
    (−d² (n_pad, kk), original ids (n_pad, kk)) in sorted order."""
    n_pad = sp.shape[0]
    t = n_pad // tile
    sp_t = sp.reshape(t, tile, 3)
    sv_t = sv.reshape(t, tile)
    shifts = list(range(window, 0, -1)) + [0] + [-s for s in range(1, window + 1)]
    w = len(shifts) * tile
    kk = min(k, w)
    negs, idxs = [], []
    for t0 in range(0, t, _TENSOR_CHUNK_TILES):
        t1 = min(t0 + _TENSOR_CHUNK_TILES, t)
        rows = torch.arange(t0, t1, device=sp.device)
        src = torch.cat([(rows - s) % t for s in shifts])            # window tiles
        tiles = src.reshape(len(shifts), -1).T                         # (T, 2w+1)
        cand = sp_t[tiles].reshape(t1 - t0, w, 3)
        cand_v = sv_t[tiles].reshape(t1 - t0, w)
        d = [sp_t[t0:t1, :, None, r] - cand[:, None, :, r] for r in range(3)]
        neg = torch.where(cand_v[:, None, :], -(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]),
                          -torch.inf)
        if exclude_self:
            # self sits at window offset window·tile + row of its own tile
            col = torch.arange(w, device=sp.device)
            own = window * tile + torch.arange(tile, device=sp.device)
            neg = torch.where(col[None, None, :] == own[None, :, None], -torch.inf, neg)
        top_neg, pos = torch.sort(neg, dim=-1, descending=True, stable=True)
        top_neg, pos = top_neg[..., :kk], pos[..., :kk]
        tile_id = rows[:, None, None]
        sorted_pos = (tile_id * tile - window * tile + pos) % n_pad
        negs.append(top_neg.reshape(-1, kk))
        idxs.append(perm_p[sorted_pos].reshape(-1, kk))
    return torch.cat(negs), torch.cat(idxs)


def knn_window(points: torch.Tensor, mask: torch.Tensor, k: int, *,
               tile: int = 256, n_passes: int = 2, window: int = 1,
               recall_target: float = 0.95, exclude_self: bool = False,
               backend: str = "auto", return_points: bool = False):
    """Approximate self-kNN via Morton-order sliding windows.

    Each pass sorts the points along a (per-pass shifted and axis-rolled)
    Z-order curve, tiles the sorted order and searches each tile's
    prev/self/next tiles; passes merge with ``_merge_topk``. With
    ``window=1`` and ``backend`` "auto" or "pallas" the search runs on
    ``knn_window_tiles`` (as the JAX package does on its TPU); other
    configurations search ``window`` tiles each side with plain tensor
    ops and an exact top-k (``recall_target`` is accepted for the JAX
    signature; the port's top-k is always exact).
    ``return_points=True`` (kernel path only) also returns the
    neighbours' coordinates ``(N, k, 3)``."""
    from ..kernels.knn_window import knn_window_tiles

    n = points.shape[0]
    dev = points.device
    points = points.to(torch.float32)
    use_kernel = backend in ("auto", "pallas") and window == 1
    if return_points:
        if window != 1:
            raise ValueError("return_points requires window=1 (pallas kernel path)")
        use_kernel = True
    best_neg = torch.full((n, k), -torch.inf, device=dev)
    best_idx = torch.zeros((n, k), dtype=torch.int32, device=dev)
    best_pts = torch.zeros((n, k, 3), device=dev) if return_points else None
    n_pad = padding.round_up(n, tile)

    for p in range(n_passes):
        perm = _sort_perm(morton.morton_keys(points, mask, pass_index=p))
        sp = _pad_rows(points[perm], n_pad)
        sv = _pad_rows(mask[perm], n_pad, False)
        perm_p = _pad_rows(perm.to(torch.int32), n_pad)
        posof = _inverse(perm)
        orig_pts = None
        if use_kernel:
            kk = min(k, 3 * tile)
            out = knn_window_tiles(sp.T.contiguous(), sv.to(torch.float32)[None],
                                   perm_p[None], kk, tile, with_coords=return_points,
                                   exclude_self=exclude_self)
            orig_neg = out[0].T[:n][posof]
            orig_idx = out[1].T[:n][posof]
            if return_points:
                orig_pts = out[2].T[:n].reshape(n, kk, 3)[posof]
        else:
            neg, idx = _window_topk_tensor(sp, sv, perm_p, k, tile, window, exclude_self)
            kk = neg.shape[1]
            orig_neg, orig_idx = neg[:n][posof], idx[:n][posof]
        if p == 0 and kk == k:
            best_neg, best_idx, best_pts = orig_neg, orig_idx, orig_pts
        elif return_points:
            best_neg, best_idx, best_pts = _merge_topk(best_neg, best_idx, orig_neg,
                                                       orig_idx, k, best_pts, orig_pts)
        else:
            best_neg, best_idx = _merge_topk(best_neg, best_idx, orig_neg, orig_idx, k)

    d2 = -best_neg
    valid = torch.isfinite(d2) & mask[:, None]
    dist = torch.sqrt(torch.where(valid, d2, torch.inf))
    result = KnnResult(best_idx.long().clamp(0, n - 1),
                       torch.where(valid, dist, torch.inf), valid)
    return (result, best_pts) if return_points else result


def knn_window_sorted(points: torch.Tensor, mask: torch.Tensor, k: int, *,
                      tile: int = 128, n_passes: int = 2):
    """Self-kNN with the results left in first-pass sorted order.

    Pass A sorts the padded cloud once; each further pass sorts the
    pass-A rows by its own key, runs the kernel with the original ids as
    payload, and its rows come back to pass-A order by one inverse
    permutation before the merge. Returns ``(neg (N_pad, k), ids
    (N_pad, k) int32 original rows, sorted points (N_pad, 3), sorted
    mask, perm_a)``, all in pass-A order."""
    from ..kernels.knn_window import knn_window_tiles

    n_pad = padding.round_up(points.shape[0], tile)
    pts = _pad_rows(points.to(torch.float32), n_pad)
    mask = _pad_rows(mask, n_pad, False)
    perm_a = _sort_perm(morton.morton_keys(pts, mask, pass_index=0)).to(torch.int32)
    pts_a_rows = pts[perm_a]
    am = mask[perm_a]
    neg, ids = knn_window_tiles(pts_a_rows.T.contiguous(), am.to(torch.float32)[None],
                                perm_a[None], k, tile)
    best_neg, best_idx = neg.T, ids.T
    for p in range(1, n_passes):
        row_a = _sort_perm(morton.morton_keys(pts_a_rows, am, pass_index=p))
        neg_b, ids_b = knn_window_tiles(
            pts_a_rows[row_a].T.contiguous(), am[row_a].to(torch.float32)[None],
            perm_a[row_a][None], k, tile)
        inv_b = _inverse(row_a)
        best_neg, best_idx = _merge_topk(best_neg, best_idx, neg_b.T[inv_b],
                                         ids_b.T[inv_b], k)
    return best_neg, best_idx, pts_a_rows, am, perm_a


def knn_window_cross(db_points: torch.Tensor, db_mask: torch.Tensor,
                     queries: torch.Tensor, query_mask: Optional[torch.Tensor],
                     k: int = 1, *, tile: int = 256, n_passes: int = 2) -> KnnResult:
    """Approximate cross-set kNN via a Morton sort of the union: each
    query row's window holds its spatially near database points, with
    database membership as the candidate validity."""
    from ..kernels.knn_window import knn_window_tiles

    n_db, n_q = db_points.shape[0], queries.shape[0]
    dev = db_points.device
    pts = torch.cat([db_points.to(torch.float32), queries.to(torch.float32)])
    is_db = torch.cat([db_mask, torch.zeros(n_q, dtype=torch.bool, device=dev)])
    any_valid = torch.cat([db_mask, query_mask if query_mask is not None
                           else torch.ones(n_q, dtype=torch.bool, device=dev)])
    n = n_db + n_q
    n_pad = padding.round_up(n, tile)
    kk = min(k, 3 * tile)
    best_neg = best_idx = None
    for p in range(n_passes):
        perm = _sort_perm(morton.morton_keys(pts, any_valid, pass_index=p))
        neg, idx = knn_window_tiles(
            _pad_rows(pts[perm], n_pad).T.contiguous(),
            _pad_rows(is_db[perm], n_pad, False).to(torch.float32)[None],
            _pad_rows(perm.to(torch.int32), n_pad)[None], kk, tile)
        rows = _inverse(perm)[n_db:]            # sorted row of each query
        q_neg, q_idx = neg.T[rows], idx.T[rows]
        if p == 0:
            best_neg, best_idx = q_neg, q_idx
        else:
            best_neg, best_idx = _merge_topk(best_neg, best_idx, q_neg, q_idx, k)

    d2 = -best_neg
    valid = torch.isfinite(d2)
    if query_mask is not None:
        valid = valid & query_mask[:, None]
    dist = torch.sqrt(torch.where(valid, d2, torch.inf))
    return KnnResult(best_idx.long().clamp(0, n_db - 1),
                     torch.where(valid, dist, torch.inf), valid)


# ---------------------------------------------------------------------------
# grid-pruned kNN
# ---------------------------------------------------------------------------

def estimate_cell_size(points: torch.Tensor, mask: torch.Tensor, k: int) -> float:
    """Heuristic cell size for ``knn_grid``, aiming at about k points a
    cell: the median face area of the valid points' bounding box over
    the point count gives a surface spacing (scans lie near 2-D
    manifolds), scaled by √max(k, 4). Computed on the host, as the JAX
    package does, so both give the same float."""
    pts = points.detach().cpu().numpy()
    pts = pts[mask.detach().cpu().numpy()]
    n = max(len(pts), 1)
    mn, mx = pts.min(0), pts.max(0)
    ext = np.maximum(mx - mn, 1e-6)
    area = np.median([ext[0] * ext[1], ext[0] * ext[2], ext[1] * ext[2]])
    spacing = float(np.sqrt(area / n))
    return max(spacing * max(k, 4) ** 0.5, 1e-6)


def knn_grid(db_points: torch.Tensor, db_mask: torch.Tensor,
             queries: torch.Tensor, query_mask: Optional[torch.Tensor],
             k: int, cell_size, *, cap_per_cell: int = 16, ring: int = 1,
             exclude_self: bool = False, query_chunk: int = 32768) -> KnnResult:
    """Voxel-grid-pruned kNN: the candidates of each query are the points
    of the (2·ring+1)³ cells around it, at most ``cap_per_cell`` a cell
    (a fuller cell is truncated in sorted order). Exact for neighbours
    within ``ring · cell_size``; farther ones can be missed (the slot is
    then masked). d² is dx² + dy² + dz², each product and sum rounded to
    fp32, so the card and the CPU form the same d² (the card's sqrt may
    round a distance's last bit differently); ``torch.topk`` keeps the k
    smallest, and ties may be ordered differently from the JAX package's
    ``lax.top_k`` (lower position first)."""
    db_points = db_points.to(torch.float32)
    queries = queries.to(torch.float32)
    grid = voxel_hash.build_voxel_grid(db_points, db_mask, cell_size)
    nq = queries.shape[0]
    negs, idxs = [], []
    for c0 in range(0, nq, query_chunk):
        q = queries[c0:c0 + query_chunk]
        cand_idx, cand_ok = grid.gather_neighbors(q, cap_per_cell, ring)
        diff = q[:, None, :] - db_points[cand_idx]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        neg = torch.where(cand_ok, -d2, -torch.inf)
        if exclude_self:
            rows = torch.arange(c0, c0 + q.shape[0], device=q.device)
            neg = torch.where(cand_idx == rows[:, None], -torch.inf, neg)
        kk = min(k, neg.shape[1])
        top_neg, pos = torch.topk(neg, kk, dim=1)
        top_idx = torch.gather(cand_idx, 1, pos)
        if kk < k:
            top_neg = torch.nn.functional.pad(top_neg, (0, k - kk), value=-torch.inf)
            top_idx = torch.nn.functional.pad(top_idx, (0, k - kk))
        negs.append(top_neg)
        idxs.append(top_idx)
    d2 = -torch.cat(negs)
    valid = torch.isfinite(d2)
    if query_mask is not None:
        valid = valid & query_mask[:, None]
    idx = torch.cat(idxs).clamp(0, db_points.shape[0] - 1)
    dist = torch.sqrt(torch.where(valid, d2, torch.inf))
    return KnnResult(idx, dist, valid)


# ---------------------------------------------------------------------------
# object-style wrappers of the reference's search types
# ---------------------------------------------------------------------------

class BruteForceSearch:
    """NearestNeighborSearch over a PointCloud (the reference's
    traits.rs:541-547): the exact blockwise search of ``knn`` and
    ``radius_neighbors``, queries moved to the cloud's device."""

    def __init__(self, cloud):
        self.cloud = cloud

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.cloud.device)
        return q.reshape(1, -1) if q.ndim == 1 else q

    def find_k_nearest(self, queries, k: int, **kw) -> KnnResult:
        return knn(self.cloud.points, self.cloud.mask, self._queries(queries), None, k,
                   **kw)

    def find_radius_neighbors(self, queries, radius: float,
                              max_neighbors: int = 64, **kw) -> KnnResult:
        return radius_neighbors(self.cloud.points, self.cloud.mask,
                                self._queries(queries), None, radius, max_neighbors,
                                **kw)


# The reference's primary index type is `KdTree`; the name is kept as an
# alias so ported user code works, over the same exact blockwise search.
KdTree = BruteForceSearch
