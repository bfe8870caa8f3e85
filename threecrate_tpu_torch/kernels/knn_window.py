"""Morton-window k-nearest neighbours over prev/self/next tiles.

``knn_window_tiles`` replaces the Pallas kernel of the same name in
``threecrate_tpu/kernels/knn_pallas.py`` (body ``_kernel``). On a CUDA
tensor it launches the hand-written kernel of ``csrc/knn_window.cu``; on
a CPU tensor it runs ``knn_window_plain``, which computes the same
function and is what the kernel is checked against.

Inputs are Morton-sorted and padded to a multiple of ``tile``:
coordinates ``(3, N)`` float32, validity ``(1, N)`` float32 and each
column's original id ``(1, N)`` int32. Each query scans the 3·tile
columns of its prev/self/next tiles, as the Pallas BlockSpecs cut them
(the prev tile of tile 0 and the next tile of the last tile are the edge
tile itself, masked invalid). It returns the k best columns ordered by
(−d² descending, column ascending), with −inf for invalid columns and,
under ``exclude_self``, for the query's own id; the outputs are −d²
``(k, N)`` float32, ids ``(k, N)`` int32 and, ``with_coords``, the
chosen coordinates ``(3k, N)`` (rows 3j..3j+2 for slot j). Slots left
at −inf report window column 0, as the Pallas kernel's later rounds pick
it again once the finite candidates are used up.

d² is (dx·dx + dy·dy) + dz·dz with dx = q − c, every operation rounded
on its own in the kernel and here, so both give the same bits and pick
the same neighbours. On the card k <= 16 runs one query a thread with a
register list, larger k one query a warp with a sorted list of keys
(see ``csrc/knn_window.cu``).
"""

from __future__ import annotations

import torch

from . import _build
from .knn import _window

KMAX = 128          # largest k the CUDA kernel is instantiated for
_CHUNK_TILES = 32   # query tiles per step of the plain version


def _check(sorted_pts_t, sorted_valid, sorted_ids, k, tile):
    n = sorted_pts_t.shape[1]
    if (sorted_pts_t.shape != (3, n) or sorted_valid.shape != (1, n)
            or sorted_ids.shape != (1, n)):
        raise ValueError("expected (3, N) points, (1, N) validity and (1, N) ids, got "
                         f"{tuple(sorted_pts_t.shape)}, {tuple(sorted_valid.shape)} and "
                         f"{tuple(sorted_ids.shape)}")
    if tile <= 0 or tile & (tile - 1) or tile > 1024 or n == 0 or n % tile:
        raise ValueError(f"tile must be a power of two <= 1024 dividing N={n}, "
                         f"got {tile}")
    if not 1 <= k <= min(KMAX, 3 * tile):
        raise ValueError(f"k must be in [1, min({KMAX}, 3·tile = {3 * tile})], got {k}")
    if sorted_pts_t.dtype != torch.float32 or sorted_valid.dtype != torch.float32:
        raise TypeError("points and validity must be float32")
    if sorted_ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {sorted_ids.dtype}")
    for t in (sorted_valid, sorted_ids):
        if t.device != sorted_pts_t.device:
            raise ValueError("all inputs must be on one device")
    return n


def _clamped_window(row, t0, t1, tile, n_t):
    """(..., T, 3·tile) prev/self/next columns of query tiles t0..t1-1,
    the tile index clamped to [0, n_t) as the Pallas BlockSpecs clamp it."""
    j = torch.arange(3 * tile, device=row.device)
    tiles = torch.arange(t0, t1, device=row.device)
    ct = (tiles[:, None] - 1 + j // tile).clamp(0, n_t - 1)
    return row[..., ct * tile + j % tile]


def knn_window_plain(sorted_pts_t, sorted_valid, sorted_ids, k: int, tile: int = 256,
                     with_coords: bool = False, exclude_self: bool = False):
    """Plain PyTorch version, chunked over query tiles: the masked
    (T, tile, 3·tile) −d², a stable descending sort, the first k."""
    n = _check(sorted_pts_t, sorted_valid, sorted_ids, k, tile)
    n_t = n // tile
    dev = sorted_pts_t.device
    neg_out = torch.empty((k, n), dtype=torch.float32, device=dev)
    idx_out = torch.empty((k, n), dtype=torch.int32, device=dev)
    crd_out = torch.empty((3 * k, n), dtype=torch.float32, device=dev) if with_coords else None
    for t0 in range(0, n_t, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n_t)
        sl = slice(t0 * tile, t1 * tile)
        ok = _window(sorted_valid[0], t0, t1, tile, 0.0) > 0.5        # (T, W)
        cand = _clamped_window(sorted_pts_t, t0, t1, tile, n_t)       # (3, T, W)
        cid = _clamped_window(sorted_ids[0], t0, t1, tile, n_t)       # (T, W)
        q = sorted_pts_t[:, sl].reshape(3, t1 - t0, tile)
        d = [q[r][:, :, None] - cand[r][:, None, :] for r in range(3)]
        neg = torch.where(ok[:, None, :], -(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]),
                          -torch.inf)
        if exclude_self:
            own = sorted_ids[0, sl].reshape(t1 - t0, tile)
            neg = torch.where(cid[:, None, :] == own[:, :, None], -torch.inf, neg)
        vals, cols = torch.sort(neg, dim=-1, descending=True, stable=True)
        vals = vals[..., :k]
        cols = torch.where(vals == -torch.inf, 0, cols[..., :k])      # (T, tile, k)
        neg_out[:, sl] = vals.reshape(-1, k).T
        idx_out[:, sl] = torch.gather(cid[:, None, :].expand(-1, tile, -1), 2,
                                      cols).reshape(-1, k).T
        if with_coords:
            crd = torch.stack([torch.gather(cand[r][:, None, :].expand(-1, tile, -1), 2,
                                            cols) for r in range(3)], -1)
            crd_out[:, sl] = crd.reshape(-1, 3 * k).T
    return (neg_out, idx_out, crd_out) if with_coords else (neg_out, idx_out)


def knn_window_tiles(sorted_pts_t, sorted_valid, sorted_ids, k: int, tile: int = 256,
                     with_coords: bool = False, exclude_self: bool = False):
    """Window kNN: ``(−d² (k, N), ids (k, N) int32)``, plus the
    coordinates ``(3k, N)`` when ``with_coords``, in sorted order."""
    if not _build.on_card(sorted_pts_t):
        return knn_window_plain(sorted_pts_t, sorted_valid, sorted_ids, k, tile,
                                with_coords, exclude_self)
    n = _check(sorted_pts_t, sorted_valid, sorted_ids, k, tile)
    pts = sorted_pts_t.contiguous()
    valid = sorted_valid.contiguous()
    ids = sorted_ids.contiguous()
    neg = torch.empty((k, n), dtype=torch.float32, device=pts.device)
    idx = torch.empty((k, n), dtype=torch.int32, device=pts.device)
    crd = torch.empty((3 * k if with_coords else 1, n), dtype=torch.float32,
                      device=pts.device)
    with torch.cuda.device(pts.device):
        err = _build.lib().tc_knn_window(
            pts.data_ptr(), valid.data_ptr(), ids.data_ptr(), neg.data_ptr(),
            idx.data_ptr(), crd.data_ptr(), n, tile, k, int(with_coords),
            int(exclude_self), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn_window")
    knn_window_tiles.launches += 1
    shape = (k, bool(with_coords), bool(exclude_self))
    knn_window_tiles.shape_launches[shape] = knn_window_tiles.shape_launches.get(shape, 0) + 1
    return (neg, idx, crd) if with_coords else (neg, idx)


knn_window_tiles.launches = 0
# launches by (k, with_coords, exclude_self), reset with ``launches``
knn_window_tiles.shape_launches = {}
