"""Union-window normal sums: the two passes of the default normals path.

``window_union_a_tiles`` and ``window_union_b_tiles`` replace the Pallas
kernels of the same names in ``threecrate_tpu/kernels/knn_pallas.py``
(bodies ``_union_a_kernel`` and ``_union_b_kernel``). On a CUDA tensor
they launch the hand-written kernels of ``csrc/union_window.cu``; on a
CPU tensor they run the plain PyTorch versions below, which compute the
same function and are what the kernels are checked against.

Inputs are Morton-sorted, transposed and padded to a multiple of
``tile``: coordinates ``(3, N)`` float32, validity ``(1, N)`` float32,
and for pass B each column's pass-A position ``(1, N)`` int32 and each
query's pass-A radius ``(1, N)`` float32. Outputs are ``(11, N)``
float32 in the same order: pass A ``[cnt, S1 (3), S2 (6), hiA]``, pass B
``[S_out (10), use_b]``, with S1 = Σ(c − q) and S2 = Σ(c − q)(c − q)ᵀ
ordered xx, yy, zz, xy, xz, yz over each query's selected candidates.

On the card these are fp32 ALU-bound scans: 8 sweeps of the 768-point
window per query from shared memory, with little device-memory
traffic (see the source note in ``csrc/union_window.cu``).
"""

from __future__ import annotations

import torch

from . import _build

_KMAX = 64          # largest k the CUDA kernels are instantiated for
_CHUNK_TILES = 32   # query tiles per step of the plain versions


def _check(sorted_pts_t, sorted_valid, k, tile, band, extra=()):
    n = sorted_pts_t.shape[1]
    if sorted_pts_t.shape != (3, n) or sorted_valid.shape != (1, n):
        raise ValueError("expected (3, N) points and (1, N) validity, got "
                         f"{tuple(sorted_pts_t.shape)} and {tuple(sorted_valid.shape)}")
    if tile <= 0 or tile & (tile - 1) or tile > 1024 or n == 0 or n % tile:
        raise ValueError(f"tile must be a power of two <= 1024 dividing N={n}, "
                         f"got {tile}")
    band = max(band, k)
    if band > tile:
        raise ValueError(f"band {band} exceeds the tile {tile}")
    if not 1 <= k <= _KMAX:
        raise ValueError(f"k must be in [1, {_KMAX}], got {k}")
    for t in (sorted_pts_t, sorted_valid, *extra):
        if t.device != sorted_pts_t.device:
            raise ValueError("all inputs must be on one device")
    return n, band


def _window(row: torch.Tensor, t0: int, t1: int, tile: int, fill):
    """(..., T, 3·tile) prev/self/next columns of query tiles t0..t1-1
    of a (..., N) array, with the columns before the first and after the
    last tile set to ``fill``."""
    n = row.shape[-1]
    tiles = torch.arange(t0, t1, device=row.device)
    cols = (tiles[:, None] - 1) * tile + torch.arange(3 * tile, device=row.device)
    inside = (cols >= 0) & (cols < n)
    return torch.where(inside, row[..., cols.clamp(0, n - 1)], fill)


def _band_bound_plain(d2v: torch.Tensor, k: int, band: int, tile: int):
    """Per query (T, tile): the k-th smallest d² among the ±band sorted
    neighbours, tightened by 6 bisection rounds against the full window
    count, clamped to the largest finite fp32."""
    offs = torch.arange(-band, band + 1, device=d2v.device)
    cols = tile + torch.arange(tile, device=d2v.device)[:, None] + offs
    bd = torch.gather(d2v, 2, cols.expand(d2v.shape[0], tile, 2 * band + 1))
    hi = torch.kthvalue(bd, k, dim=2).values
    lo = torch.zeros_like(hi)
    for _ in range(6):
        mid = 0.5 * (lo + hi)
        ge = (d2v <= mid[..., None]).sum(2) >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    return torch.clamp_max(hi, 3.4e38)


def _chunk_geometry(pts_t, valid, t0, t1, tile):
    """Query-relative offsets (T, tile, 3·tile) and masked squared
    distances of one chunk of query tiles."""
    ok = _window(valid[0], t0, t1, tile, 0.0) > 0.5
    q = pts_t[:, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    d = [_window(pts_t[r], t0, t1, tile, 0.0)[:, None, :] - q[r][:, :, None]
         for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, torch.where(ok[:, None, :], d2, torch.inf)


def _central_sums(sel: torch.Tensor, d):
    dx, dy, dz = (torch.where(sel, c, 0.0) for c in d)
    return [sel.sum(2, dtype=torch.float32), dx.sum(2), dy.sum(2), dz.sum(2),
            (dx * dx).sum(2), (dy * dy).sum(2), (dz * dz).sum(2),
            (dx * dy).sum(2), (dx * dz).sum(2), (dy * dz).sum(2)]


def window_union_a_plain(sorted_pts_t, sorted_valid, k: int, tile: int = 256,
                         band: int = 16) -> torch.Tensor:
    """Plain PyTorch pass A, chunked over query tiles."""
    n, band = _check(sorted_pts_t, sorted_valid, k, tile, band)
    out = torch.empty((11, n), dtype=torch.float32, device=sorted_pts_t.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2v = _chunk_geometry(sorted_pts_t, sorted_valid, t0, t1, tile)
        hi = _band_bound_plain(d2v, k, band, tile)
        rows = _central_sums(d2v <= hi[..., None], d) + [hi]
        out[:, t0 * tile:t1 * tile] = torch.stack(rows).reshape(11, -1)
    return out


def window_union_b_plain(sorted_pts_t, sorted_valid, sorted_pos_a, hi_a,
                         k: int, tile: int = 256, band: int = 16) -> torch.Tensor:
    """Plain PyTorch pass B, chunked over query tiles."""
    n, band = _check(sorted_pts_t, sorted_valid, k, tile, band,
                     (sorted_pos_a, hi_a))
    shift = tile.bit_length() - 1
    out = torch.empty((11, n), dtype=torch.float32, device=sorted_pts_t.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2v = _chunk_geometry(sorted_pts_t, sorted_valid, t0, t1, tile)
        hib = _band_bound_plain(d2v, k, band, tile)
        # pass-A window membership: tile index = posA >> log2(tile)
        tile_c = _window(sorted_pos_a[0], t0, t1, tile, 0) >> shift
        tile_q = sorted_pos_a[0, t0 * tile:t1 * tile].reshape(-1, tile) >> shift
        dtile = tile_c[:, None, :] - tile_q[:, :, None]
        in_win_a = (dtile >= -1) & (dtile <= 1)
        hia = hi_a[0, t0 * tile:t1 * tile].reshape(-1, tile)
        use_b = hib < hia
        sel = torch.where(use_b[..., None], d2v <= hib[..., None],
                          (d2v <= hia[..., None]) & ~in_win_a)
        rows = _central_sums(sel, d) + [use_b.to(torch.float32)]
        out[:, t0 * tile:t1 * tile] = torch.stack(rows).reshape(11, -1)
    return out


def _contig_f32(t):
    if t.dtype != torch.float32:
        raise TypeError(f"expected float32, got {t.dtype}")
    return t.contiguous()


def window_union_a_tiles(sorted_pts_t, sorted_valid, k: int, tile: int = 256,
                         band: int = 16) -> torch.Tensor:
    """Union pass A: ``(11, N)`` query-centred central sums plus the
    selection radius, in sorted order."""
    if not _build.on_card(sorted_pts_t):
        return window_union_a_plain(sorted_pts_t, sorted_valid, k, tile, band)
    n, band = _check(sorted_pts_t, sorted_valid, k, tile, band)
    pts = _contig_f32(sorted_pts_t)
    valid = _contig_f32(sorted_valid)
    out = torch.empty((11, n), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        err = _build.lib().tc_union_window_a(
            pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n, tile, k, band,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "union_window_a")
    window_union_a_tiles.launches += 1
    return out


def window_union_b_tiles(sorted_pts_t, sorted_valid, sorted_pos_a, hi_a,
                         k: int, tile: int = 256, band: int = 16) -> torch.Tensor:
    """Union pass B: ``(11, N)`` blended sums plus the ``use_b`` flag,
    in pass-B sorted order."""
    if not _build.on_card(sorted_pts_t):
        return window_union_b_plain(sorted_pts_t, sorted_valid, sorted_pos_a,
                                    hi_a, k, tile, band)
    n, band = _check(sorted_pts_t, sorted_valid, k, tile, band,
                     (sorted_pos_a, hi_a))
    if sorted_pos_a.shape != (1, n) or sorted_pos_a.dtype != torch.int32:
        raise TypeError("sorted_pos_a must be (1, N) int32")
    pts = _contig_f32(sorted_pts_t)
    valid = _contig_f32(sorted_valid)
    pos = sorted_pos_a.contiguous()
    hia = _contig_f32(hi_a)
    if hia.shape != (1, n):
        raise ValueError(f"hi_a must be (1, {n}), got {tuple(hia.shape)}")
    out = torch.empty((11, n), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        err = _build.lib().tc_union_window_b(
            pts.data_ptr(), valid.data_ptr(), pos.data_ptr(), hia.data_ptr(),
            out.data_ptr(), n, tile, k, band, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "union_window_b")
    window_union_b_tiles.launches += 1
    return out


window_union_a_tiles.launches = 0
window_union_b_tiles.launches = 0
