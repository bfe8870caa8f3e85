"""Union-window normal sums (the two passes of the default normals path)
and the fused window normals of ``method="window_fast"``.

``window_union_a_tiles``, ``window_union_b_tiles`` and
``window_normals_tiles`` replace the Pallas kernels of the same names in
``threecrate_tpu/kernels/knn_pallas.py`` (bodies ``_union_a_kernel``,
``_union_b_kernel``, ``_moments_kernel`` and ``_moments_band_kernel``).
On a CUDA tensor they launch the hand-written kernels of
``csrc/union_window.cu``; on a CPU tensor they run the plain PyTorch
versions below, which compute the same function and are what the
kernels are checked against.

Inputs are Morton-sorted, transposed and padded to a multiple of
``tile``: coordinates ``(3, N)`` float32, validity ``(1, N)`` float32,
and for pass B each column's pass-A position ``(1, N)`` int32 and each
query's pass-A radius ``(1, N)`` float32. Outputs are ``(11, N)``
float32 in the same order: pass A ``[cnt, S1 (3), S2 (6), hiA]``, pass B
``[S_out (10), use_b]``, with S1 = Σ(c − q) and S2 = Σ(c − q)(c − q)ᵀ
ordered xx, yy, zz, xy, xz, yz over each query's selected candidates.

``window_normals_tiles`` returns ``(6, N)`` rows ``[nx, ny, nz,
curvature, count, k-th]`` per query: with ``band=0`` the k nearest valid
window columns (ties to the lowest column) and their query-centred
covariance, the k-th row the k-th −d²; with ``band > 0`` every column
within the union passes' band bound at half-width max(band, k), the
covariance from raw moments in the frame of the tile centre (the mean of
the tile's valid queries), the k-th row −hi. Both end in the Pallas
body's 4-sweep Jacobi eigensolve (``_jacobi_normal``). The selection
sums are taken in float64 and rounded once to fp32, here and in the
kernel, so the two agree bit for bit unless a float64 sum lands within
2^-53 of an fp32 rounding boundary; every fp32 operation after them is
the Pallas body's, unfused, in its order.

On the card these are issue-bound scans of the 768-point window from
shared memory, with little device-memory traffic: the union passes and
``window_normals_tiles``' band body make 2 sweeps per query, its exact
body 1 (see the source note in ``csrc/union_window.cu``).
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


def _jacobi_normal(cxx, cyy, czz, cxy, cxz, cyz):
    """Smallest eigenpair of symmetric 3x3 covariances by 4 cyclic Jacobi
    sweeps on the trace-scaled matrix, operation for operation as
    ``_normal_from_cov_lanes`` of ``knn_pallas.py``: ``(nx, ny, nz,
    curvature = λ0/Σλ)``."""
    trace = torch.clamp_min(cxx + cyy + czz, 1e-12)
    a00, a11, a22 = cxx / trace, cyy / trace, czz / trace
    a01, a02, a12 = cxy / trace, cxz / trace, cyz / trace
    one, zero = torch.ones_like(a00), torch.zeros_like(a00)
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def rot(apq, theta_den):
        theta = theta_den / (2.0 * torch.where(apq == 0.0, one, apq))
        sgn = torch.where(theta >= 0.0, one, -one)
        t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
        t = torch.where(apq.abs() > 1e-30, t, zero)
        c = one / torch.sqrt(t * t + 1.0)
        return t, c, t * c

    def turn(x, y, c, s):
        return c * x - s * y, s * x + c * y

    for _ in range(4):
        t, c, s = rot(a01, a11 - a00)                    # pivot (0, 1)
        a00, a11, a01 = a00 - t * a01, a11 + t * a01, zero
        a02, a12 = turn(a02, a12, c, s)
        for row in v:
            row[0], row[1] = turn(row[0], row[1], c, s)
        t, c, s = rot(a02, a22 - a00)                    # pivot (0, 2)
        a00, a22, a02 = a00 - t * a02, a22 + t * a02, zero
        a01, a12 = turn(a01, a12, c, s)
        for row in v:
            row[0], row[2] = turn(row[0], row[2], c, s)
        t, c, s = rot(a12, a22 - a11)                    # pivot (1, 2)
        a11, a22, a12 = a11 - t * a12, a22 + t * a12, zero
        a01, a02 = turn(a01, a02, c, s)
        for row in v:
            row[1], row[2] = turn(row[1], row[2], c, s)

    m0 = (a00 <= a11) & (a00 <= a22)
    m1 = ~m0 & (a11 <= a22)

    def pick(x0, x1, x2):
        return torch.where(m0, x0, torch.where(m1, x1, x2))

    vx, vy, vz = (pick(*row) for row in v)
    inv = one / torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-30))
    return vx * inv, vy * inv, vz * inv, torch.clamp_min(pick(a00, a11, a22), 0.0)


def _normal_rows(g, last):
    """The 6 output rows from the 10 selection sums ``g`` (..., 10)
    float64 [count, S1 (3), S2 (6)]: each sum rounded once to fp32, the
    covariance E[dd] − E[d]E[d], the eigensolve, then count and ``last``."""
    g = g.to(torch.float32).unbind(-1)
    cnt = g[0]
    nn = torch.clamp_min(cnt, 1e-12)
    ex, ey, ez = g[1] / nn, g[2] / nn, g[3] / nn
    nx, ny, nz, curv = _jacobi_normal(
        g[4] / nn - ex * ex, g[5] / nn - ey * ey, g[6] / nn - ez * ez,
        g[7] / nn - ex * ey, g[8] / nn - ex * ez, g[9] / nn - ey * ez)
    return torch.stack([nx, ny, nz, curv, cnt, last])


def _moment_features(x, y, z):
    """(..., 10) [1, x, y, z, xx, yy, zz, xy, xz, yz], each product fp32."""
    return torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                        x * y, x * z, y * z], -1)


def window_normals_plain(sorted_pts_t, sorted_valid, k: int, tile: int = 256,
                         band: int = 0) -> torch.Tensor:
    """Plain PyTorch ``window_normals_tiles``, chunked over query tiles."""
    n, band_k = _check(sorted_pts_t, sorted_valid, k, tile, band)
    f64 = torch.float64
    out = torch.empty((6, n), dtype=torch.float32, device=sorted_pts_t.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2v = _chunk_geometry(sorted_pts_t, sorted_valid, t0, t1, tile)
        if band == 0:
            # k max-extraction rounds = the first k of a stable descending sort
            vals, cols = torch.sort(-d2v, dim=-1, descending=True, stable=True)
            top, cols = vals[..., :k], cols[..., :k]
            good = top > -torch.inf
            sel = [torch.where(good, torch.gather(c, 2, cols), 0.0) for c in d]
            feats = _moment_features(*sel)
            feats[..., 0] = good.to(torch.float32)
            rows = _normal_rows(feats.sum(-2, dtype=f64), top[..., k - 1])
        else:
            hi = _band_bound_plain(d2v, k, band_k, tile)
            sv = sorted_valid[0, t0 * tile:t1 * tile].reshape(-1, tile)
            q = sorted_pts_t[:, t0 * tile:t1 * tile].reshape(3, -1, tile)
            nq = torch.clamp_min(sv.sum(-1, dtype=f64).to(torch.float32), 1.0)
            cc = [_window(sorted_pts_t[r], t0, t1, tile, 0.0)
                  - ((q[r] * sv).sum(-1, dtype=f64).to(torch.float32) / nq)[:, None]
                  for r in range(3)]
            sel = (d2v <= hi[..., None]).to(f64)
            g = torch.matmul(sel, _moment_features(*cc).to(f64))    # (T, tile, 10)
            rows = _normal_rows(g, -hi)
        out[:, t0 * tile:t1 * tile] = rows.reshape(6, -1)
    return out


def window_normals_tiles(sorted_pts_t, sorted_valid, k: int, tile: int = 256,
                         band: int = 0) -> torch.Tensor:
    """Fused window normals: ``(6, N)`` rows ``[nx, ny, nz, curvature,
    count, k-th]`` in sorted order (``band=0`` exact window k-NN, else the
    band-bounded selection at half-width max(band, k))."""
    if not _build.on_card(sorted_pts_t):
        return window_normals_plain(sorted_pts_t, sorted_valid, k, tile, band)
    n, _ = _check(sorted_pts_t, sorted_valid, k, tile, band)
    pts = _contig_f32(sorted_pts_t)
    valid = _contig_f32(sorted_valid)
    out = torch.empty((6, n), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        err = _build.lib().tc_window_normals(
            pts.data_ptr(), valid.data_ptr(), out.data_ptr(), n, tile, k,
            max(band, k) if band else 0, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "window_normals")
    window_normals_tiles.launches += 1
    return out


window_union_a_tiles.launches = 0
window_union_b_tiles.launches = 0
window_normals_tiles.launches = 0
