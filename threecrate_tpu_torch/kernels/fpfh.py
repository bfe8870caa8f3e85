"""Fused FPFH window kernels: in-window SPFH histograms and the weighted
neighbour-SPFH sum, each in two passes.

``spfh_a_tiles``, ``spfh_b_tiles``, ``fpfh_weight_a_tiles``,
``fpfh_weight_b_tiles``, ``spfh_band_a_tiles`` and ``spfh_band_b_tiles``
replace the Pallas kernels of the same names in
``threecrate_tpu/kernels/fpfh_pallas.py`` (bodies ``_pair_hist``,
``_weight_body`` and ``_spfh_band_body``). On a CUDA tensor they launch
the hand-written kernels of ``csrc/fpfh.cu``; on a CPU tensor they run
the plain PyTorch versions below, which compute the same function and
are what the kernels are checked against.

Inputs are Morton-sorted and padded to a multiple of ``tile`` (a power
of two): stage 1 packs ``(7, N)`` float32 rows [x, y, z, valid, nx, ny,
nz], stage 2 ``(37, N)`` rows [x, y, z, valid, spfh (33)]; pass B also
takes each column's pass-A position ``(1, N)`` int32. Each query scans
the prev/self/next tiles of its own (3·tile candidates) and selects
``valid & d² <= r2 & d² > 1e-12``; pass B further drops candidates
whose pass-A tile is within ±1 of the query's, so the two passes' sums
add up to the two-window union. Outputs are ``(34, N)`` float32 in the
same order: stage 1 [θ bins (11), cos φ bins (11), cos α bins (11),
count], stage 2 [Σ (1/d)·spfh (33), count].

The banded stage 1 (``band="auto"``'s rungs) scans only the sorted
positions p−band … p+band (band ≤ tile, so all inside the 3-tile
window; positions outside [0, N) are invalid). Its pass B takes ``(8,
N)`` rows, the 7 plus each column's pass-A position as fp32, and drops
candidates with |posA_c − posA_q| ≤ band, compared in fp32 as the Pallas
body does.

``r2`` is rounded once to fp32. Every operation of the pair features
is evaluated unfused and in the same order in the kernels and here (a
correctly rounded 1/sqrt, no FMA contraction), so the histogram and
count rows of kernel and plain version are equal bit for bit; the
stage-2 sums differ only by summation order.

On the card these are scans of the 3·tile window candidates of each
query from shared memory, past the 16-column chunks whose bounding box
lies beyond r2; stage 1 only selects in its scan and votes the selected
pairs a warp at a time from a per-warp queue (see the source note in
``csrc/fpfh.cu``). The banded stage 1 stages only each tile's ±band
span and votes through the same queue: a warp tests its queries'
neighbours eight offsets a step and only selects.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import fp32_matmul
from . import _build
from .knn import _window

N_BINS = 11
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))
_THETA_SCALE = float(np.float32(N_BINS) / np.float32(2 * np.pi))
_COS_SCALE = N_BINS / 2.0
_CHUNK_TILES = 32     # query tiles per step of the plain versions


def _check(packed, rows, tile, pos_a=None):
    n = packed.shape[1]
    if packed.ndim != 2 or packed.shape[0] != rows:
        raise ValueError(f"expected ({rows}, N) packed rows, got {tuple(packed.shape)}")
    if tile <= 0 or tile & (tile - 1) or tile > 1024 or n == 0 or n % tile:
        raise ValueError(f"tile must be a power of two <= 1024 dividing N={n}, "
                         f"got {tile}")
    if pos_a is not None:
        if pos_a.shape != (1, n) or pos_a.dtype != torch.int32:
            raise TypeError(f"pos_a must be (1, {n}) int32")
        if pos_a.device != packed.device:
            raise ValueError("all inputs must be on one device")
    return n


def _r2_f32(r2) -> float:
    """The squared radius rounded once to fp32, as a Python float that
    compares with fp32 tensors exactly."""
    return float(np.float32(r2))


def _rsqrt(x):
    """1/sqrt(max(x, 1e-24)), correctly rounded in two steps (a true
    division, not ``torch.rsqrt``'s approximation)."""
    x = torch.clamp_min(x, 1e-24)
    return torch.ones_like(x) / torch.sqrt(x)


def atan2_approx(y, x):
    """``_atan2_approx`` of the Pallas module: quadrant-corrected odd
    minimax atan polynomial, max error ~5e-3 rad."""
    ax, ay = x.abs(), y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp_min(hi, 1e-30)
    z2 = z * z
    t = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (
        -0.0851330 + z2 * 0.0208351))))
    t = torch.where(ay > ax, _HALF_PI - t, t)
    t = torch.where(x < 0, _PI - t, t)
    return torch.where(y < 0, -t, t)


def _bins(v, scale):
    """fp32 feature → bin: truncation toward zero, clipped to [0, 10]."""
    return (v * scale).to(torch.int32).clamp(0, N_BINS - 1).long()


def _chunk_geometry(packed, t0, t1, tile, r2, pos_a):
    """Query-relative offsets (3 × (T, tile, 3·tile)), d² and the
    selection of one chunk of query tiles."""
    ok = _window(packed[3], t0, t1, tile, 0.0) > 0.5
    q = packed[0:3, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    cand = _window(packed[0:3], t0, t1, tile, 0.0)
    d = [cand[r][:, None, :] - q[r][:, :, None] for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    sel = ok[:, None, :] & (d2 <= r2) & (d2 > 1e-12)
    if pos_a is not None:
        # pass-A window membership: tile index = posA >> log2(tile)
        shift = tile.bit_length() - 1
        tile_c = _window(pos_a[0], t0, t1, tile, 0) >> shift
        tile_q = pos_a[0, t0 * tile:t1 * tile].reshape(-1, tile) >> shift
        dtile = tile_c[:, None, :] - tile_q[:, :, None]
        sel = sel & ((dtile < -1) | (dtile > 1))
    return d, d2, sel


def _pair_hist(packed, t0, t1, tile, d, d2, sel):
    """(T, tile, 34) SPFH votes + count of one chunk: ``_pair_hist`` of
    the Pallas module, one tensor op per scalar operation."""
    qn = packed[4:7, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    cn = _window(packed[4:7], t0, t1, tile, 0.0)
    return _votes(d, d2, sel, [qn[j][:, :, None] for j in range(3)],
                  [cn[j][:, None, :] for j in range(3)])


def _votes(d, d2, sel, qn, cn):
    """(..., 34) votes + count over the last (candidate) axis of the
    pair offsets ``d = c − q``, their d², the selection and the query
    and candidate normals (three tensors each, broadcast to d)."""
    inv_d = _rsqrt(d2)
    ux, uy, uz = (c * inv_d for c in d)
    q0, q1, q2 = qn
    c0, c1, c2 = cn
    a1 = q0 * ux + q1 * uy + q2 * uz
    a2 = c0 * ux + c1 * uy + c2 * uz
    swap = a1.abs() < a2.abs()
    nsx, nsy, nsz = (torch.where(swap, c, q) for c, q in ((c0, q0), (c1, q1), (c2, q2)))
    ntx, nty, ntz = (torch.where(swap, q, c) for c, q in ((c0, q0), (c1, q1), (c2, q2)))
    ux, uy, uz = (torch.where(swap, -u, u) for u in (ux, uy, uz))

    f3 = nsx * ux + nsy * uy + nsz * uz
    vx = uy * nsz - uz * nsy
    vy = uz * nsx - ux * nsz
    vz = ux * nsy - uy * nsx
    inv_v = _rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv_v, vy * inv_v, vz * inv_v
    wx = nsy * vz - nsz * vy
    wy = nsz * vx - nsx * vz
    wz = nsx * vy - nsy * vx
    f2 = vx * ntx + vy * nty + vz * ntz
    f1 = atan2_approx(wx * ntx + wy * nty + wz * ntz,
                      nsx * ntx + nsy * nty + nsz * ntz)

    wf = sel.to(torch.float32)
    shape = wf.shape[:-1] + (N_BINS,)
    hists = [torch.zeros(shape, device=wf.device).scatter_add_(-1, b, wf)
             for b in (_bins(f1 + _PI, _THETA_SCALE), _bins(f2 + 1.0, _COS_SCALE),
                       _bins(f3 + 1.0, _COS_SCALE))]
    return torch.cat(hists + [wf.sum(-1, keepdim=True)], -1)


def _weight_sums(packed, t0, t1, tile, d, d2, sel):
    """(T, tile, 34) Σ (1/d)·spfh over the selected candidates + count:
    ``_weight_body`` of the Pallas module, the sum as one fp32 matmul."""
    wgt = torch.where(sel, _rsqrt(d2), 0.0)                     # (T, tile, W)
    extra = _window(packed[4:37], t0, t1, tile, 0.0)            # (33, T, W)
    acc = fp32_matmul(wgt, extra.permute(1, 2, 0))              # (T, tile, 33)
    return torch.cat([acc, sel.sum(2, keepdim=True, dtype=torch.float32)], 2)


def _plain(packed, r2, tile, pos_a, rows, body):
    n = _check(packed, rows, tile, pos_a)
    r2 = _r2_f32(r2)
    out = torch.empty((34, n), dtype=torch.float32, device=packed.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2, sel = _chunk_geometry(packed, t0, t1, tile, r2, pos_a)
        res = body(packed, t0, t1, tile, d, d2, sel)
        out[:, t0 * tile:t1 * tile] = res.reshape(-1, 34).T
    return out


def spfh_a_plain(packed, r2: float, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch stage-1 pass A, chunked over query tiles."""
    return _plain(packed, r2, tile, None, 7, _pair_hist)


def spfh_b_plain(packed, pos_a, r2: float, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch stage-1 pass B, chunked over query tiles."""
    return _plain(packed, r2, tile, pos_a, 7, _pair_hist)


def fpfh_weight_a_plain(packed, r2: float, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch stage-2 pass A, chunked over query tiles."""
    return _plain(packed, r2, tile, None, 37, _weight_sums)


def fpfh_weight_b_plain(packed, pos_a, r2: float, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch stage-2 pass B, chunked over query tiles."""
    return _plain(packed, r2, tile, pos_a, 37, _weight_sums)


def _check_band(packed, rows, band, tile):
    n = _check(packed, rows, tile)
    if not 0 <= band <= tile:
        raise ValueError(f"band must be in [0, tile={tile}], got {band}")
    return n


def band_candidates(packed, c0, c1, band, r2, eps, pos_row=None):
    """Candidates of the queries c0 … c1−1 of a banded pass: (rows (R, Q,
    C), query rows (R, Q, 1), offsets d = c − q (3 × (Q, C)), d²,
    selection), C = 2·band + 1 sorted positions around each query. The
    selection is ``inside [0, N) & valid & d² <= r2 & d² > eps``; with
    ``pos_row`` it also drops candidates whose pass-A position (that row,
    fp32, exact below 2^24 rows) is within ``band`` of the query's."""
    n = packed.shape[1]
    dev = packed.device
    cols = (torch.arange(c0, c1, device=dev)[:, None]
            + torch.arange(-band, band + 1, device=dev))
    cand = packed[:, cols.clamp(0, n - 1)]
    q = packed[:, c0:c1, None]
    d = [cand[r] - q[r] for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    sel = ((cols >= 0) & (cols < n) & (cand[3] > 0.5)
           & (d2 <= r2) & (d2 > eps))
    if pos_row is not None:
        sel = sel & ((cand[pos_row] - q[pos_row]).abs() > band)
    return cand, q, d, d2, sel


def _spfh_band_plain(packed, r2, band, tile, excl):
    n = _check_band(packed, 8 if excl else 7, band, tile)
    r2 = _r2_f32(r2)
    out = torch.empty((34, n), dtype=torch.float32, device=packed.device)
    step = _CHUNK_TILES * tile
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        cand, q, d, d2, sel = band_candidates(packed, c0, c1, band, r2, 1e-12,
                                              7 if excl else None)
        out[:, c0:c1] = _votes(d, d2, sel, [q[r] for r in range(4, 7)],
                               [cand[r] for r in range(4, 7)]).T
    return out


def spfh_band_a_plain(packed, r2: float, band: int, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch banded stage-1 pass A, chunked over query tiles."""
    return _spfh_band_plain(packed, r2, band, tile, False)


def spfh_band_b_plain(packed, r2: float, band: int, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch banded stage-1 pass B, chunked over query tiles."""
    return _spfh_band_plain(packed, r2, band, tile, True)


def _launch_band(name, packed, r2, band, tile, rows):
    n = _check_band(packed, rows, band, tile)
    if packed.dtype != torch.float32:
        raise TypeError(f"expected float32 packed rows, got {packed.dtype}")
    packed = packed.contiguous()
    out = torch.empty((34, n), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = getattr(_build.lib(), "tc_" + name)(
            packed.data_ptr(), out.data_ptr(), n, tile, band, _r2_f32(r2),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def spfh_band_a_tiles(packed, r2: float, band: int, tile: int = 256) -> torch.Tensor:
    """Banded stage-1 pass A over ±band sorted positions: ``(34, N)``
    raw SPFH votes + in-radius counts."""
    if not _build.on_card(packed):
        return spfh_band_a_plain(packed, r2, band, tile)
    out = _launch_band("spfh_band_a", packed, r2, band, tile, 7)
    spfh_band_a_tiles.launches += 1
    return out


def spfh_band_b_tiles(packed, r2: float, band: int, tile: int = 256) -> torch.Tensor:
    """Banded stage-1 pass B over ``(8, N)`` rows (the 7 rows plus each
    column's pass-A position as fp32): ``(34, N)`` votes + counts over
    candidates more than ``band`` pass-A positions from the query."""
    if not _build.on_card(packed):
        return spfh_band_b_plain(packed, r2, band, tile)
    out = _launch_band("spfh_band_b", packed, r2, band, tile, 8)
    spfh_band_b_tiles.launches += 1
    return out


def _launch(name, packed, pos_a, r2, tile, rows):
    # tile <= 1024 keeps a block's shared memory under the card's 227 KB:
    # stage 1 takes 102 bytes a column plus 2.4 KB a warp of 256 threads
    # (122 KB at 1024), stage 2 ~200 bytes a column (198 KB)
    n = _check(packed, rows, tile, pos_a)
    if packed.dtype != torch.float32:
        raise TypeError(f"expected float32 packed rows, got {packed.dtype}")
    packed = packed.contiguous()
    out = torch.empty((34, n), dtype=torch.float32, device=packed.device)
    args = [packed.data_ptr()]
    if pos_a is not None:
        args.append(pos_a.contiguous().data_ptr())
    with torch.cuda.device(packed.device):
        err = getattr(_build.lib(), "tc_" + name)(
            *args, out.data_ptr(), n, tile, _r2_f32(r2),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def spfh_a_tiles(packed, r2: float, tile: int = 256) -> torch.Tensor:
    """Stage-1 pass A: ``(34, N)`` raw SPFH votes + in-radius counts."""
    if not _build.on_card(packed):
        return spfh_a_plain(packed, r2, tile)
    out = _launch("spfh_a", packed, None, r2, tile, 7)
    spfh_a_tiles.launches += 1
    return out


def spfh_b_tiles(packed, pos_a, r2: float, tile: int = 256) -> torch.Tensor:
    """Stage-1 pass B: ``(34, N)`` B-exclusive votes + counts, B order."""
    if not _build.on_card(packed):
        return spfh_b_plain(packed, pos_a, r2, tile)
    out = _launch("spfh_b", packed, pos_a, r2, tile, 7)
    spfh_b_tiles.launches += 1
    return out


def fpfh_weight_a_tiles(packed, r2: float, tile: int = 256) -> torch.Tensor:
    """Stage-2 pass A: ``(34, N)`` weighted neighbour-SPFH sums + counts."""
    if not _build.on_card(packed):
        return fpfh_weight_a_plain(packed, r2, tile)
    out = _launch("fpfh_weight_a", packed, None, r2, tile, 37)
    fpfh_weight_a_tiles.launches += 1
    return out


def fpfh_weight_b_tiles(packed, pos_a, r2: float, tile: int = 256) -> torch.Tensor:
    """Stage-2 pass B: ``(34, N)`` B-exclusive sums + counts, B order."""
    if not _build.on_card(packed):
        return fpfh_weight_b_plain(packed, pos_a, r2, tile)
    out = _launch("fpfh_weight_b", packed, pos_a, r2, tile, 37)
    fpfh_weight_b_tiles.launches += 1
    return out


spfh_a_tiles.launches = 0
spfh_b_tiles.launches = 0
fpfh_weight_a_tiles.launches = 0
fpfh_weight_b_tiles.launches = 0
spfh_band_a_tiles.launches = 0
spfh_band_b_tiles.launches = 0
