"""Fused band-window SHOT/USC kernels: LRF moments and descriptor
histograms, each in two passes.

``shot_moments_a_tiles``, ``shot_moments_b_tiles``, ``shot_hist_a_tiles``
and ``shot_hist_b_tiles`` replace the Pallas kernels of the same names in
``threecrate_tpu/kernels/shot_pallas.py`` (bodies ``_moments_body`` and
``_hist_body``). On a CUDA tensor they launch the hand-written kernels of
``csrc/shot.cu``; on a CPU tensor they run the plain PyTorch versions
below, which compute the same function and are what the kernels are
checked against.

Inputs are Morton-sorted and padded to a multiple of ``tile``. The
candidates of sorted position p are the positions p−band … p+band inside
[0, N) (``band <= tile``: the Pallas tile only chose the window they were
drawn from, and its edge tiles are invalidated), selected when ``valid &
d² <= r2 & d² > 1e-18``; pass B further drops candidates whose pass-A
position (an fp32 row, exact below 2^24 rows) is within ``band`` of the
query's, so the two passes' sums add up to the union of both windows.

* moments: ``(4, N)`` rows [x, y, z, valid] (pass B: ``(5, N)``, + posA)
  → ``(14, N)`` [Σw, Σw·d (3), Σw·dᵢ·dⱼ (xx, yy, zz, xy, xz, yz), count,
  Σw·|d|²·d (3)] with w = max(R − |d|, 0). Or, placed: pass B writes
  each query's 14 sums and two zeros as row ``rows[p]`` of a query-major
  ``(n_rows, 16)`` buffer, and pass A adds row p of such a buffer
  (``plus``) to its own sums, so that ``_shot_fused`` merges the passes
  in pass-A order with no gather;
* histograms: ``(7, N)`` rows [x, y, z, valid, nx, ny, nz] (pass B:
  ``(8, N)``, + posA) and the query frames ``lrf (9, N)`` [x axis, y
  axis, z axis] → ``(dim + 1, N)``: 8 azimuth sectors (the reproduced
  ``_atan2_approx``) × 2 elevation halves × 2 radial shells × 11 soft
  cos(normal, z) bins (SHOT, dim 352), or × 8 radial shells (USC, dim
  128), then the count. Or, placed: each query's dim + 1 floats written
  to (or added to) row ``rows[p]`` of a query-major ``(n_rows, dim + 1)``
  buffer, so that ``_shot_fused`` sums both passes in input order with
  no gather.

``r2`` is rounded once to fp32; R = sqrt(r2) and, for USC, 1/sqrt(r2)
are rounded from it as the Pallas bodies get them (``jnp.sqrt`` and
``lax.rsqrt`` of the constant r2, which XLA folds to the correctly
rounded values). Every operation that decides a selection or a bin is
evaluated unfused and in the same order here and in the kernels, so the
count rows and the bin ids equal each other's: the USC rows bit for bit,
the SHOT soft votes and the moment sums up to summation order.

On the card all four are bound by the bytes they move, the histograms
by their output (353 floats per query and pass, read too where they add;
see the source note in ``csrc/shot.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .fpfh import _PI, _r2_f32, atan2_approx, band_candidates

SHOT_DIM = 352
USC_DIM = 128
N_COS = 11
N_MOMENTS = 14
MOMENT_ROW = 16           # floats of a placed moments row: 14 sums, 2 zeros
_AZ_SCALE = float(np.float32(8.0 / (2.0 * np.pi)))
_CHUNK_QUERIES = 8192     # queries per step of the plain versions


def _radius_f32(r2) -> float:
    """sqrt of the fp32 r2, correctly rounded to fp32."""
    return float(np.sqrt(np.float32(r2)))


def _inv_radius_f32(r2) -> float:
    """1/sqrt of the fp32 r2, correctly rounded to fp32."""
    return float(np.float32(np.float64(np.float32(r2)) ** -0.5))


def _dim(variant: str) -> int:
    if variant not in ("shot", "usc"):
        raise ValueError(f"variant must be 'shot' or 'usc', got {variant!r}")
    return SHOT_DIM if variant == "shot" else USC_DIM


def _check(packed, rows, band, tile, lrf=None):
    if packed.ndim != 2 or packed.shape[0] != rows:
        raise ValueError(f"expected ({rows}, N) packed rows, got {tuple(packed.shape)}")
    n = packed.shape[1]
    if tile <= 0 or n == 0 or n % tile:
        raise ValueError(f"tile must divide N={n} > 0, got {tile}")
    if not 0 <= band <= tile:
        raise ValueError(f"band must be in [0, tile={tile}], got {band}")
    if packed.dtype != torch.float32:
        raise TypeError(f"expected float32 packed rows, got {packed.dtype}")
    if lrf is not None:
        if lrf.shape != (9, n) or lrf.dtype != torch.float32:
            raise TypeError(f"lrf must be (9, {n}) float32, got {tuple(lrf.shape)} "
                            f"{lrf.dtype}")
        if lrf.device != packed.device:
            raise ValueError("all inputs must be on one device")
    return n


def _moments_plain(packed, r2, band, tile, excl, out=None, rows=None, plus=None):
    n = _check(packed, 5 if excl else 4, band, tile)
    _check_moment_placement(packed, n, out, rows, plus)
    radius = _radius_f32(r2)
    r2 = _r2_f32(r2)
    mom = torch.empty((N_MOMENTS, n), dtype=torch.float32, device=packed.device)
    for c0 in range(0, n, _CHUNK_QUERIES):
        c1 = min(c0 + _CHUNK_QUERIES, n)
        _, _, (dx, dy, dz), d2, sel = band_candidates(packed, c0, c1, band, r2, 1e-18,
                                                      4 if excl else None)
        sel_f = sel.to(torch.float32)
        w = torch.clamp_min(radius - torch.sqrt(torch.clamp_min(d2, 0.0)), 0.0) * sel_f
        wd2 = w * d2
        terms = (w, w * dx, w * dy, w * dz, w * dx * dx, w * dy * dy, w * dz * dz,
                 w * dx * dy, w * dx * dz, w * dy * dz, sel_f, wd2 * dx, wd2 * dy,
                 wd2 * dz)
        mom[:, c0:c1] = torch.stack([t.sum(-1) for t in terms])
    if plus is not None:
        mom += plus[:n, :N_MOMENTS].T
    if out is None:
        return mom
    at = rows.long()
    out[at, :N_MOMENTS] = mom.T
    out[at, N_MOMENTS:] = 0.0
    return out


def _check_out(packed, n, width, out, rows, accumulate=False):
    """Refuse a placement the kernels do not take: ``out`` an
    ``(n_rows, width)`` contiguous float32 tensor on the inputs' device,
    ``rows`` int32 of length N on that device with every row in
    [0, n_rows); ``rows`` and ``accumulate`` only with ``out``."""
    if out is None:
        if rows is not None or accumulate:
            raise ValueError("rows and accumulate need out")
        return
    if out.dtype != torch.float32:
        raise TypeError(f"out must be float32, got {out.dtype}")
    if out.ndim != 2 or out.shape[1] != width:
        raise ValueError(f"out must be (n_rows, {width}), got {tuple(out.shape)}")
    if out.device != packed.device:
        raise ValueError("out must be on the inputs' device")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if rows is None:
        if out.shape[0] < n:
            raise ValueError(f"out has {out.shape[0]} rows, fewer than N={n}")
        return
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if rows.shape != (n,):
        raise ValueError(f"rows must be ({n},), got {tuple(rows.shape)}")
    if rows.device != out.device:
        raise ValueError("rows must be on out's device")
    lo, hi = torch.stack(torch.aminmax(rows)).tolist()
    if lo < 0 or hi >= out.shape[0]:
        raise ValueError(f"rows must lie in [0, {out.shape[0]}), got [{lo}, {hi}]")


def _check_moment_placement(packed, n, out, rows, plus):
    """Refuse a moments placement the kernels do not take: pass B's
    ``out`` and ``rows`` together, as ``_check_out`` checks them at width
    ``MOMENT_ROW``; pass A's ``plus`` an ``(n_rows >= N, MOMENT_ROW)``
    contiguous float32 tensor on the inputs' device."""
    if (out is None) != (rows is None):
        raise ValueError("out and rows go together")
    _check_out(packed, n, MOMENT_ROW, out, rows)
    if plus is None:
        return
    if plus.dtype != torch.float32:
        raise TypeError(f"plus must be float32, got {plus.dtype}")
    if plus.ndim != 2 or plus.shape[1] != MOMENT_ROW or plus.shape[0] < n:
        raise ValueError(f"plus must be (n_rows >= {n}, {MOMENT_ROW}), got "
                         f"{tuple(plus.shape)}")
    if plus.device != packed.device:
        raise ValueError("plus must be on the inputs' device")
    if not plus.is_contiguous():
        raise ValueError("plus must be contiguous")


def candidate_votes(packed, lrf, r2, band, c0, c1, excl, variant):
    """The votes of queries c0 … c1−1 over their C = 2·band + 1 candidates
    (column p − band + k at k): ``(sel, lo_bin, v_lo, hi_bin, v_hi)``,
    each ``(Q, C)``. Each selected candidate votes ``v_lo`` to ``lo_bin``
    (the USC bin, or the lower SHOT cos bin: the whole vote at the top
    one) and ``v_hi`` to ``hi_bin`` (SHOT's upper cos bin; 0 at the top,
    and 0 to bin 0 for USC); an unselected one votes 0 to bin 0."""
    r2 = _r2_f32(r2)
    cand, _, (dx, dy, dz), d2, sel = band_candidates(packed, c0, c1, band, r2, 1e-18,
                                                     7 if excl else None)
    f = lrf[:, c0:c1, None]
    lx = dx * f[0] + dy * f[1] + dz * f[2]
    ly = dx * f[3] + dy * f[4] + dz * f[5]
    lz = dx * f[6] + dy * f[7] + dz * f[8]
    az_bin = ((atan2_approx(ly, lx) + _PI) * _AZ_SCALE).to(torch.int32).clamp(0, 7)
    el_bin = (lz >= 0).to(torch.int32)
    sel_f = sel.to(torch.float32)
    if variant == "usc":
        rad = ((torch.sqrt(torch.clamp_min(d2, 0.0)) * _inv_radius_f32(r2)) * 8.0).to(
            torch.int32).clamp(0, 7)
        jid = torch.where(sel, (az_bin * 2 + el_bin) * 8 + rad, 0).long()
        return sel, jid, sel_f, torch.zeros_like(jid), torch.zeros_like(sel_f)
    rad = (d2 >= 0.25 * r2).to(torch.int32)
    vol = (az_bin * 2 + el_bin) * 2 + rad
    cosn = cand[4] * f[6] + cand[5] * f[7] + cand[6] * f[8]
    pos = torch.clamp((cosn + 1.0) * (0.5 * N_COS) - 0.5, 0.0, float(N_COS - 1))
    lo = pos.to(torch.int32)
    frac = pos - lo.to(torch.float32)
    at_top = lo == N_COS - 1
    jid = torch.where(sel, vol * N_COS + lo, 0).long()
    return (sel, jid, torch.where(at_top, sel_f, sel_f * (1.0 - frac)),
            torch.where(at_top, jid, jid + 1), torch.where(at_top, 0.0, sel_f * frac))


def _hist_plain(packed, lrf, r2, band, tile, excl, variant, out=None, rows=None,
                accumulate=False):
    dim = _dim(variant)
    n = _check(packed, 8 if excl else 7, band, tile, lrf)
    _check_out(packed, n, dim + 1, out, rows, accumulate)
    dest = torch.empty((n, dim + 1), dtype=torch.float32,
                       device=packed.device) if out is None else out
    for c0 in range(0, n, _CHUNK_QUERIES):
        c1 = min(c0 + _CHUNK_QUERIES, n)
        sel, lo_bin, v_lo, hi_bin, v_hi = candidate_votes(packed, lrf, r2, band, c0, c1,
                                                          excl, variant)
        hist = torch.zeros((c1 - c0, dim + 1), dtype=torch.float32, device=packed.device)
        hist.scatter_add_(1, lo_bin, v_lo)
        if variant == "shot":
            hist.scatter_add_(1, hi_bin, v_hi)
        hist[:, dim] = sel.to(torch.float32).sum(-1)
        at = slice(c0, c1) if rows is None else rows[c0:c1].long()
        dest[at] = dest[at] + hist if accumulate else hist
    return dest.T if out is None else out


def shot_moments_a_plain(packed, r2: float, band: int, tile: int = 256, *,
                         plus=None) -> torch.Tensor:
    """Plain PyTorch moments pass A, chunked over queries; ``plus`` as
    ``shot_moments_a_tiles`` takes it."""
    return _moments_plain(packed, r2, band, tile, False, plus=plus)


def shot_moments_b_plain(packed, r2: float, band: int, tile: int = 256, *, out=None,
                         rows=None) -> torch.Tensor:
    """Plain PyTorch moments pass B, chunked over queries; ``out`` and
    ``rows`` as ``shot_moments_b_tiles`` takes them."""
    return _moments_plain(packed, r2, band, tile, True, out, rows)


def shot_hist_a_plain(packed, lrf, r2: float, band: int, tile: int = 256,
                      variant: str = "shot", *, out=None, rows=None,
                      accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch histogram pass A, chunked over queries; ``out``,
    ``rows`` and ``accumulate`` as ``shot_hist_a_tiles`` takes them."""
    return _hist_plain(packed, lrf, r2, band, tile, False, variant, out, rows, accumulate)


def shot_hist_b_plain(packed, lrf, r2: float, band: int, tile: int = 256,
                      variant: str = "shot", *, out=None, rows=None,
                      accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch histogram pass B, chunked over queries; ``out``,
    ``rows`` and ``accumulate`` as ``shot_hist_b_tiles`` takes them."""
    return _hist_plain(packed, lrf, r2, band, tile, True, variant, out, rows, accumulate)


def _launch_moments(name, packed, r2, band, tile, n_rows, out, rows, plus):
    n = _check(packed, n_rows, band, tile)
    _check_moment_placement(packed, n, out, rows, plus)
    packed = packed.contiguous()
    rows = None if rows is None else rows.contiguous()
    dest = torch.empty((N_MOMENTS, n), dtype=torch.float32,
                       device=packed.device) if out is None else out
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = ((ptr(plus), dest.data_ptr()) if name == "shot_moments_a"
            else (dest.data_ptr(), ptr(rows)))
    with torch.cuda.device(packed.device):
        err = getattr(_build.lib(), "tc_" + name)(
            packed.data_ptr(), *args, n, band, _r2_f32(r2), _radius_f32(r2),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return dest


def _launch_hist(name, packed, lrf, r2, band, tile, n_rows, variant, out, rows,
                 accumulate):
    dim = _dim(variant)
    n = _check(packed, n_rows, band, tile, lrf)
    _check_out(packed, n, dim + 1, out, rows, accumulate)
    packed, lrf = packed.contiguous(), lrf.contiguous()
    dest = torch.empty((n, dim + 1), dtype=torch.float32,
                       device=packed.device) if out is None else out
    rows = None if rows is None else rows.contiguous()
    with torch.cuda.device(packed.device):
        err = getattr(_build.lib(), "tc_" + name)(
            packed.data_ptr(), lrf.data_ptr(), dest.data_ptr(),
            None if rows is None else rows.data_ptr(), n, band, _r2_f32(r2),
            _inv_radius_f32(r2), int(variant == "usc"), int(accumulate),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return dest.T if out is None else out


def shot_moments_a_tiles(packed, r2: float, band: int, tile: int = 256, *,
                         plus=None) -> torch.Tensor:
    """Moments pass A over ±band sorted positions: ``(14, N)``. With
    ``plus`` (``(n_rows >= N, 16)`` float32, contiguous, as pass B places
    its rows): row p's first 14 floats are added to query p's sums (the
    fp32 sum a + b)."""
    if not _build.on_card(packed):
        return shot_moments_a_plain(packed, r2, band, tile, plus=plus)
    out = _launch_moments("shot_moments_a", packed, r2, band, tile, 4, None, None, plus)
    shot_moments_a_tiles.launches += 1
    return out


def shot_moments_b_tiles(packed, r2: float, band: int, tile: int = 256, *, out=None,
                         rows=None) -> torch.Tensor:
    """Moments pass B over ``(5, N)`` rows (+ the pass-A position as
    fp32): ``(14, N)`` over candidates more than ``band`` pass-A positions
    from the query. With ``out`` (``(n_rows, 16)`` float32, contiguous)
    and ``rows`` (int32, distinct rows): query p's 14 sums and two zeros
    are written to ``out[rows[p]]``, and ``out`` is returned."""
    if not _build.on_card(packed):
        return shot_moments_b_plain(packed, r2, band, tile, out=out, rows=rows)
    res = _launch_moments("shot_moments_b", packed, r2, band, tile, 5, out, rows, None)
    shot_moments_b_tiles.launches += 1
    return res


def shot_hist_a_tiles(packed, lrf, r2: float, band: int, tile: int = 256,
                      variant: str = "shot", *, out=None, rows=None,
                      accumulate: bool = False) -> torch.Tensor:
    """Histogram pass A over ±band sorted positions, dim 352
    (``variant="shot"``) or 128 (``"usc"``). Without ``out``: ``(dim + 1,
    N)`` (the transposed view of a query-major buffer). With ``out``
    (``(n_rows, dim + 1)`` float32, contiguous): query p's dim + 1 floats
    are written to ``out[rows[p]]`` (``rows`` int32, distinct rows,
    default p), or added to what that row holds with ``accumulate``, and
    ``out`` is returned."""
    if not _build.on_card(packed):
        return shot_hist_a_plain(packed, lrf, r2, band, tile, variant, out=out, rows=rows,
                                 accumulate=accumulate)
    res = _launch_hist("shot_hist_a", packed, lrf, r2, band, tile, 7, variant, out, rows,
                       accumulate)
    shot_hist_a_tiles.launches += 1
    return res


def shot_hist_b_tiles(packed, lrf, r2: float, band: int, tile: int = 256,
                      variant: str = "shot", *, out=None, rows=None,
                      accumulate: bool = False) -> torch.Tensor:
    """Histogram pass B over ``(8, N)`` rows (+ the pass-A position as
    fp32) with the frames in pass-B order, over candidates more than
    ``band`` pass-A positions from the query; output and placement as
    ``shot_hist_a_tiles``."""
    if not _build.on_card(packed):
        return shot_hist_b_plain(packed, lrf, r2, band, tile, variant, out=out, rows=rows,
                                 accumulate=accumulate)
    res = _launch_hist("shot_hist_b", packed, lrf, r2, band, tile, 8, variant, out, rows,
                       accumulate)
    shot_hist_b_tiles.launches += 1
    return res


shot_moments_a_tiles.launches = 0
shot_moments_b_tiles.launches = 0
shot_hist_a_tiles.launches = 0
shot_hist_b_tiles.launches = 0
