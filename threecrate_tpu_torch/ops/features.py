"""FPFH (33-d) and SHOT/USC (352-d / 128-d) descriptors, and descriptor
matching.

Counterpart of ``threecrate_tpu.ops.features``. FPFH takes two routes,
chosen as in the JAX package:

* above ``FUSED_FPFH_THRESHOLD`` points (or ``method="window"``), the
  fused window path ``_fpfh_fused``: the cloud is Morton-sorted twice
  and the FPFH kernels (``kernels.fpfh``) bin the Darboux pair features
  and weight the neighbours' SPFHs directly from each query's window
  candidates, with the two passes' sums added (a fixed radius makes the
  two-window union exact). ``band="auto"`` (the default) restricts the
  SPFH stage to ±band sorted positions when a ladder rung covers the
  measured in-radius count with a 2x margin;
* soft binning, other bin counts, or below the threshold, the staged
  path ``_fpfh``: a capped radius search (``ops.neighbors
  .radius_neighbors``, or ``radius_neighbors_window`` on the window
  path), the pair features with a true atan2, one-hot histograms (hard,
  or PCL-style soft binning) and the weighted neighbour sum, in blocks
  of 16,384 points.

``match_descriptors`` is the nearest neighbour in descriptor space, one
matmul for small problems and the tiled ``knn`` above 2^26 pairs.

SHOT and USC also take two routes. Above ``FUSED_SHOT_THRESHOLD``
points (or ``method="window"``; SHOT also needs 11 cos bins) the fused
band path ``_shot_fused``: two Morton sorts, the moment kernels, a
batched 3x3 eigensolve for the local reference frames (LRFs), then the
histogram kernels (``kernels.shot``), all over ±band sorted positions
per pass. Otherwise the staged path ``_shot``: a capped radius search
(exact, or the window search), each query's LRF from its gathered
neighbours and the histogram with a true atan2, in blocks of 16,384
points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from ..kernels.shot import SHOT_DIM, USC_DIM
from ..utils import padding
from . import linalg, morton, neighbors
from .linalg import fp32_matmul
from .normals import NormalEstimationConfig, estimate_normals_detailed

FPFH_DIM = 33
N_BINS_FPFH = 11
FUSED_FPFH_THRESHOLD = 262144   # capacity above which "auto" takes the fused path


@dataclasses.dataclass(frozen=True)
class FpfhConfig:
    """The JAX package's config, field for field: ``method`` is "auto"
    (fused window path above ``FUSED_FPFH_THRESHOLD`` points, else
    exact), "exact" or "window"; ``soft_binning`` takes the staged path;
    ``band`` ("auto", None or a rung) restricts the fused SPFH stage to
    ±band sorted positions, None being the exact full window."""

    radius: float = 0.25
    max_neighbors: int = 64
    n_bins: int = 11
    method: str = "auto"
    soft_binning: bool = False
    band: Optional[object] = "auto"


class FpfhResult(NamedTuple):
    descriptors: torch.Tensor  # (N, 33)
    valid: torch.Tensor        # (N,)


def pair_features(p1, n1, p2, n2):
    """Darboux-frame angles for point pairs, with PCL's swap that anchors
    the frame at the point whose normal is better aligned with the
    connecting line. Returns (f1=θ∈[-π,π], f2=cos φ, f3=cos α, f4=distance)."""
    d = p2 - p1
    f4 = torch.linalg.vector_norm(d, dim=-1)
    dn = d / torch.clamp_min(f4, 1e-12)[..., None]
    a1 = (n1 * dn).sum(-1)
    a2 = (n2 * dn).sum(-1)
    swap = (a1.abs() < a2.abs())[..., None]
    ns = torch.where(swap, n2, n1)
    nt = torch.where(swap, n1, n2)
    dn = torch.where(swap, -dn, dn)
    f3 = (ns * dn).sum(-1)
    v = torch.linalg.cross(dn, ns)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)
    w = torch.linalg.cross(ns, v)
    f2 = (v * nt).sum(-1)
    f1 = torch.atan2((w * nt).sum(-1), (ns * nt).sum(-1))
    return f1, f2, f3, f4


def _hist(values, lo, hi, n_bins, weights, soft=False):
    """(..., K) values → (..., n_bins) weighted histogram; ``soft=True``
    splits each vote linearly between the two adjacent bins."""
    t = (values - lo) / (hi - lo)
    out = torch.zeros(values.shape[:-1] + (n_bins,), dtype=torch.float32,
                      device=values.device)
    if not soft:
        idx = (t * n_bins).to(torch.int32).clamp(0, n_bins - 1).long()
        return out.scatter_add_(-1, idx, weights)
    pos = torch.clamp(t * n_bins - 0.5, 0.0, float(n_bins - 1))
    lo_i = pos.to(torch.int32)
    hi_i = torch.clamp_max(lo_i + 1, n_bins - 1)
    frac = pos - lo_i
    out.scatter_add_(-1, lo_i.long(), weights * (1 - frac))
    return out.scatter_add_(-1, hi_i.long(), weights * frac)


def _renormalise(fpfh):
    """Each 11-bin sub-histogram scaled to sum to 100 (PCL convention)."""
    blocks = fpfh.reshape(fpfh.shape[0], 3, -1)
    s = torch.clamp_min(blocks.sum(2, keepdim=True), 1e-12)
    return (blocks / s * 100.0).reshape(fpfh.shape)


def fused_stage1_inputs(points, mask, normals_arr, tile=256):
    """Pass-A and pass-B packed stage-1 rows of the fused path.

    Returns ``(packed_a (7, N), packed_b (7, N), row_a, perm_a)``: the
    cloud padded to a multiple of ``tile``, Morton-sorted (pass A) with
    rows [x, y, z, valid, nx, ny, nz], the same rows in pass-B order,
    the pass-A row of each pass-B row and the input row of each pass-A
    row.
    """
    n = points.shape[0]
    n_pad = padding.round_up(n, tile)
    pts = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:n] = points
    nrm = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    nrm[:n] = normals_arr
    mask_p = torch.zeros(n_pad, dtype=torch.bool, device=points.device)
    mask_p[:n] = mask
    perm_a = neighbors._sort_perm(morton.morton_keys(pts, mask_p, pass_index=0))
    pts_a = pts[perm_a]
    am = mask_p[perm_a]
    packed_a = torch.cat([pts_a.T, am.to(torch.float32)[None],
                          nrm[perm_a].T]).contiguous()
    row_a = neighbors._sort_perm(morton.morton_keys(pts_a, am, pass_index=1))
    return packed_a, packed_a[:, row_a].contiguous(), row_a, perm_a


def _fpfh_fused(points, mask, normals_arr, radius: float, tile=256, band=None):
    """Fused window FPFH in input order: ``(descriptors (N, 33), valid
    (N,))``. Stage 1 takes every in-radius window candidate
    (``band=None``) or only those within ±band sorted positions of each
    pass; stage 2 always weights over the full window."""
    from ..kernels.fpfh import (fpfh_weight_a_tiles, fpfh_weight_b_tiles,
                                spfh_a_tiles, spfh_b_tiles, spfh_band_a_tiles,
                                spfh_band_b_tiles)

    n = points.shape[0]
    r2 = float(radius) * float(radius)
    packed_a, packed_b, row_a, perm_a = fused_stage1_inputs(
        points, mask, normals_arr, tile)
    pos_a = row_a.to(torch.int32)[None].contiguous()
    if band is None:
        spfh_a = spfh_a_tiles(packed_a, r2, tile)               # (34, N) A-order
        spfh_b = spfh_b_tiles(packed_b, pos_a, r2, tile)        # (34, N) B-order
    else:
        spfh_a = spfh_band_a_tiles(packed_a, r2, int(band), tile)
        # the pass-A position rides as an fp32 row (exact below 2^24 rows)
        packed_b8 = torch.cat([packed_b, row_a.to(torch.float32)[None]]).contiguous()
        spfh_b = spfh_band_b_tiles(packed_b8, r2, int(band), tile)

    inv_b = neighbors._inverse(row_a)
    spfh_raw = spfh_a.T + spfh_b.T[inv_b]                       # (N, 34) A-order
    cnt = spfh_raw[:, 33]
    spfh = spfh_raw[:, :33] / torch.clamp_min(cnt, 1.0)[:, None]

    # stage 2: FPFH(p) = SPFH(p) + (1/k)·Σ (1/d)·SPFH(q)
    w_a = fpfh_weight_a_tiles(torch.cat([packed_a[0:4], spfh.T]).contiguous(),
                              r2, tile)
    w_b = fpfh_weight_b_tiles(torch.cat([packed_b[0:4], spfh[row_a].T]).contiguous(),
                              pos_a, r2, tile)
    w_raw = w_a.T + w_b.T[inv_b]                                # (N, 34)
    k_eff = torch.clamp_min(w_raw[:, 33], 1.0)
    fpfh = spfh + w_raw[:, :33] / k_eff[:, None]

    valid_s = (packed_a[3] > 0.5) & (cnt >= 3)
    desc_s = torch.where(valid_s[:, None], _renormalise(fpfh), 0.0)
    inv_a = neighbors._inverse(perm_a)
    return desc_s[inv_a][:n], valid_s[inv_a][:n] & mask


def _fpfh(points, mask, normals_arr, radius, max_neighbors: int, n_bins: int,
          window=False, soft=False, block=16384):
    """Staged FPFH over a capped radius search, ``block`` rows at a time:
    ``(descriptors (N, 3·n_bins), valid (N,))``."""
    if window:
        res = neighbors.radius_neighbors_window(points, mask, radius, max_neighbors,
                                                exclude_self=True)
    else:
        res = neighbors.radius_neighbors(points, mask, points, mask, radius,
                                         max_neighbors, exclude_self=True)
    idx, ok, dist = res.indices, res.mask, res.distances
    n = points.shape[0]
    spfh = torch.empty((n, 3 * n_bins), dtype=torch.float32, device=points.device)
    for b0 in range(0, n, block):
        sl = slice(b0, b0 + block)
        f1, f2, f3, _ = pair_features(points[sl, None, :], normals_arr[sl, None, :],
                                      points[idx[sl]], normals_arr[idx[sl]])
        w = ok[sl].to(torch.float32)
        h = torch.cat([_hist(f1, -math.pi, math.pi, n_bins, w, soft),
                       _hist(f2, -1.0, 1.0, n_bins, w, soft),
                       _hist(f3, -1.0, 1.0, n_bins, w, soft)], -1)
        spfh[sl] = h / torch.clamp_min(w.sum(1, keepdim=True), 1.0)

    fpfh = torch.empty_like(spfh)
    for b0 in range(0, n, block):
        sl = slice(b0, b0 + block)
        inv_d = torch.where(ok[sl] & (dist[sl] > 1e-12), 1.0 / dist[sl], 0.0)
        k_eff = torch.clamp_min(ok[sl].sum(1, keepdim=True), 1)
        fpfh[sl] = spfh[sl] + torch.einsum("nk,nkd->nd", inv_d, spfh[idx[sl]]) / k_eff

    desc = _renormalise(fpfh)
    valid = mask & (ok.sum(1) >= 3)
    return torch.where(valid[:, None], desc, 0.0), valid


# Band rungs for FpfhConfig(band="auto"): the candidate capacity of rung
# b is ~2·(2·b+1) over the two-pass union; a rung qualifies when it
# covers the measured mean in-radius neighbour count with a 2x margin.
_FPFH_BAND_LADDER = (16, 32, 48, 64)


def expected_in_radius_count(points, mask, radius: float, n_query: int = 1024,
                             n_ref: int = 16384) -> float:
    """Estimate of the mean in-radius neighbour count: a deterministic
    strided subsample of up to ``n_query`` queries against up to
    ``n_ref`` reference points, counts rescaled by the subsampling
    ratio, minus self. The JAX package computes it in NumPy on the host;
    here it runs on the points' device with the same subsample and the
    same fp32 arithmetic ((dx² + dy²) + dz² against fp32 r²), so the
    count is the same, and only the total comes back."""
    pts = points.to(torch.float32)[mask]
    n = pts.shape[0]
    if n < 16:
        return 0.0
    q = pts[::max(1, n // n_query)][:n_query]
    ref = pts[::max(1, n // n_ref)][:n_ref]
    scale = n / ref.shape[0]
    r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32,
                      device=pts.device)
    total = torch.zeros((), dtype=torch.int64, device=pts.device)
    for s in range(0, q.shape[0], 128):
        d = q[s:s + 128, None, :] - ref[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        total += (d2 <= r2).sum()
    return max(float(total.item()) / q.shape[0] * scale - 1.0, 0.0)


def _resolve_fpfh_band(band, points, mask, radius: float):
    """Resolve FpfhConfig.band="auto" to a ladder rung or None."""
    if band != "auto":
        return band
    est = expected_in_radius_count(points, mask, radius)
    for b in _FPFH_BAND_LADDER:
        if 2 * (2 * b + 1) >= 2.0 * est:
            return b
    return None


def extract_fpfh_features_with_normals(cloud: PointCloud,
                                       config: FpfhConfig = FpfhConfig()
                                       ) -> FpfhResult:
    """FPFH over a cloud that already carries normals."""
    if cloud.normals is None:
        raise InvalidDataError("FPFH requires normals on the cloud")
    window = (config.method == "window"
              or (config.method == "auto" and cloud.capacity > FUSED_FPFH_THRESHOLD))
    if window and config.n_bins == N_BINS_FPFH and not config.soft_binning:
        band = _resolve_fpfh_band(config.band, cloud.points, cloud.mask,
                                  float(config.radius))
        desc, valid = _fpfh_fused(cloud.points, cloud.mask, cloud.normals,
                                  float(config.radius), band=band)
    else:
        desc, valid = _fpfh(cloud.points, cloud.mask, cloud.normals,
                            config.radius, config.max_neighbors, config.n_bins,
                            window, config.soft_binning)
    return FpfhResult(desc, valid)


def extract_fpfh_features(cloud: PointCloud, config: FpfhConfig = FpfhConfig(),
                          k_normals: int = 10) -> FpfhResult:
    """Normals + FPFH convenience entry."""
    if cloud.normals is None:
        nres = estimate_normals_detailed(
            cloud, NormalEstimationConfig(k_neighbors=k_normals))
        cloud = cloud.with_normals(nres.normals)
    return extract_fpfh_features_with_normals(cloud, config)


# ---------------------------------------------------------------------------
# SHOT / USC
# ---------------------------------------------------------------------------

FUSED_SHOT_THRESHOLD = 262144   # capacity above which "auto" takes the fused path
SHOT_BLOCK = 16384              # rows per step of the staged path
LRF_TIE_TAU = 0.25   # |mean projection| (normalised by wsum·R) below which a
# sign vote counts as ambiguous and falls back to its tie-break; the JAX
# package measured this threshold on its two-sampling repeatability fixture


@dataclasses.dataclass(frozen=True)
class ShotConfig:
    """The JAX package's config, field for field: ``method`` as in
    ``FpfhConfig``; ``band`` is the fused path's candidate half-width in
    sorted positions per Morton pass (the union of two ±band windows caps
    the neighbourhood)."""

    radius: float = 0.25
    max_neighbors: int = 128
    n_cos_bins: int = 11
    method: str = "auto"
    band: int = 32


class ShotResult(NamedTuple):
    descriptors: torch.Tensor  # (N, 352) SHOT or (N, 128) USC, unit L2 norm
    valid: torch.Tensor        # (N,)


def _lrf_signs(sd, td, wsum, radius, z, x, nq):
    """Sign disambiguation of the LRF axes. Primary vote: the
    (R−d)-weighted displacement sum ``sd`` projected on each axis.
    Ambiguous votes (|vote| / (wsum·R) <= LRF_TIE_TAU) fall back to z
    aligned with the query normal ``nq`` (or, without normals, the
    far-amplified vote ``td`` = Σw·d·|d|²) and x to ``td``."""
    zs = (sd * z).sum(1)
    xs = (sd * x).sum(1)
    r1 = np.float32(radius)
    scale1 = torch.clamp_min(wsum * float(r1), 1e-30)
    # R³ as the JAX package rounds it: two fp32 products
    scale3 = torch.clamp_min(wsum * float(r1 * r1 * r1), 1e-30)
    z_tie = (td * z).sum(1) / scale3 if nq is None else (nq * z).sum(1)
    z_vote = torch.where((zs / scale1).abs() > LRF_TIE_TAU, zs, z_tie)
    x_tie = (td * x).sum(1) / scale3
    x_vote = torch.where((xs / scale1).abs() > LRF_TIE_TAU, xs, x_tie)
    z = torch.where((z_vote < 0)[:, None], -z, z)
    x = torch.where((x_vote < 0)[:, None], -x, x)
    return z, x


def _orthonormal_frame(z, x):
    """x re-orthogonalised against z and normalised; y = z × x."""
    x = x - (x * z).sum(-1, keepdim=True) * z
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
    return x, torch.linalg.cross(z, x), z


def _shot_lrf(nbr, nbr_ok, nbr_dist, radius, own, own_normals=None):
    """Sign-disambiguated local reference frame ``(x, y, z)`` of each
    query from its gathered neighbours ``nbr (N, k, 3)``: eigenvectors of
    the (R − d)-weighted covariance (z the smallest, x the largest), signs
    from ``_lrf_signs``."""
    w = torch.where(nbr_ok, torch.clamp_min(radius - nbr_dist, 0.0), 0.0)
    _, cov = linalg.weighted_covariance(nbr, w)
    _, vecs = linalg.eigh3x3(cov)
    d = nbr - own[:, None, :]
    sd = (w[..., None] * d).sum(1)
    td = ((w * (d * d).sum(-1))[..., None] * d).sum(1)
    wsum = torch.clamp_min(w.sum(1), 1e-12)
    z, x = _lrf_signs(sd, td, wsum, radius, vecs[..., :, 0], vecs[..., :, 2],
                      own_normals)
    return _orthonormal_frame(z, x)


def lrf_from_moments(m, radius: float, nq=None):
    """Query frames ``(N, 9)`` [x, y, z] from the merged moment rows ``m
    (N, 14)`` of the two passes: the (R−d)-weighted covariance, its batched
    eigensolve, the signs from ``_lrf_signs`` (z tie-break on the normals
    ``nq``, or on the far-amplified vote when None)."""
    wsum = torch.clamp_min(m[:, 0], 1e-12)
    mu = m[:, 1:4] / wsum[:, None]
    cc = m[:, 4:10] / wsum[:, None]
    cxx = cc[:, 0] - mu[:, 0] * mu[:, 0]
    cyy = cc[:, 1] - mu[:, 1] * mu[:, 1]
    czz = cc[:, 2] - mu[:, 2] * mu[:, 2]
    cxy = cc[:, 3] - mu[:, 0] * mu[:, 1]
    cxz = cc[:, 4] - mu[:, 0] * mu[:, 2]
    cyz = cc[:, 5] - mu[:, 1] * mu[:, 2]
    cov = torch.stack([torch.stack([cxx, cxy, cxz], -1),
                       torch.stack([cxy, cyy, cyz], -1),
                       torch.stack([cxz, cyz, czz], -1)], -2)
    _, vecs = linalg.eigh3x3(cov)
    z, x = _lrf_signs(m[:, 1:4], m[:, 11:14], wsum, float(np.float32(radius)),
                      vecs[..., :, 0], vecs[..., :, 2], nq)
    return torch.cat(_orthonormal_frame(z, x), 1)


def _shot_fused(points, mask, normals_arr, radius: float, variant: str = "shot",
                band: int = 32, tile: int = 256):
    """Fused band-window SHOT/USC in input order: ``(descriptors (N, dim),
    valid (N,))``. Two moment passes give each query's (R−d)-weighted
    covariance and sign votes, the LRF is solved batched, and two
    histogram passes bin the in-LRF displacements straight from the
    Morton-band candidates; a fixed radius makes the two windows' sums add
    up to their union, which the kernels form without a gather: pass B of
    the moments writes each query's row at its pass-A position and pass A
    adds it; pass B of the histograms writes each query's row at its input
    row and pass A adds to it."""
    from ..kernels.shot import (MOMENT_ROW, shot_hist_a_tiles, shot_hist_b_tiles,
                                shot_moments_a_tiles, shot_moments_b_tiles)

    n = points.shape[0]
    r2 = float(radius) * float(radius)
    packed_a, packed_b, row_a, perm_a = fused_stage1_inputs(points, mask, normals_arr,
                                                            tile)
    # the pass-A position rides as an fp32 row (exact below 2^24 rows)
    pos_a = row_a.to(torch.float32)[None]
    mom_b = torch.empty((packed_a.shape[1], MOMENT_ROW), dtype=torch.float32,
                        device=points.device)
    shot_moments_b_tiles(torch.cat([packed_b[0:4], pos_a]).contiguous(), r2, band, tile,
                         out=mom_b, rows=row_a.to(torch.int32))
    mom = shot_moments_a_tiles(packed_a[0:4].contiguous(), r2, band, tile, plus=mom_b)
    # USC carries zero normals: its z tie-break is the far-amplified vote
    lrf = lrf_from_moments(mom.T, radius, packed_a[4:7].T if variant == "shot" else None)
    del mom, mom_b

    # query-major rows in input order: pass B writes each position's row at
    # its input row, pass A adds to it (the fp32 sum h_b + h_a)
    dim = SHOT_DIM if variant == "shot" else USC_DIM
    rows_a = perm_a.to(torch.int32)
    h = torch.empty((packed_a.shape[1], dim + 1), dtype=torch.float32, device=points.device)
    shot_hist_b_tiles(torch.cat([packed_b, pos_a]).contiguous(), lrf[row_a].T.contiguous(),
                      r2, band, tile, variant, out=h, rows=rows_a[row_a])
    shot_hist_a_tiles(packed_a, lrf.T.contiguous(), r2, band, tile, variant, out=h,
                      rows=rows_a, accumulate=True)
    h = h[:n]
    valid = mask & (h[:, dim] >= 5)
    norm = torch.clamp_min(torch.linalg.vector_norm(h[:, :dim], dim=1, keepdim=True), 1e-12)
    # one pass: unit rows where valid, zeros (finite / inf) elsewhere
    return h[:, :dim] / torch.where(valid[:, None], norm, torch.inf), valid


def _shot_descriptor_block(nbr, nbr_nrm, ok, dist, own, own_nrm, radius,
                           n_cos_bins: int, variant: str):
    """SHOT/USC descriptors of one row block from gathered neighbourhoods
    (``(B, k, ...)``): the LRF, then the soft-binned 32·n_cos_bins-d SHOT
    (or 128-d USC) histogram with a true atan2, unit L2 norm."""
    x, y, z = _shot_lrf(nbr, ok, dist, radius, own,
                        own_nrm if variant == "shot" else None)
    d = nbr - own[:, None, :]
    lx = (d * x[:, None, :]).sum(-1)
    ly = (d * y[:, None, :]).sum(-1)
    lz = (d * z[:, None, :]).sum(-1)
    r = torch.sqrt(lx * lx + ly * ly + lz * lz)
    az = torch.atan2(ly, lx)
    el = lz / torch.clamp_min(r, 1e-12)
    az_bin = ((az + math.pi) / (2 * math.pi) * 8).to(torch.int32).clamp(0, 7)
    el_bin = (el >= 0).to(torch.int32)
    w = ok.to(torch.float32) * (r > 1e-9)
    if variant == "shot":
        rad_bin = (r >= 0.5 * radius).to(torch.int32)
        vol = (az_bin * 2 + el_bin) * 2 + rad_bin
        cosn = (nbr_nrm * z[:, None, :]).sum(-1)
        pos = torch.clamp((cosn + 1.0) / 2.0 * n_cos_bins - 0.5, 0.0, n_cos_bins - 1.0)
        lo = torch.floor(pos).to(torch.int32)
        hi = torch.clamp_max(lo + 1, n_cos_bins - 1)
        frac = pos - lo
        desc = torch.zeros((nbr.shape[0], 32 * n_cos_bins), dtype=torch.float32,
                           device=nbr.device)
        desc.scatter_add_(1, (vol * n_cos_bins + lo).long(), w * (1 - frac))
        desc.scatter_add_(1, (vol * n_cos_bins + hi).long(), w * frac)
    else:
        rad_bin = (r / radius * 8).to(torch.int32).clamp(0, 7)
        flat = (az_bin * 2 + el_bin) * 8 + rad_bin
        desc = torch.zeros((nbr.shape[0], USC_DIM), dtype=torch.float32,
                           device=nbr.device).scatter_add_(1, flat.long(), w)
    return desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=1, keepdim=True),
                                  1e-12)


def _shot(points, mask, normals_arr, radius, max_neighbors: int, n_cos_bins: int,
          variant: str, window=False):
    """Staged SHOT/USC over a capped radius search (self excluded),
    ``SHOT_BLOCK`` rows at a time: ``(descriptors (N, dim), valid (N,))``."""
    radius = float(np.float32(radius))
    if window:
        res = neighbors.radius_neighbors_window(points, mask, radius, max_neighbors,
                                                exclude_self=True)
    else:
        res = neighbors.radius_neighbors(points, mask, points, mask, radius,
                                         max_neighbors, exclude_self=True)
    idx, ok, dist = res.indices, res.mask, res.distances
    n = points.shape[0]
    dim = 32 * n_cos_bins if variant == "shot" else USC_DIM
    desc = torch.empty((n, dim), dtype=torch.float32, device=points.device)
    for b0 in range(0, n, SHOT_BLOCK):
        sl = slice(b0, b0 + SHOT_BLOCK)
        desc[sl] = _shot_descriptor_block(points[idx[sl]], normals_arr[idx[sl]], ok[sl],
                                          dist[sl], points[sl], normals_arr[sl], radius,
                                          n_cos_bins, variant)
    valid = mask & (ok.sum(1) >= 5)
    return torch.where(valid[:, None], desc, 0.0), valid


def _use_fused_shot(config: ShotConfig, cloud: PointCloud) -> bool:
    return (config.method == "window"
            or (config.method == "auto" and cloud.capacity > FUSED_SHOT_THRESHOLD))


def extract_shot_features(cloud: PointCloud, config: ShotConfig = ShotConfig(),
                          k_normals: int = 10) -> ShotResult:
    """SHOT descriptors (352-d at 11 cos bins), estimating normals with
    ``k_normals`` neighbours when the cloud has none. The fused band path
    above ``FUSED_SHOT_THRESHOLD`` points (or ``method="window"``) at 11
    cos bins, else the staged path."""
    if cloud.normals is None:
        nres = estimate_normals_detailed(
            cloud, NormalEstimationConfig(k_neighbors=k_normals))
        cloud = cloud.with_normals(nres.normals)
    window = _use_fused_shot(config, cloud)
    if window and config.n_cos_bins == 11:
        desc, valid = _shot_fused(cloud.points, cloud.mask, cloud.normals,
                                  float(config.radius), "shot", band=config.band)
    else:
        desc, valid = _shot(cloud.points, cloud.mask, cloud.normals, config.radius,
                            config.max_neighbors, config.n_cos_bins, "shot", window)
    return ShotResult(desc, valid)


def extract_usc_features(cloud: PointCloud, config: ShotConfig = ShotConfig()
                         ) -> ShotResult:
    """USC descriptors: the 128-d spatial density histogram in the LRF
    (8 azimuth × 2 elevation × 8 radial bins); no normals needed."""
    zeros = torch.zeros_like(cloud.points)
    window = _use_fused_shot(config, cloud)
    if window:
        desc, valid = _shot_fused(cloud.points, cloud.mask, zeros,
                                  float(config.radius), "usc", band=config.band)
    else:
        desc, valid = _shot(cloud.points, cloud.mask, zeros, config.radius,
                            config.max_neighbors, config.n_cos_bins, "usc", window)
    return ShotResult(desc, valid)


def match_descriptors(desc_a, valid_a, desc_b, valid_b, mutual: bool = False):
    """Nearest neighbour of each ``desc_a`` row among the valid
    ``desc_b`` rows: ``(index into b (N,), distance, valid)``.
    ``mutual=True`` keeps only cross-checked pairs. Up to 2^26 pair
    products it is one fp32 matmul; above, the tiled ``neighbors.knn``,
    which never forms a distance matrix wider than its ``db_tile``."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    rows_a = torch.arange(na, device=desc_a.device)
    if na * nb > 2 ** 26:
        res = neighbors.knn(desc_b, valid_b, desc_a, valid_a, 1)
        j = res.indices[:, 0]
        dist = res.distances[:, 0]
        ok = valid_a & res.mask[:, 0] & torch.isfinite(dist)
        if mutual:
            back = neighbors.knn(desc_a, valid_a, desc_b, valid_b, 1)
            ok = ok & (back.indices[:, 0][j] == rows_a)
        return j, torch.where(ok, dist, torch.inf), ok
    an = (desc_a * desc_a).sum(1)
    bn = (desc_b * desc_b).sum(1)
    d2 = an[:, None] + bn[None, :] - 2.0 * fp32_matmul(desc_a, desc_b.T)
    d2 = torch.where(valid_b[None, :], d2, torch.inf)
    j = torch.argmin(d2, dim=1)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, j[:, None])[:, 0], 0.0))
    ok = valid_a & torch.isfinite(dist)
    if mutual:
        back = torch.argmin(torch.where(valid_a[:, None], d2, torch.inf), dim=0)
        ok = ok & (back[j] == rows_a)
    return j, torch.where(ok, dist, torch.inf), ok
