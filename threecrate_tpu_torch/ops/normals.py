"""Normal estimation by local PCA.

Counterpart of ``threecrate_tpu.ops.normals``, every method ported:

* ``exact``: blockwise brute-force kNN (``ops.neighbors.knn``), a
  covariance from explicit component sums, the closed-form smallest
  eigenvector; the ``auto`` choice below ``AUTO_WINDOW_THRESHOLD``.
* the two-window UNION (``auto`` at and above the threshold): the cloud
  is Morton-sorted twice; the union kernels (``kernels.knn``) emit per
  point query-centred central sums over a pass-A window and the
  pass-B candidates outside it, which add; the 3x3 eigensolve runs on
  the merged sums.
* ``window``: the two-pass window kNN (``knn_window_tiles``) left in
  pass-A order, then the same PCA as ``exact``.
* ``window_fast`` with ``window_merge="tighter"`` (or one pass): the
  fused window-normals kernel (``window_normals_tiles``, band 16) per
  Morton pass, each point keeping the pass with the tighter
  neighbourhood; with ``window_merge="union"`` and 2+ passes, the union.

Orientation flips each normal toward a viewpoint (default: the bounding
box centre raised by the z extent).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.point_cloud import PointCloud
from ..utils import padding
from . import linalg, morton, neighbors


@dataclasses.dataclass(frozen=True)
class NormalEstimationConfig:
    """The JAX package's config, field for field: ``method`` is "auto"
    (union above ``AUTO_WINDOW_THRESHOLD`` points, else exact), "exact",
    "window" or "window_fast"; ``window_passes`` and ``window_merge``
    configure "window_fast"."""

    k_neighbors: int = 10
    radius: Optional[float] = None
    consistent_orientation: bool = True
    viewpoint: Optional[Tuple[float, float, float]] = None
    method: str = "auto"
    window_passes: int = 2
    window_merge: str = "tighter"


AUTO_WINDOW_THRESHOLD = 65536


class NormalResult(NamedTuple):
    normals: torch.Tensor     # (N, 3) unit normals (0 where invalid)
    curvature: torch.Tensor   # (N,) surface variation λ0/(λ0+λ1+λ2)
    valid: torch.Tensor       # (N,) bool: enough neighbors for a plane fit


def _pass_a(points, mask, tile):
    """The cloud padded to a multiple of ``tile`` and Morton-sorted (pass
    A): ``(sorted rows (N_pad, 3), sorted validity (float), perm_a)``
    with perm_a the original row of each sorted row."""
    n = points.shape[0]
    n_pad = padding.round_up(n, tile)
    pts = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:n] = points
    mask_p = torch.zeros(n_pad, dtype=torch.bool, device=points.device)
    mask_p[:n] = mask
    perm_a = neighbors._sort_perm(morton.morton_keys(pts, mask_p, pass_index=0))
    return pts[perm_a], mask_p[perm_a].to(torch.float32), perm_a


def _to_input_order(perm_a, normal_s, curv_s, valid_s, mask):
    """Per-point results in pass-A order → input order, zero where
    invalid."""
    n = mask.shape[0]
    normal = torch.empty_like(normal_s)
    curv = torch.empty_like(curv_s)
    valid = torch.empty_like(valid_s)
    normal[perm_a] = torch.where(valid_s[:, None], normal_s, 0.0)
    curv[perm_a] = torch.where(valid_s, curv_s, 0.0)
    valid[perm_a] = valid_s
    return normal[:n], curv[:n], valid[:n] & mask


def _union_window_sums(points, mask, k, tile=256, band=16):
    """The two-window union up to the merged central sums.

    Returns ``(s, pts_a_rows, am, perm_a)`` in pass-A sorted order over
    the padded capacity: s (N, 10) = [count, Σ(c−q) (3), Σ(c−q)(c−q)ᵀ
    (6)], the sorted coordinates, the sorted validity (float) and the
    original row of each sorted row.
    """
    from ..kernels.knn import window_union_a_tiles, window_union_b_tiles

    pts_a_rows, am, perm_a = _pass_a(points, mask, tile)
    out_a = window_union_a_tiles(pts_a_rows.T.contiguous(), am[None, :], k,
                                 tile, band)                  # (11, N) A-order

    row_a = neighbors._sort_perm(morton.morton_keys(pts_a_rows, am > 0.5, pass_index=1))
    out_b = window_union_b_tiles(
        pts_a_rows[row_a].T.contiguous(), am[row_a][None, :],
        row_a.to(torch.int32)[None, :], out_a[10][row_a][None, :], k, tile,
        band)                                                 # (11, N) B-order

    # realign pass-B output to A-order, then blend: B already chose
    # between its own sums (use_b) and the B-exclusive part of the union
    sb = torch.empty_like(out_b.T)
    sb[row_a] = out_b.T
    use_b = sb[:, 10:11] > 0.5
    s = sb[:, 0:10] + torch.where(use_b, 0.0, out_a[0:10].T)
    return s, pts_a_rows, am, perm_a


def _cov_from_sums(s):
    """(N, 3, 3) covariance + count from the 10 central sums."""
    cnt = s[:, 0]
    inv_n = 1.0 / torch.clamp_min(cnt, 1e-12)
    e1 = s[:, 1:4] * inv_n[:, None]
    cxx = s[:, 4] * inv_n - e1[:, 0] * e1[:, 0]
    cyy = s[:, 5] * inv_n - e1[:, 1] * e1[:, 1]
    czz = s[:, 6] * inv_n - e1[:, 2] * e1[:, 2]
    cxy = s[:, 7] * inv_n - e1[:, 0] * e1[:, 1]
    cxz = s[:, 8] * inv_n - e1[:, 0] * e1[:, 2]
    cyz = s[:, 9] * inv_n - e1[:, 1] * e1[:, 2]
    cov = torch.stack([
        torch.stack([cxx, cxy, cxz], -1),
        torch.stack([cxy, cyy, cyz], -1),
        torch.stack([cxz, cyz, czz], -1)], -2)
    return cov, cnt


def _normal_and_curvature(cov):
    normal, _ = linalg.smallest_eigenvector_sym3x3(cov)
    vals = linalg.eigvals_sym3x3(cov)
    tot = torch.clamp_min(vals.sum(-1), 1e-12)
    return normal, torch.clamp_min(vals[..., 0], 0.0) / tot


def _orient(normal, pts, viewpoint, orient):
    if not orient:
        return normal
    flip = ((viewpoint[None, :] - pts) * normal).sum(-1) < 0
    return torch.where(flip[:, None], -normal, normal)


def _estimate_window_union(points, mask, k, viewpoint, orient, tile=256,
                           band=16):
    """Two-window UNION normals: the eigensolve runs once, on the merged
    sums, and the results scatter back to input order."""
    s, pts_a_rows, am, perm_a = _union_window_sums(points, mask, k, tile, band)
    cov, cnt = _cov_from_sums(s)
    normal_s, curv_s = _normal_and_curvature(cov)
    return _to_input_order(perm_a, _orient(normal_s, pts_a_rows, viewpoint, orient),
                           curv_s, (am > 0.5) & (cnt >= 3), mask)


def _estimate_window_moments(points, mask, k, viewpoint, orient, tile=256,
                             n_passes=2, band=16):
    """Fused window normals, pick-tighter over ``n_passes`` Morton passes.

    Pass A sorts the padded cloud and runs the kernel; each further pass
    sorts the pass-A rows by its own key, runs the kernel there and its
    rows come back to pass-A order by the inverse permutation. Per point
    the pass with more neighbours (counts clamped to k: a band selection
    may report more, and more is not tighter) wins, then the larger k-th
    row (the smaller radius). Only the per-point results scatter back to
    input order."""
    from ..kernels.knn import window_normals_tiles

    pts_a_rows, am, perm_a = _pass_a(points, mask, tile)
    out = window_normals_tiles(pts_a_rows.T.contiguous(), am[None, :], k, tile, band)
    for p in range(1, n_passes):
        row_a = neighbors._sort_perm(morton.morton_keys(pts_a_rows, am > 0.5, pass_index=p))
        out_b = torch.empty_like(out)
        out_b[:, row_a] = window_normals_tiles(pts_a_rows[row_a].T.contiguous(),
                                               am[row_a][None, :], k, tile, band)
        ca = torch.clamp_max(out[4], float(k))
        cb = torch.clamp_max(out_b[4], float(k))
        better = (cb > ca) | ((cb == ca) & (out_b[5] > out[5]))
        out = torch.where(better[None, :], out_b, out)

    return _to_input_order(perm_a, _orient(out[0:3].T, pts_a_rows, viewpoint, orient),
                           out[3], (am > 0.5) & (out[4] >= 3), mask)


def _pca_normals(nbr_pts, nbr_ok, query_pts, viewpoint, orient):
    """Covariance of the (N, k) selected neighbours from explicit
    component sums → smallest eigenvector and curvature → orientation."""
    w = nbr_ok.to(torch.float32)
    wsum = torch.clamp_min(w.sum(1), 1e-12)
    x, y, z = nbr_pts[..., 0], nbr_pts[..., 1], nbr_pts[..., 2]
    dx = x - ((x * w).sum(1) / wsum)[:, None]
    dy = y - ((y * w).sum(1) / wsum)[:, None]
    dz = z - ((z * w).sum(1) / wsum)[:, None]
    cxx = (dx * dx * w).sum(1) / wsum
    cyy = (dy * dy * w).sum(1) / wsum
    czz = (dz * dz * w).sum(1) / wsum
    cxy = (dx * dy * w).sum(1) / wsum
    cxz = (dx * dz * w).sum(1) / wsum
    cyz = (dy * dz * w).sum(1) / wsum
    cov = torch.stack([
        torch.stack([cxx, cxy, cxz], -1),
        torch.stack([cxy, cyy, cyz], -1),
        torch.stack([cxz, cyz, czz], -1)], -2)
    normal, curvature = _normal_and_curvature(cov)
    return _orient(normal, query_pts, viewpoint, orient), curvature


def _estimate_window_fused(points, mask, k, viewpoint, orient):
    """``method="window"``: two-pass window kNN left in pass-A order
    (``knn_window_sorted``, tile 128), the PCA there, and only the
    per-point results scattered back to input order."""
    neg, ids, pts_a, mask_a, perm_a = neighbors.knn_window_sorted(
        points, mask, k, tile=128, n_passes=2)
    nbr_ok = neg > -torch.inf
    nbr_pts = points[ids.long().clamp(0, points.shape[0] - 1)]
    normal_s, curv_s = _pca_normals(nbr_pts, nbr_ok, pts_a, viewpoint, orient)
    return _to_input_order(perm_a, normal_s, curv_s, mask_a & (nbr_ok.sum(1) >= 3), mask)


def _estimate(points, mask, k, use_radius, radius, viewpoint, orient,
              window=False, moments=False, window_passes=2, window_band=16,
              window_merge="tighter"):
    """Method dispatch, as the JAX ``_estimate``: for ``moments`` the
    union (merge "union", 2+ passes) or the fused pick-tighter kernel
    path, the window kNN pipeline for ``window``, else one kNN (window or
    exact) and the PCA (radius mode masks neighbours beyond ``radius``
    and falls back to plain k-NN where fewer than 3 fall inside)."""
    if moments and not use_radius:
        if window_merge == "union" and window_passes >= 2:
            return _estimate_window_union(points, mask, k, viewpoint, orient,
                                          band=window_band)
        return _estimate_window_moments(points, mask, k, viewpoint, orient,
                                        n_passes=window_passes, band=window_band)
    if window and not use_radius:
        return _estimate_window_fused(points, mask, k, viewpoint, orient)
    if window:
        knn_res = neighbors.knn_window(points, mask, k, n_passes=2, tile=128)
    else:
        knn_res = neighbors.knn(points, mask, points, mask, k)
    if use_radius:
        in_r = knn_res.mask & (knn_res.distances <= radius)
        enough = in_r.sum(1) >= 3
        nbr_ok = torch.where(enough[:, None], in_r, knn_res.mask)
    else:
        nbr_ok = knn_res.mask

    normal, curvature = _pca_normals(points[knn_res.indices], nbr_ok, points,
                                     viewpoint, orient)
    valid = mask & (nbr_ok.sum(1) >= 3)
    normal = torch.where(valid[:, None], normal, 0.0)
    return normal, torch.where(valid, curvature, 0.0), valid


def default_viewpoint(cloud: PointCloud) -> torch.Tensor:
    """bbox center lifted by the z extent."""
    mn, mx = cloud.bounding_box()
    return _viewpoint(mn, mx)


def _viewpoint(mn, mx):
    up = torch.eye(3, device=mn.device)[2]
    return (mn + mx) * 0.5 + up * torch.clamp_min(mx[2] - mn[2], 1.0)


def estimate_normals_detailed(cloud: PointCloud,
                              config: NormalEstimationConfig = NormalEstimationConfig()
                              ) -> NormalResult:
    if config.method not in ("auto", "exact", "window", "window_fast"):
        raise ValueError(
            f"unknown normal-estimation method {config.method!r}; "
            "expected auto | exact | window | window_fast")
    if config.window_passes < 1:
        raise ValueError("window_passes must be >= 1, got "
                         f"{config.window_passes}")
    if config.window_merge not in ("tighter", "union"):
        raise ValueError("window_merge must be 'tighter' or 'union', got "
                         f"{config.window_merge!r}")
    if config.radius is not None and config.method in ("window",
                                                       "window_fast"):
        raise ValueError(
            f"method={config.method!r} is a k-NN window search and cannot "
            "honor radius=; use method='exact' (radius search) or drop the "
            "radius")
    vp = (torch.tensor(config.viewpoint, dtype=torch.float32, device=cloud.device)
          if config.viewpoint is not None else default_viewpoint(cloud))
    window = config.method == "window"
    moments = config.method == "window_fast" and config.radius is None
    merge = config.window_merge
    if (config.method == "auto" and cloud.capacity >= AUTO_WINDOW_THRESHOLD
            and config.radius is None):
        moments = True
        merge = "union"
    normal, curv, valid = _estimate(
        cloud.points, cloud.mask, config.k_neighbors,
        config.radius is not None,
        config.radius if config.radius is not None else 0.0,
        vp, config.consistent_orientation, window, moments,
        int(config.window_passes), window_merge=merge)
    return NormalResult(normal, curv, valid)


def estimate_normals(cloud: PointCloud, k: int = 10, **kw) -> PointCloud:
    """Returns the cloud with a ``normals`` attribute attached."""
    res = estimate_normals_detailed(cloud, NormalEstimationConfig(k_neighbors=k, **kw))
    return cloud.with_normals(res.normals)


def estimate_normals_with_config(cloud: PointCloud,
                                 config: NormalEstimationConfig) -> PointCloud:
    return cloud.with_normals(estimate_normals_detailed(cloud, config).normals)
