"""Normal estimation by local PCA.

Counterpart of ``threecrate_tpu.ops.normals``. Two methods are ported:

* ``exact``: blockwise brute-force kNN (``ops.neighbors.knn``), a
  covariance from explicit component sums, the closed-form smallest
  eigenvector; the ``auto`` choice below ``AUTO_WINDOW_THRESHOLD``.
* the two-window UNION (``auto`` at and above the threshold): the cloud
  is Morton-sorted twice; the union kernels (``kernels.knn``) emit per
  point query-centred central sums over a pass-A window and the
  pass-B candidates outside it, which add; the 3x3 eigensolve runs on
  the merged sums.

Orientation flips each normal toward a viewpoint (default: the bounding
box centre raised by the z extent). ``method="window"`` and
``"window_fast"`` wait for their kernels (see ``ROADMAP.md``).
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
    or the not yet ported "window" / "window_fast"; ``window_passes``
    and ``window_merge`` configure "window_fast"."""

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


def _sort_by(keys: torch.Tensor):
    return torch.sort(keys, stable=True).indices


def _union_window_sums(points, mask, k, tile=256, band=16):
    """The two-window union up to the merged central sums.

    Returns ``(s, pts_a_rows, am, perm_a)`` in pass-A sorted order over
    the padded capacity: s (N, 10) = [count, Σ(c−q) (3), Σ(c−q)(c−q)ᵀ
    (6)], the sorted coordinates, the sorted validity (float) and the
    original row of each sorted row.
    """
    from ..kernels.knn import window_union_a_tiles, window_union_b_tiles

    n = points.shape[0]
    n_pad = padding.round_up(n, tile)
    pts = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:n] = points
    mask_p = torch.zeros(n_pad, dtype=torch.bool, device=points.device)
    mask_p[:n] = mask

    perm_a = _sort_by(morton.morton_keys(pts, mask_p, pass_index=0))
    pts_a_rows = pts[perm_a]
    am = mask_p[perm_a].to(torch.float32)
    out_a = window_union_a_tiles(pts_a_rows.T.contiguous(), am[None, :], k,
                                 tile, band)                  # (11, N) A-order

    row_a = _sort_by(morton.morton_keys(pts_a_rows, am > 0.5, pass_index=1))
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
    n = points.shape[0]
    s, pts_a_rows, am, perm_a = _union_window_sums(points, mask, k, tile, band)
    cov, cnt = _cov_from_sums(s)
    normal_s, curv_s = _normal_and_curvature(cov)
    valid_s = (am > 0.5) & (cnt >= 3)
    normal_s = _orient(normal_s, pts_a_rows, viewpoint, orient)
    normal_s = torch.where(valid_s[:, None], normal_s, 0.0)
    curv_s = torch.where(valid_s, curv_s, 0.0)

    normal = torch.empty_like(normal_s)
    curv = torch.empty_like(curv_s)
    valid = torch.empty_like(valid_s)
    normal[perm_a] = normal_s
    curv[perm_a] = curv_s
    valid[perm_a] = valid_s
    return normal[:n], curv[:n], valid[:n] & mask


def _estimate(points, mask, k, use_radius, radius, viewpoint, orient,
              window=False, moments=False, window_passes=2, window_band=16,
              window_merge="tighter"):
    """Method dispatch, as the JAX ``_estimate``: the union when
    ``moments`` with merge "union" and 2+ passes, else the exact path
    (radius mode masks neighbours beyond ``radius`` and falls back to
    plain k-NN where fewer than 3 fall inside)."""
    if moments and not use_radius:
        if window_merge == "union" and window_passes >= 2:
            return _estimate_window_union(points, mask, k, viewpoint, orient,
                                          band=window_band)
        raise NotImplementedError(
            'method="window_fast" needs the window_normals_tiles kernel, '
            "still to be ported (ROADMAP.md, section 2, kernel 4)")
    if window:
        raise NotImplementedError(
            'method="window" needs the knn_window_tiles kernel, still to be '
            "ported (ROADMAP.md, section 2, kernel 5)")
    knn_res = neighbors.knn(points, mask, points, mask, k)
    if use_radius:
        in_r = knn_res.mask & (knn_res.distances <= radius)
        enough = in_r.sum(1) >= 3
        nbr_ok = torch.where(enough[:, None], in_r, knn_res.mask)
    else:
        nbr_ok = knn_res.mask

    nbr_pts = points[knn_res.indices]                          # (N, k, 3)
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
    valid = mask & (nbr_ok.sum(1) >= 3)
    normal = _orient(normal, points, viewpoint, orient)
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
