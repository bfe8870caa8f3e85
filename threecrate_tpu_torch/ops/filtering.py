"""Outlier filters: statistical and radius outlier removal.

Counterpart of the outlier half of ``threecrate_tpu.ops.filtering``.
Both filters reduce to one neighbour search plus masked global
statistics, and they mask points rather than shrink the arrays
(``PointCloud.compact`` repacks):

* ``statistical_outlier_removal``: each point's mean distance to its k
  nearest neighbours; points above mean + m·σ of those means are
  dropped. Above ``AUTO_WINDOW_THRESHOLD`` points (or
  ``method="window"``) the neighbours come from the two-pass window kNN
  left in sorted order (``ops.neighbors.knn_window_sorted``, k + 1 with
  the self slot), else from the exact ``knn``;
* ``radius_outlier_removal``: points with fewer than ``min_neighbors``
  others within ``radius`` (the exact capped radius search) are dropped.

The voxel grid, passthrough and range filters are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.point_cloud import PointCloud
from . import neighbors


class OutlierResult(NamedTuple):
    cloud: PointCloud           # same capacity, outliers masked out
    inlier_mask: torch.Tensor   # (N,) bool over the input capacity


AUTO_WINDOW_THRESHOLD = 262144  # above this, "auto" takes the window search


def _statistical_mask(points, mask, k: int, std_multiplier: float, window=False):
    """(keep (N,), mean neighbour distance (N,), threshold) of SOR."""
    if window:
        # k + 1 neighbours including the self slot (distance 0), in
        # pass-A order; the self slot drops out of the count
        neg, _, _, mask_a, perm_a = neighbors.knn_window_sorted(
            points, mask, k + 1, tile=128, n_passes=2)
        ok = neg > -torch.inf
        d = torch.sqrt(torch.clamp_min(-neg, 0.0))
        cnt = torch.clamp_min(ok.sum(1) - 1, 1)
        mean_s = torch.where(ok, d, 0.0).sum(1) / cnt
        mean_dist = torch.empty_like(mean_s)
        mean_dist[perm_a] = torch.where(mask_a, mean_s, torch.inf)
        mean_dist = mean_dist[:points.shape[0]]
    else:
        res = neighbors.knn(points, mask, points, mask, k, exclude_self=True)
        mean_dist = (torch.where(res.mask, res.distances, 0.0).sum(1)
                     / torch.clamp_min(res.mask.sum(1), 1))
    valid = mask & torch.isfinite(mean_dist)
    n_valid = torch.clamp_min(valid.sum(), 1)
    mu = torch.where(valid, mean_dist, 0.0).sum() / n_valid
    var = torch.where(valid, (mean_dist - mu) ** 2, 0.0).sum() / n_valid
    thresh = mu + torch.tensor(std_multiplier, dtype=torch.float32,
                               device=points.device) * torch.sqrt(var)
    return valid & (mean_dist <= thresh), mean_dist, thresh


def statistical_outlier_removal(cloud: PointCloud, k: int = 8,
                                std_multiplier: float = 1.0,
                                method: str = "auto") -> OutlierResult:
    """Drop points whose mean k-NN distance exceeds mean + m·σ over the
    cloud. ``method``: "exact", "window" or "auto" (the window search
    above ``AUTO_WINDOW_THRESHOLD`` points)."""
    window = (method == "window"
              or (method == "auto" and cloud.capacity > AUTO_WINDOW_THRESHOLD))
    keep, _, _ = _statistical_mask(cloud.points, cloud.mask, k, std_multiplier, window)
    return OutlierResult(cloud.with_mask(keep), keep)


def statistical_outlier_removal_with_threshold(
        cloud: PointCloud, k: int = 8, std_multiplier: float = 1.0
) -> Tuple[OutlierResult, torch.Tensor, torch.Tensor]:
    """The exact SOR returning (result, per-point mean distances,
    threshold)."""
    keep, mean_dist, thresh = _statistical_mask(cloud.points, cloud.mask, k,
                                                std_multiplier)
    return OutlierResult(cloud.with_mask(keep), keep), mean_dist, thresh


def _radius_mask(points, mask, radius, min_neighbors: int, max_neighbors: int):
    res = neighbors.radius_neighbors(points, mask, points, mask, radius,
                                     max_neighbors, exclude_self=True)
    return mask & (res.mask.sum(1) >= min_neighbors)


def radius_outlier_removal(cloud: PointCloud, radius: float, min_neighbors: int,
                           max_neighbors: int = 64) -> OutlierResult:
    """Keep points with at least ``min_neighbors`` others within
    ``radius``; ``max_neighbors`` is the search capacity (raised to
    ``min_neighbors`` if smaller), where counts saturate."""
    max_neighbors = max(max_neighbors, min_neighbors)
    keep = _radius_mask(cloud.points, cloud.mask, radius, min_neighbors, max_neighbors)
    return OutlierResult(cloud.with_mask(keep), keep)
