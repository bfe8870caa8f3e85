"""Point-cloud filters: the voxel grid, outlier removal and crops.

Counterpart of ``threecrate_tpu.ops.filtering``. Filters mask points
rather than shrink the arrays (``PointCloud.compact`` repacks):

* ``voxel_grid_filter``: one centroid per occupied voxel, the key
  floor((p − min) / voxel) (an fp32 division). Rows sort by (z, y, x)
  voxel key (three stable sorts, x first, so ties keep input order as
  the JAX package's stable three-key ``lax.sort`` does), run starts are
  found on the sorted keys, each run is averaged
  (``ops.segmented.sorted_run_means``, coordinates relative to the cloud
  minimum) and the run-start rows are compacted to the front by a stable
  sort; the ``_detailed`` variant also maps every input point to its
  output row;

* ``statistical_outlier_removal``: each point's mean distance to its k
  nearest neighbours; points above mean + m·σ of those means are
  dropped. Above ``AUTO_WINDOW_THRESHOLD`` points (or
  ``method="window"``) the neighbours come from the two-pass window kNN
  left in sorted order (``ops.neighbors.knn_window_sorted``, k + 1 with
  the self slot), else from the exact ``knn``;
* ``radius_outlier_removal``: points with fewer than ``min_neighbors``
  others within ``radius`` (the exact capped radius search) are dropped;
* ``passthrough_filter`` and ``range_filter``: axis-aligned and
  spherical crops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.point_cloud import PointCloud
from . import neighbors, segmented

_SENTINEL = 2 ** 31 - 1     # voxel key of masked rows: they sort last


class VoxelGridResult(NamedTuple):
    cloud: PointCloud           # downsampled cloud (capacity = input capacity)
    num_voxels: torch.Tensor    # () int32
    voxel_index: torch.Tensor   # (N,) int32: output row of each input point, -1 if masked


def _voxel_grid(points, mask, attrs_list, voxel_size, want_inverse=True):
    """(centroids (N, 3), mask (N,), attrs, num_voxels, inverse) with the
    occupied voxels in the first rows, in (z, y, x) key order."""
    n = points.shape[0]
    mn = torch.where(mask[:, None], points, torch.inf).amin(0)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)      # all-masked cloud
    rel = points - mn
    # a true fp32 division by a device scalar (a host scalar may become a
    # multiply by its reciprocal, which moves points across voxel faces)
    voxel = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    coords = torch.floor(rel / voxel).to(torch.int32)
    coords = torch.where(mask[:, None], coords, _SENTINEL)

    perm = torch.arange(n, device=points.device)
    for axis in range(3):                               # x, then y, then z
        perm = perm[torch.sort(coords[perm, axis], stable=True).indices]
    sorted_coords = coords[perm]
    sorted_valid = sorted_coords[:, 2] != _SENTINEL
    new_run = (sorted_coords != torch.roll(sorted_coords, 1, 0)).any(1)
    new_run[0] = True
    new_run &= sorted_valid
    num_voxels = new_run.sum().to(torch.int32)

    cols, widths = [rel[perm]], []
    for a in attrs_list:
        a2 = a[perm]
        widths.append((1 if a2.ndim == 1 else a2.shape[1], a2.ndim == 1))
        cols.append(a2.reshape(n, -1).to(torch.float32))
    run_means, _ = segmented.sorted_run_means(torch.cat(cols, 1), new_run, sorted_valid)

    # run-start rows to the front, in run order
    order = torch.sort(torch.where(new_run, 0, 1), stable=True).indices
    means = run_means[order]
    out_attrs, col = [], 3
    for w, was_1d in widths:
        a_out = means[:, col:col + w]
        out_attrs.append(a_out[:, 0] if was_1d else a_out)
        col += w
    out_mask = torch.arange(n, device=points.device) < num_voxels

    if want_inverse:
        seg = torch.cumsum(new_run.to(torch.int32), 0, dtype=torch.int32) - 1
        seg = torch.where(sorted_valid, torch.clamp_min(seg, 0), n - 1)
        inv = torch.empty(n, dtype=torch.int32, device=points.device)
        inv[perm] = seg.to(torch.int32)
        inv = torch.where(mask, inv, -1)
    else:
        inv = torch.zeros((0,), dtype=torch.int32, device=points.device)
    return means[:, :3] + mn, out_mask, out_attrs, num_voxels, inv


def _check_voxel_size(voxel_size):
    if voxel_size <= 0:
        raise ValueError(f"voxel_size must be > 0, got {voxel_size}")


def voxel_grid_filter(cloud: PointCloud, voxel_size: float,
                      average_attrs: bool = True) -> PointCloud:
    """Downsample: one centroid point per occupied voxel, accumulated in
    fp32 relative to the cloud minimum (``average_attrs`` also averages
    every attribute)."""
    _check_voxel_size(voxel_size)
    keys = sorted(cloud.attrs) if average_attrs else []
    pts, mask, attr_vals, _, _ = _voxel_grid(cloud.points, cloud.mask,
                                             [cloud.attrs[k] for k in keys],
                                             voxel_size, want_inverse=False)
    return PointCloud(pts, mask, dict(zip(keys, attr_vals)))


def voxel_grid_filter_detailed(cloud: PointCloud, voxel_size: float
                               ) -> VoxelGridResult:
    """``voxel_grid_filter`` with every attribute averaged, plus the voxel
    count and each input point's output row."""
    _check_voxel_size(voxel_size)
    keys = sorted(cloud.attrs)
    pts, mask, attr_vals, nvox, inv = _voxel_grid(cloud.points, cloud.mask,
                                                  [cloud.attrs[k] for k in keys],
                                                  voxel_size)
    return VoxelGridResult(PointCloud(pts, mask, dict(zip(keys, attr_vals))), nvox, inv)


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


def passthrough_filter(cloud: PointCloud, axis: int, lo: float, hi: float) -> OutlierResult:
    """Axis-aligned crop: keep points with lo <= p[axis] <= hi."""
    v = cloud.points[:, axis]
    keep = cloud.mask & (v >= lo) & (v <= hi)
    return OutlierResult(cloud.with_mask(keep), keep)


def range_filter(cloud: PointCloud, min_range: float, max_range: float,
                 origin=None) -> OutlierResult:
    """Spherical crop: keep points whose distance to ``origin`` (default
    the coordinate origin) lies in [min_range, max_range]."""
    p = cloud.points if origin is None else cloud.points - torch.as_tensor(
        origin, dtype=torch.float32, device=cloud.device)
    r = torch.linalg.vector_norm(p, dim=1)
    keep = cloud.mask & (r >= min_range) & (r <= max_range)
    return OutlierResult(cloud.with_mask(keep), keep)
