"""Segmentation: RANSAC plane fitting and Euclidean clustering.

Counterpart of ``threecrate_tpu.ops.segmentation``:

* ``segment_plane``: all ``max_iterations`` plane hypotheses are fit
  from point triples at once and scored against every point, then the
  best is refit by a masked PCA. The triples are drawn on the host with
  a CPU ``torch.Generator`` seeded with ``seed`` (``_sample_triples``)
  and moved to the cloud's device, so the card and the CPU score the
  same hypotheses; the JAX package draws them with
  ``jax.random.choice``, which torch cannot reproduce. The scorer
  (``_plane_ransac``) takes the ``(H, 3)`` indices and counts inliers
  ``_SCORE_ELEMENTS`` point-hypothesis pairs at a time (the counts are
  integer sums, so chunking does not change them); the best hypothesis
  is the first of the largest count, as ``jnp.argmax`` picks it.
* ``extract_euclidean_clusters``: connected components of the
  ``tolerance``-radius graph by label propagation with pointer jumping
  (min-label relaxation, then two jumps an iteration), ranked largest
  first by a stable sort. Each iteration checks on the host whether a
  label changed: one host sync an iteration. ``counts`` holds the
  iterations and syncs since ``reset_counts()``.

The point-plane products and the radius search's distances are full
fp32 (``neighbors._cross``: an fp32 matmul on the card, XLA's FMA chain
on the CPU).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from . import linalg, neighbors

_SCORE_ELEMENTS = 2 ** 24   # point-hypothesis pairs scored at a time

# label-propagation iterations and their host syncs since reset_counts()
counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


# ---------------------------------------------------------------------------
# plane RANSAC
# ---------------------------------------------------------------------------

class PlaneModel(NamedTuple):
    """ax + by + cz + d = 0, ‖(a,b,c)‖ = 1 (segmentation.rs:14-93)."""

    normal: torch.Tensor  # (3,)
    d: torch.Tensor       # scalar

    def distances(self, points: torch.Tensor) -> torch.Tensor:
        return torch.abs(neighbors._cross(points, self.normal[None])[:, 0] + self.d)

    @property
    def coefficients(self) -> torch.Tensor:
        return torch.cat([self.normal, self.d[None]])


class PlaneSegmentationResult(NamedTuple):
    """Native fields plus the reference class surface
    (threecrate-python/src/lib.rs:643-693: ``plane_coefficients()``,
    ``inlier_indices()``, ``num_inliers``, ``inlier_cloud()``)."""

    model: PlaneModel
    inlier_mask: torch.Tensor   # (N,) bool
    inlier_count: torch.Tensor  # scalar int32

    def plane_coefficients(self) -> np.ndarray:
        """[a, b, c, d] as a host (4,) float32 array (lib.rs:655)."""
        return self.model.coefficients.cpu().numpy().astype(np.float32)

    def inlier_indices(self) -> np.ndarray:
        """Sorted indices of inlier rows (lib.rs:661)."""
        return np.flatnonzero(self.inlier_mask.cpu().numpy())

    @property
    def num_inliers(self) -> int:
        return int(self.inlier_mask.sum())

    def inlier_cloud(self, cloud: PointCloud) -> PointCloud:
        """Compacted cloud of just the inliers (lib.rs:672)."""
        return cloud.select(self.inlier_mask).compact()


def _sample_triples(mask: torch.Tensor, n_hyp: int, seed: int) -> torch.Tensor:
    """(n_hyp, 3) int64 point indices drawn uniformly, with replacement,
    from the valid rows, by a CPU generator seeded with ``seed``; on the
    mask's device."""
    valid = torch.nonzero(mask.cpu()).flatten()
    if valid.numel() == 0:
        valid = torch.arange(mask.shape[0])
    gen = torch.Generator().manual_seed(int(seed))
    pick = torch.randint(0, valid.numel(), (n_hyp, 3), generator=gen)
    return valid[pick].to(mask.device)


def _plane_ransac(points: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                  dist_thresh: float):
    """Score the planes through the ``(H, 3)`` triples ``idx``: (normal,
    d, inlier count) of the first hypothesis with the most inliers
    within ``dist_thresh``, and the (H,) counts (−1 for a collinear
    triple)."""
    tri = points[idx]                                       # (H, 3, 3)
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    nn = torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
    ok_h = nn[:, 0] > 1e-12                                 # non-collinear triple
    nrm = nrm / torch.clamp_min(nn, 1e-30)
    d = -(nrm * tri[:, 0]).sum(1)                           # (H,)
    thr = torch.tensor(dist_thresh, dtype=torch.float32).item()

    n_hyp = idx.shape[0]
    rows = max(1, _SCORE_ELEMENTS // n_hyp)
    total = torch.zeros(n_hyp, dtype=torch.int64, device=points.device)
    for r0 in range(0, points.shape[0], rows):
        dist = torch.abs(neighbors._cross(points[r0:r0 + rows], nrm) + d[None, :])
        total += ((dist <= thr) & mask[r0:r0 + rows, None]).sum(0)
    cnt = torch.where(ok_h, total, -1)
    first = torch.arange(n_hyp, device=points.device)
    best = torch.where(cnt == cnt.max(), first, n_hyp).amin()
    return nrm[best], d[best], cnt[best], cnt


def _refine_plane(points: torch.Tensor, inlier_mask: torch.Tensor):
    """Least-squares refit on the inlier set (PCA smallest axis)."""
    mean, cov = linalg.weighted_covariance(points[None], inlier_mask.to(torch.float32)[None])
    nrm, _ = linalg.smallest_eigenvector_sym3x3(cov[0])
    return nrm, -(nrm * mean[0]).sum()


def segment_plane(cloud: PointCloud, distance_threshold: float = 0.01,
                  max_iterations: int = 1000, seed: int = 0,
                  refine: bool = True) -> PlaneSegmentationResult:
    """RANSAC plane segmentation (segmentation.rs:117-180). All
    ``max_iterations`` hypotheses are scored in one pass over the
    points."""
    if cloud.capacity < 3:
        raise InvalidDataError("plane segmentation needs >= 3 points")
    idx = _sample_triples(cloud.mask, max_iterations, seed)
    nrm, d, _, _ = _plane_ransac(cloud.points, cloud.mask, idx, distance_threshold)
    model = PlaneModel(nrm, d)
    inliers = cloud.mask & (model.distances(cloud.points) <= distance_threshold)
    if refine:
        model = PlaneModel(*_refine_plane(cloud.points, inliers))
        inliers = cloud.mask & (model.distances(cloud.points) <= distance_threshold)
    return PlaneSegmentationResult(model, inliers, inliers.sum().to(torch.int32))


# the reference ships a rayon-parallel variant (segmentation.rs:194);
# the batched scorer above is already the parallel one
segment_plane_parallel = segment_plane


def extract_plane(cloud: PointCloud, result: PlaneSegmentationResult,
                  negative: bool = False) -> PointCloud:
    """Keep inliers (or the complement when ``negative``)."""
    keep = ~result.inlier_mask if negative else result.inlier_mask
    return cloud.select(keep)


# ---------------------------------------------------------------------------
# euclidean clustering
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EuclideanClusterConfig:
    """Mirrors EuclideanClusterConfig (segmentation.rs:328-357)."""

    tolerance: float = 0.02
    min_cluster_size: int = 1
    max_cluster_size: int = 2 ** 31 - 1
    max_neighbors: int = 32

    def __post_init__(self):
        if self.tolerance <= 0:
            raise ValueError(
                f"tolerance must be positive, got {self.tolerance}")
        if self.min_cluster_size < 1:
            raise ValueError(
                f"min_cluster_size must be >= 1, got {self.min_cluster_size}")
        if self.max_cluster_size < self.min_cluster_size:
            raise ValueError("max_cluster_size must be >= min_cluster_size")
        if self.max_neighbors < 1:
            raise ValueError(
                f"max_neighbors must be >= 1, got {self.max_neighbors}")


class ClusterResult(NamedTuple):
    labels: torch.Tensor      # (N,) int32 cluster id by size rank, -1 = noise
    n_clusters: torch.Tensor  # scalar int32
    sizes: torch.Tensor       # (N,) int32, sizes[i] = size of cluster i (padded 0)


def _propagate(nbr: neighbors.KnnResult, mask: torch.Tensor) -> torch.Tensor:
    """Component roots (the least valid index of each component) from the
    radius graph ``nbr``; invalid rows start at n − 1, as in the JAX
    package, and keep that label."""
    n = mask.shape[0]
    rows = torch.arange(n, device=mask.device)
    nbr_idx = torch.where(nbr.mask, nbr.indices, rows[:, None])
    labels = torch.where(mask, rows.to(torch.int32), n - 1)
    it, changed = 0, True
    while changed and it < n:
        new = torch.minimum(labels, labels[nbr_idx].amin(1))
        new = torch.where(mask, new, labels)
        new = new[new.long()]                  # pointer jumping, twice
        new = new[new.long()]
        changed = bool((new != labels).any())
        counts["iterations"] += 1
        counts["syncs"] += 1
        labels, it = new, it + 1
    return labels


def _rank_clusters(roots: torch.Tensor, mask: torch.Tensor, min_size: int,
                   max_size: int):
    """(labels, n_clusters, sizes): clusters within the size bounds ranked
    by size, largest first, ties by root index (a stable sort)."""
    n = roots.shape[0]
    r = roots.long()
    sizes_by_root = torch.zeros(n, dtype=torch.int32, device=roots.device).index_add_(
        0, torch.where(mask, r, n - 1), mask.to(torch.int32))
    size_of = sizes_by_root[r]
    keep = mask & (size_of >= min_size) & (size_of <= max_size)
    is_root = (torch.arange(n, device=roots.device) == r) & keep
    root_size = torch.where(is_root, sizes_by_root, -1)
    order = torch.argsort(-root_size, stable=True)             # roots big → small
    rank = torch.empty(n, dtype=torch.int32, device=roots.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=roots.device)
    labels = torch.where(keep, rank[r], -1)
    n_clusters = is_root.sum().to(torch.int32)
    ranked = root_size[order]
    return labels, n_clusters, torch.where(ranked > 0, ranked, 0)


def extract_euclidean_clusters(cloud: PointCloud,
                               config: EuclideanClusterConfig =
                               EuclideanClusterConfig()) -> ClusterResult:
    """Connected components over the ``tolerance``-radius graph,
    size-filtered and sorted largest-first (segmentation.rs:396-460).

    As in the JAX package, a point keeps at most ``max_neighbors``
    neighbours (the nearest); in dense blobs they still chain."""
    nbr = neighbors.radius_neighbors(cloud.points, cloud.mask, cloud.points, cloud.mask,
                                     config.tolerance, config.max_neighbors)
    roots = _propagate(nbr, cloud.mask)
    return ClusterResult(*_rank_clusters(roots, cloud.mask, config.min_cluster_size,
                                         config.max_cluster_size))


def cluster_indices(result: ClusterResult, cluster_id: int) -> np.ndarray:
    """Host helper: numpy indices of one cluster."""
    return np.nonzero(result.labels.cpu().numpy() == cluster_id)[0]
