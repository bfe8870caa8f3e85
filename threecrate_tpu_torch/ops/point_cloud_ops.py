"""PointCloud neighbour conveniences.

Counterpart of ``threecrate_tpu.ops.point_cloud_ops`` (the reference's
``PointCloudNeighbors`` extension trait, point_cloud_ops.rs:7-40): all-
points kNN and single-query variants as free functions, attached to
``PointCloud`` as methods, and ``concatenate``. Everything runs on the
cloud's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from . import neighbors


def concatenate(clouds: Sequence[PointCloud]) -> PointCloud:
    """Merge point clouds into one (threecrate-python/src/lib.rs:1634):
    capacities add, masks concatenate, attribute keys are unioned (a
    cloud missing an attribute contributes zero rows for it, with the
    dtype of the first cloud that has it). ``compact()`` afterwards to
    re-pad."""
    clouds = list(clouds)
    if not clouds:
        raise InvalidDataError("concatenate requires at least one cloud")
    if len(clouds) == 1:
        return clouds[0]
    keys = set()
    for c in clouds:
        keys |= set(c.attrs)
    attrs = {}
    for k in keys:
        proto = next(c.attrs[k] for c in clouds if k in c.attrs)
        attrs[k] = torch.cat([c.attrs[k] if k in c.attrs
                              else proto.new_zeros((c.capacity,) + proto.shape[1:])
                              for c in clouds])
    return PointCloud(torch.cat([c.points for c in clouds]),
                      torch.cat([c.mask for c in clouds]), attrs)


def k_nearest_neighbors(cloud: PointCloud, k: int,
                        exclude_self: bool = True) -> neighbors.KnnResult:
    """kNN of every point against its own cloud
    (point_cloud_ops.rs:7-40)."""
    return neighbors.knn(cloud.points, cloud.mask, cloud.points, cloud.mask, k,
                         exclude_self=exclude_self)


def nearest_neighbor(cloud: PointCloud, query) -> Tuple[int, float]:
    """Single-query nearest point: (index, distance)."""
    res = neighbors.BruteForceSearch(cloud).find_k_nearest(query, 1)
    return int(res.indices[0, 0]), float(res.distances[0, 0])


def neighbors_within(cloud: PointCloud, query, radius: float,
                     max_neighbors: int = 64) -> np.ndarray:
    """Indices of cloud points within ``radius`` of one query point
    (host array, nearest first)."""
    res = neighbors.BruteForceSearch(cloud).find_radius_neighbors(query, radius, max_neighbors)
    return res.indices[0][res.mask[0]].cpu().numpy()


# attach as methods (extension-trait style)
PointCloud.k_nearest_neighbors = (
    lambda self, k, exclude_self=True: k_nearest_neighbors(self, k, exclude_self))
PointCloud.nearest_neighbor = lambda self, q: nearest_neighbor(self, q)
PointCloud.neighbors_within = (
    lambda self, q, radius, max_neighbors=64:
    neighbors_within(self, q, radius, max_neighbors))
