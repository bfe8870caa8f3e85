"""KISS-ICP odometry registration (Vizzo et al., IROS 2023).

Counterpart of ``threecrate_tpu.ops.kiss_icp``: a range gate
[min, max], voxel downsampling of the source scan, the adaptive
correspondence threshold ``σ = clamp(3·‖motion‖, 3·voxel, 10·voxel)``
and point-to-point ICP (``ops.registration``) gated at σ.
``KissIcpOdometry`` keeps a voxel-downsampled local map on the scans'
device at a fixed capacity and a constant-velocity motion prior.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.point_cloud import PointCloud
from ..core.transform import Transform
from ..utils import padding
from . import filtering, registration


@dataclasses.dataclass(frozen=True)
class KissIcpConfig:
    """The JAX package's config, field for field."""

    voxel_size: float = 1.0
    max_range: float = 100.0
    min_range: float = 0.5
    max_iterations: int = 50
    convergence_threshold: float = 1e-6


def motion_magnitude(t: Transform) -> float:
    """Characteristic displacement of a rigid motion: ‖t‖ plus the
    rotational sweep at a 10 m lever arm (the adaptive σ's input)."""
    m = t.matrix.to(torch.float32).cpu()
    # ‖t‖ as the JAX package's fp32 norm rounds it: x0², then an FMA (one
    # rounding) per further term; the trace summed left to right in fp32
    v = m[:3, 3].numpy()
    acc = np.float32(v[0] * v[0])
    for x in v[1:]:
        acc = np.float32(np.float64(x) * np.float64(x) + np.float64(acc))
    trans = float(np.sqrt(acc))
    cos_theta = (float(m[0, 0] + m[1, 1] + m[2, 2]) - 1.0) / 2.0
    theta = float(np.arccos(np.clip(cos_theta, -1.0, 1.0)))
    return trans + 10.0 * theta


def adaptive_threshold(config: KissIcpConfig, init: Optional[Transform]) -> float:
    """σ = clamp(3·‖motion(init)‖, 3·voxel, 10·voxel)."""
    motion = motion_magnitude(init) if init is not None else 0.0
    return float(np.clip(3.0 * motion, 3.0 * config.voxel_size, 10.0 * config.voxel_size))


def preprocess(cloud: PointCloud, config: KissIcpConfig) -> PointCloud:
    """Range gate, then voxel downsample."""
    gated = filtering.range_filter(cloud, config.min_range, config.max_range).cloud
    return filtering.voxel_grid_filter(gated, config.voxel_size)


def kiss_icp(source: PointCloud, target: PointCloud,
             config: KissIcpConfig = KissIcpConfig(),
             init: Optional[Transform] = None) -> registration.ICPResult:
    """Register a LiDAR scan against a local map, KISS-ICP style."""
    src = preprocess(source, config)
    tgt_gated = filtering.range_filter(target, config.min_range, config.max_range).cloud
    return registration.icp_point_to_point(
        src, tgt_gated, max_iterations=config.max_iterations,
        convergence_threshold=config.convergence_threshold,
        max_correspondence_distance=adaptive_threshold(config, init), init=init)


class KissIcpOdometry:
    """Frame-to-map odometry: a voxel-downsampled local map and a
    constant-velocity motion prior.

    The map stays on the scans' device at a fixed capacity
    (``map_capacity`` rounded up to 128 rows): each frame concatenates
    the new scan in world coordinates, voxel-filters the union (valid
    centroids first) and crops it to the capacity, so the map's shape
    never changes and no frame copies it to the host. Poses live on the
    scans' device too.
    """

    def __init__(self, config: KissIcpConfig = KissIcpConfig(),
                 map_capacity: int = 1 << 18):
        self.config = config
        self.map_capacity = padding.round_up(map_capacity, 128)
        self.pose = Transform.identity()
        self._prev_delta = Transform.identity()
        self._map_pc: Optional[PointCloud] = None

    @property
    def local_map(self) -> Optional[PointCloud]:
        return self._map_pc

    def register_frame(self, scan: PointCloud) -> Transform:
        src = preprocess(scan, self.config)
        if self._map_pc is None:
            self.pose = Transform.identity(scan.device)
            self._prev_delta = Transform.identity(scan.device)
            self._update_map(src, self.pose)
            return self.pose
        prior = self.pose @ self._prev_delta  # constant-velocity prediction
        result = kiss_icp(src, self.local_map, self.config, init=prior)
        new_pose = result.as_transform()
        self._prev_delta = self.pose.inverse() @ new_pose
        self.pose = new_pose
        self._update_map(src, new_pose)
        return self.pose

    def _update_map(self, scan: PointCloud, pose: Transform) -> None:
        world = scan.transform(pose)
        if self._map_pc is None:
            merged = PointCloud(world.points, world.mask, {})
        else:
            merged = PointCloud(torch.cat([self._map_pc.points, world.points]),
                                torch.cat([self._map_pc.mask, world.mask]), {})
        dedup = filtering.voxel_grid_filter(merged, self.config.voxel_size)
        # valid centroids come first: the crop keeps the shape fixed and
        # drops the back of the voxel order where the map overflows
        self._map_pc = PointCloud(dedup.points[:self.map_capacity],
                                  dedup.mask[:self.map_capacity], {})
