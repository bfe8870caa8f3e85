"""OrganizedPointCloud: H×W structured grids (depth cameras, LiDAR rings).

Counterpart of ``threecrate_tpu.core.organized``: an ``(H, W, 3)``
float32 point tensor and an ``(H, W)`` validity mask on one device,
pinhole depth-image back-projection as one elementwise expression over
the image, and conversion to an unorganized ``PointCloud``. Grids are
built on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .errors import InvalidDataError
from .point_cloud import PointCloud


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float

    def as_matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class OrganizedPointCloud:
    """(H, W, 3) structured point grid with validity mask."""

    points: torch.Tensor  # (H, W, 3) float32
    mask: torch.Tensor    # (H, W) bool

    @classmethod
    def from_numpy(cls, points, mask: Optional[np.ndarray] = None,
                   device="cuda") -> "OrganizedPointCloud":
        p = torch.as_tensor(np.asarray(points, np.float32), device=device)
        if p.ndim != 3 or p.shape[-1] != 3:
            raise InvalidDataError(f"points must be (H, W, 3), got {tuple(p.shape)}")
        if mask is None:
            m = torch.isfinite(p).all(-1)
        else:
            m = torch.as_tensor(np.asarray(mask), device=device).to(torch.bool)
        return cls(p, m)

    @classmethod
    def from_depth_image(cls, depth, intrinsics: CameraIntrinsics,
                         depth_scale: float = 1000.0,
                         device="cuda") -> "OrganizedPointCloud":
        """Back-project a u16/float depth image through a pinhole model:
        z = depth/scale; x = (u-cx) z / fx; y = (v-cy) z / fy; zero depth
        is invalid."""
        d = torch.as_tensor(np.asarray(depth), device=device)
        if d.ndim != 2:
            raise InvalidDataError(f"depth must be (H, W), got {tuple(d.shape)}")
        z = d.to(torch.float32) / depth_scale
        h, w = d.shape
        v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
        u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
        x = (u - intrinsics.cx) * z / intrinsics.fx
        y = (v - intrinsics.cy) * z / intrinsics.fy
        pts = torch.stack([x, y, z], dim=-1)
        valid = z > 0
        return cls(torch.where(valid[..., None], pts, 0.0), valid)

    @property
    def height(self) -> int:
        return self.points.shape[0]

    @property
    def width(self) -> int:
        return self.points.shape[1]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def is_dense(self) -> torch.Tensor:
        """True when every cell is valid (PointCloud2's is_dense)."""
        return self.mask.all()

    def size(self) -> torch.Tensor:
        return self.mask.sum().to(torch.int32)

    def at(self, row, col):
        """(point, valid) at a grid cell; padded cells return zeros."""
        return self.points[row, col], self.mask[row, col]

    def row(self, r):
        return self.points[r], self.mask[r]

    def ring(self, r):
        """LiDAR alias: a 'ring' is a row."""
        return self.row(r)

    def to_unorganized(self) -> PointCloud:
        """Flatten to an (H*W,)-capacity PointCloud keeping the mask."""
        return PointCloud(self.points.reshape(-1, 3), self.mask.reshape(-1), {})

    def to_numpy(self) -> np.ndarray:
        return self.points.reshape(-1, 3)[self.mask.reshape(-1)].cpu().numpy()
