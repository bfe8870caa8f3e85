"""PointCloud: a padded ``(capacity, 3)`` tensor plus a validity mask.

Counterpart of ``threecrate_tpu.core.point_cloud``: structure of
arrays, one float32 position tensor, one bool mask and optional
per-point attribute tensors (normals, colors, intensity), all with
leading dimension ``capacity`` and all on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.linalg import fp32_matmul
from ..utils import padding
from .errors import InvalidDataError
from .transform import Transform

# Attribute keys with reserved semantics (the JAX package's)
NORMALS = "normals"      # (N, 3) float32 unit vectors
COLORS = "colors"        # (N, 3) float32 in [0, 1]
INTENSITY = "intensity"  # (N,) float32 LiDAR return strength


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud.

    Attributes:
      points: ``(capacity, 3)`` float32. Rows where ``mask`` is False are
        padding (zeros).
      mask: ``(capacity,)`` bool validity mask.
      attrs: per-point attribute tensors, leading dim ``capacity``.
    """

    points: torch.Tensor
    mask: torch.Tensor
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_numpy(cls, points, capacity: Optional[int] = None,
                   pad_multiple: int = padding.LANE, device="cuda",
                   **attrs) -> "PointCloud":
        """Build from an ``(N, 3)`` host array, padded to ``capacity``
        (default: ``N`` rounded up to ``pad_multiple``), on ``device``:
        the card unless the caller asks for the CPU."""
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise InvalidDataError(f"points must be (N, 3), got {pts.shape}")
        n = pts.shape[0]
        cap = capacity if capacity is not None else padding.round_up(
            max(n, 1), pad_multiple)
        if n > cap:
            raise InvalidDataError(f"{n} points exceed capacity {cap}")

        def pad(v):
            out = torch.zeros((cap,) + v.shape[1:], dtype=torch.float32,
                              device=device)
            out[:n] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            return out

        out_attrs = {}
        for k, v in attrs.items():
            if v is None:
                continue
            v = np.asarray(v, dtype=np.float32)
            if v.shape[0] != n:
                raise InvalidDataError(
                    f"attribute {k!r} length {v.shape[0]} != {n} points")
            out_attrs[k] = pad(v)
        mask = torch.zeros(cap, dtype=torch.bool, device=device)
        mask[:n] = True
        return cls(pad(pts), mask, out_attrs)

    @classmethod
    def from_points(cls, points, mask=None, **attrs) -> "PointCloud":
        """Wrap ``(capacity, 3)`` tensors where they lie (no copy for a
        float32 tensor); the mask defaults to all valid."""
        points = torch.as_tensor(points, dtype=torch.float32)
        if mask is None:
            mask = torch.ones(points.shape[:1], dtype=torch.bool, device=points.device)
        return cls(points, torch.as_tensor(mask, dtype=torch.bool, device=points.device),
                   {k: torch.as_tensor(v, device=points.device)
                    for k, v in attrs.items() if v is not None})

    @classmethod
    def empty(cls, capacity: int = padding.LANE, device="cuda") -> "PointCloud":
        return cls(torch.zeros((capacity, 3), dtype=torch.float32, device=device),
                   torch.zeros((capacity,), dtype=torch.bool, device=device), {})

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def size(self) -> torch.Tensor:
        """Number of valid points, an int32 tensor on the cloud's device."""
        return self.mask.sum().to(torch.int32)

    def __len__(self) -> int:
        """Number of valid points (reads the count back from the device)."""
        return int(self.mask.sum())

    def is_empty(self) -> torch.Tensor:
        return ~self.mask.any()

    def has(self, key: str) -> bool:
        return key in self.attrs

    @property
    def normals(self) -> Optional[torch.Tensor]:
        return self.attrs.get(NORMALS)

    @property
    def colors(self) -> Optional[torch.Tensor]:
        return self.attrs.get(COLORS)

    def with_attr(self, key: str, value: torch.Tensor) -> "PointCloud":
        """Attach a per-point attribute aligned with the array slots;
        a shorter value is zero-padded, a longer one is an error."""
        cap = self.capacity
        if value.shape[0] > cap:
            raise InvalidDataError(
                f"attribute {key!r} has {value.shape[0]} rows but the "
                f"cloud capacity is {cap}")
        if value.shape[0] < cap:
            pad = value.new_zeros((cap - value.shape[0],) + value.shape[1:])
            value = torch.cat([value, pad])
        return PointCloud(self.points, self.mask, {**self.attrs, key: value})

    def with_normals(self, normals: torch.Tensor) -> "PointCloud":
        return self.with_attr(NORMALS, normals)

    def with_colors(self, colors: torch.Tensor) -> "PointCloud":
        return self.with_attr(COLORS, colors)

    def with_points(self, points: torch.Tensor) -> "PointCloud":
        return PointCloud(points, self.mask, self.attrs)

    def with_mask(self, mask: torch.Tensor) -> "PointCloud":
        """Replace the validity mask (e.g. after a filter). Same capacity."""
        return PointCloud(self.points, mask, self.attrs)

    def select(self, keep: torch.Tensor) -> "PointCloud":
        """Mask-and intersection: keep points where ``keep`` & valid."""
        return self.with_mask(self.mask & keep)

    def transform(self, t: Transform) -> "PointCloud":
        """Apply a rigid transform (its matrix moved to the cloud's
        device); normals, where present, rotate with it. Mask and other
        attributes are kept."""
        t = Transform(t.matrix.to(self.device))
        attrs = dict(self.attrs)
        if NORMALS in attrs:
            attrs[NORMALS] = fp32_matmul(attrs[NORMALS], t.rotation.T)
        return PointCloud(t.apply(self.points), self.mask, attrs)

    def extend(self, other: "PointCloud") -> "PointCloud":
        """Concatenate another cloud after this one: capacities add, masks
        concatenate, valid rows stay where they were. Attributes are the
        union of both clouds' keys; a side without one contributes zero
        rows for it."""
        attrs = {}
        for k in set(self.attrs) | set(other.attrs):
            a, b = self.attrs.get(k), other.attrs.get(k)
            if a is None:
                a = b.new_zeros((self.capacity,) + b.shape[1:])
            if b is None:
                b = a.new_zeros((other.capacity,) + a.shape[1:])
            attrs[k] = torch.cat([a, b])
        return PointCloud(torch.cat([self.points, other.points]),
                          torch.cat([self.mask, other.mask]), attrs)

    def __add__(self, other: "PointCloud") -> "PointCloud":
        return self.extend(other)

    def bounding_box(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(min_xyz, max_xyz) over valid points."""
        return padding.bounding_box(self.points, self.mask)

    def center(self) -> torch.Tensor:
        mn, mx = self.bounding_box()
        return (mn + mx) * 0.5

    def centroid(self) -> torch.Tensor:
        return padding.masked_mean(self.points, self.mask)

    def to_numpy(self) -> np.ndarray:
        """Valid points as a host ``(n, 3)`` array."""
        return self.points[self.mask].cpu().numpy()

    def attr_to_numpy(self, key: str) -> np.ndarray:
        return self.attrs[key][self.mask].cpu().numpy()

    def compact(self, pad_multiple: int = padding.LANE) -> "PointCloud":
        """Drop invalid rows and re-pad to ``pad_multiple`` (host round trip)."""
        attrs = {k: v[self.mask].cpu().numpy() for k, v in self.attrs.items()}
        return PointCloud.from_numpy(self.to_numpy(), pad_multiple=pad_multiple,
                                     device=self.device, **attrs)

    def pack(self) -> "PointCloud":
        """Valid rows to the front, same capacity, on the device: one
        stable sort of the invalid flag, so valid rows keep their order."""
        order = torch.sort(self.mask.logical_not().to(torch.int32), stable=True).indices
        return PointCloud(self.points[order], self.mask[order],
                          {k: v[order] for k, v in self.attrs.items()})
