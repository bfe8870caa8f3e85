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

NORMALS = "normals"


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

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def __len__(self) -> int:
        """Number of valid points (reads the count back from the device)."""
        return int(self.mask.sum())

    @property
    def normals(self) -> Optional[torch.Tensor]:
        return self.attrs.get(NORMALS)

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

    def bounding_box(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(min_xyz, max_xyz) over valid points."""
        m = self.mask[:, None]
        return (torch.where(m, self.points, torch.inf).amin(0),
                torch.where(m, self.points, -torch.inf).amax(0))

    def to_numpy(self) -> np.ndarray:
        """Valid points as a host ``(n, 3)`` array."""
        return self.points[self.mask].cpu().numpy()

    def compact(self, pad_multiple: int = padding.LANE) -> "PointCloud":
        """Drop invalid rows and re-pad to ``pad_multiple`` (host round trip)."""
        attrs = {k: v[self.mask].cpu().numpy() for k, v in self.attrs.items()}
        return PointCloud.from_numpy(self.to_numpy(), pad_multiple=pad_multiple,
                                     device=self.device, **attrs)
