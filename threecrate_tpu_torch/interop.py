"""State carried between the JAX package and the port, as numpy arrays.

``cloud_from_numpy`` and ``transform_from_numpy`` take a JAX
``PointCloud`` or ``Transform`` read as numpy arrays (padding and mask
included, so both packages see the same capacity) and build the port's
types; ``cloud_to_numpy`` and ``transform_to_numpy`` go back.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.point_cloud import PointCloud
from .core.transform import Transform


def cloud_from_numpy(points, mask, attrs: Optional[Dict] = None,
                     device="cpu") -> PointCloud:
    """A port ``PointCloud`` with exactly these padded rows and mask."""
    def put(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return PointCloud(put(points, torch.float32), put(mask, torch.bool),
                      {k: put(v, torch.float32) for k, v in (attrs or {}).items()})


def transform_from_numpy(m, device="cpu") -> Transform:
    return Transform(torch.as_tensor(np.array(m), dtype=torch.float32,
                                     device=device))


def cloud_to_numpy(cloud: PointCloud) -> Tuple[np.ndarray, np.ndarray,
                                               Dict[str, np.ndarray]]:
    """(points, mask, attrs) of a port cloud, padding included."""
    return (cloud.points.cpu().numpy(), cloud.mask.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in cloud.attrs.items()})


def transform_to_numpy(t: Transform) -> np.ndarray:
    return t.matrix.cpu().numpy()
