"""Padding policy of the port: clouds are padded to a multiple of the
kernel tile width. The JAX package's geometric capacity buckets exist
for XLA's shape-keyed compile cache; eager PyTorch has none, so only
the round-up is kept. ``pad_capacity`` keeps the JAX signature and maps
onto that policy: every capacity is the lane round-up of ``n`` (at least
one lane), and ``geometric`` is accepted and changes nothing.

The masked reductions and ``bounding_box`` run on the inputs' device;
``pad_array`` and ``make_mask`` are host (NumPy) helpers, as in JAX."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Row multiple every padded cloud keeps (the ICP tile width).
LANE = 128


def round_up(n: int, multiple: int = LANE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_capacity(n: int, multiple: int = LANE, geometric: bool = True) -> int:
    """Capacity for ``n`` items: ``n`` rounded up to ``multiple`` (one
    ``multiple`` for ``n <= 0``). ``geometric`` is kept for the JAX
    signature; the port keeps no capacity buckets."""
    return multiple if n <= 0 else round_up(n, multiple)


def pad_array(x: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of ``x`` to ``capacity`` with ``fill``."""
    n = x.shape[0]
    if n > capacity:
        raise ValueError(f"array length {n} exceeds capacity {capacity}")
    if n == capacity:
        return x
    pad_width = [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def make_mask(n: int, capacity: int) -> np.ndarray:
    m = np.zeros((capacity,), dtype=bool)
    m[:n] = True
    return m


def _rows(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return mask[..., None] if x.ndim > mask.ndim else mask


def masked_min(x: torch.Tensor, mask: torch.Tensor, axis=0) -> torch.Tensor:
    return torch.where(_rows(x, mask), x, torch.inf).to(x.dtype).amin(axis)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis=0) -> torch.Tensor:
    return torch.where(_rows(x, mask), x, -torch.inf).to(x.dtype).amax(axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=0) -> torch.Tensor:
    s = torch.where(_rows(x, mask), x, 0.0).sum(axis)
    cnt = torch.clamp_min(mask.sum(axis), 1)
    return s / cnt.to(x.dtype)


def bounding_box(points: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min_xyz, max_xyz) over valid points."""
    return masked_min(points, mask), masked_max(points, mask)
