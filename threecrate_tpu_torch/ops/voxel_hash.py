"""Sorted voxel-hash grid: integer voxel keys in place of a hash map.

Counterpart of ``threecrate_tpu.ops.voxel_hash``: a linear voxel key per
point, one stable device sort, run-boundary detection, and
``searchsorted`` lookups of points and cell ranges. Every tensor has a
fixed shape (the cloud's capacity), and the grid stays on the cloud's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import segmented

INVALID_KEY = 2 ** 31 - 1   # key of masked rows and out-of-grid coordinates


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Sorted voxel index over a padded point set.

    Attributes:
      origin: (3,) grid origin (min corner of valid points).
      dims: (3,) int32 cell counts per axis.
      cell: () cell size.
      sorted_keys: (N,) int32 linear keys ascending; invalid rows hold
        ``INVALID_KEY`` and sort to the end.
      perm: (N,) int64 original point index per sorted row.
      unique_keys: (N,) int32 first-occurrence keys, compacted to the
        front; rows past ``n_cells`` are ``INVALID_KEY``.
      cell_starts / cell_counts: (N,) int32 run start / length per unique
        key (aligned with ``unique_keys``).
      n_cells: () int32.
    """

    origin: torch.Tensor
    dims: torch.Tensor
    cell: torch.Tensor
    sorted_keys: torch.Tensor
    perm: torch.Tensor
    unique_keys: torch.Tensor
    cell_starts: torch.Tensor
    cell_counts: torch.Tensor
    n_cells: torch.Tensor

    def coords_of(self, points: torch.Tensor) -> torch.Tensor:
        return torch.floor((points - self.origin) / self.cell).to(torch.int32)

    def key_of_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """Linear key; out-of-grid coordinates map to ``INVALID_KEY``."""
        inb = ((coords >= 0) & (coords < self.dims)).all(-1)
        key = (coords[..., 2] * self.dims[1] + coords[..., 1]) * self.dims[0] \
            + coords[..., 0]
        return torch.where(inb, key, INVALID_KEY)

    def key_of(self, points: torch.Tensor) -> torch.Tensor:
        return self.key_of_coords(self.coords_of(points))

    def lookup(self, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Key → (cell_index, found); cell_index indexes ``unique_keys`` rows."""
        pos = torch.searchsorted(self.unique_keys, keys.contiguous())
        pos = pos.clamp(0, self.unique_keys.shape[0] - 1)
        found = (self.unique_keys[pos] == keys) & (keys != INVALID_KEY)
        return pos, found

    def range_of(self, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Key → (start, count) into the sorted point order (count 0 where
        absent)."""
        pos, found = self.lookup(keys)
        start = torch.where(found, self.cell_starts[pos], 0)
        count = torch.where(found, self.cell_counts[pos], 0)
        return start, count

    def gather_neighbors(self, points: torch.Tensor, cap_per_cell: int,
                         ring: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Candidate point indices from the (2·ring+1)³ neighbourhood:
        (indices (Q, cells·cap) into the ORIGINAL point array, valid
        mask). At most ``cap_per_cell`` points a cell; a fuller cell is
        truncated."""
        coords = self.coords_of(points)                            # (Q, 3)
        r = range(-ring, ring + 1)
        off = torch.tensor([(dx, dy, dz) for dz in r for dy in r for dx in r],
                           dtype=torch.int32, device=points.device)  # (C, 3)
        keys = self.key_of_coords(coords[:, None, :] + off[None])  # (Q, C)
        start, count = self.range_of(keys)
        slot = torch.arange(cap_per_cell, dtype=torch.int32, device=points.device)
        idx_sorted = (start[..., None] + slot).clamp(0, self.perm.shape[0] - 1)
        valid = slot < count[..., None]
        q = points.shape[0]
        return self.perm[idx_sorted.long()].reshape(q, -1), valid.reshape(q, -1)


def build_voxel_grid(points: torch.Tensor, mask: torch.Tensor, cell_size) -> VoxelGrid:
    """The sorted grid index of ``points`` (masked rows excluded).

    Requires nx·ny·nz < 2³¹ over the cloud's bounding box; degenerate
    combinations get their keys clamped into the grid."""
    n = points.shape[0]
    dev = points.device
    cell = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    origin = torch.where(mask[:, None], points, 3e38).amin(0)
    maxc = torch.where(mask[:, None], points, -3e38).amax(0)
    dims = torch.clamp_min(torch.floor((maxc - origin) / cell).to(torch.int32) + 1, 1)

    coords = torch.floor((points - origin) / cell).to(torch.int32)
    coords = torch.minimum(coords.clamp_min(0), dims - 1)
    key = (coords[:, 2] * dims[1] + coords[:, 1]) * dims[0] + coords[:, 0]
    key = torch.where(mask, key, INVALID_KEY)
    sorted_keys, perm = torch.sort(key, stable=True)

    valid_sorted = sorted_keys != INVALID_KEY
    new_run = torch.ones_like(valid_sorted)
    new_run[1:] = sorted_keys[1:] != sorted_keys[:-1]
    new_run &= valid_sorted
    n_cells = new_run.sum().to(torch.int32)

    cnt_s = segmented.sorted_run_sums(points.new_zeros((n, 0)), new_run, valid_sorted)[:, 0]
    # run-head rows (key, start, count) to the front in cell order
    heads = torch.sort(torch.where(new_run, 0, 1), stable=True).indices
    row = torch.arange(n, device=dev)
    in_cells = row < n_cells
    unique_keys = torch.where(in_cells, sorted_keys[heads], INVALID_KEY)
    cell_starts = torch.where(in_cells, heads, 0).to(torch.int32)
    counts = torch.where(in_cells, cnt_s[heads], 0.0).to(torch.int32)
    return VoxelGrid(origin, dims, cell, sorted_keys, perm, unique_keys, cell_starts,
                     counts, n_cells)
