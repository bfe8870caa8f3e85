"""The small clouds that the union passes' CPU and card tests share."""

import numpy as np
import torch

from threecrate_tpu_torch.ops import morton


def union_cloud(n, tile, k, scale=1.0, seed=0, lattice=False):
    """Morton-sorted (3, N) CPU points and (N,) validity: duplicates, ~10%
    invalid columns, and k - 1 valid points in the last two tiles, so the
    last tile's window holds fewer than k. On a small integer lattice
    every d² is an integer, so the window's k-th often equals a
    halving's mid exactly (r2 / 2, r2 / 4, ...)."""
    rng = np.random.default_rng(seed)
    if lattice:
        x = rng.integers(0, 12, (n, 3)).astype(np.float32)
    else:
        x = (rng.normal(0, 1, (n, 3)) * scale).astype(np.float32)
    x[1::5] = x[0:-1:5]
    pts = torch.from_numpy(x)
    keys = morton.morton_keys(pts, torch.ones(n, dtype=torch.bool), 0)
    sorted_pts = pts[torch.sort(keys, stable=True).indices].T.contiguous()
    valid = (rng.uniform(0, 1, n) > 0.1).astype(np.float32)
    valid[-2 * tile:] = 0.0
    valid[-2 * tile:-2 * tile + k - 1] = 1.0
    return sorted_pts, torch.from_numpy(valid)
