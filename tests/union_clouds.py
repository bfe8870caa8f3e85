"""The small clouds that the union passes', the fused window normals' and
the FPFH kernels' CPU and card tests share, and the numpy selection
radius they are held to."""

import numpy as np
import torch

from threecrate_tpu_torch.ops import morton
from threecrate_tpu_torch.ops.features import fused_stage1_inputs


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


def window_d2(pts, valid, tile):
    """(N, 3·tile) float32 squared distances of each query of the (3, N)
    sorted numpy points to its prev/self/next window columns, in the
    plain versions' unfused order ((dx² + dy²) + dz²), +inf at invalid
    columns and at those before the first or after the last tile."""
    n = pts.shape[1]
    out = np.empty((n, 3 * tile), np.float32)
    for t in range(n // tile):
        cols = (t - 1) * tile + np.arange(3 * tile)
        inside = (cols >= 0) & (cols < n)
        c = np.where(inside, cols, 0)
        ok = inside & (valid[c] > 0.5)
        q = pts[:, t * tile:(t + 1) * tile]
        d = [pts[r, c][None, :] - q[r][:, None] for r in range(3)]
        out[t * tile:(t + 1) * tile] = np.where(
            ok[None, :], (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2], np.float32(np.inf))
    return out


def band_kth(d2, k, tile, band):
    """Per query: the k-th smallest d² among its ±band sorted neighbours."""
    i = np.arange(d2.shape[0]) % tile
    band_d2 = np.take_along_axis(d2, tile + i[:, None] + np.arange(-band, band + 1), 1)
    return np.sort(band_d2, 1)[:, k - 1]


def radius_from_kth(d2, k, tile, band):
    """Per query: the 6 fp32 halvings of [0, r2] (r2 the ±band k-th)
    against the window's k-th smallest d², clamped to 3.4e38."""
    f32 = np.float32
    dk = np.sort(d2, 1)[:, k - 1]
    lo, hi = np.zeros(d2.shape[0], f32), band_kth(d2, k, tile, band)
    for _ in range(6):
        mid = f32(0.5) * (lo + hi)
        ge = dk <= mid
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    return np.minimum(hi, f32(3.4e38))


def _stage1_rows(n, tile, scale, lattice):
    """Pass-A stage-1 rows (7, N) of a ``union_cloud`` with normal rows
    drawn at random and ~10% of the columns invalid at random, its
    pass-B permutation, and the generator for further draws."""
    pts, _ = union_cloud(n, tile, 10, scale, seed=tile, lattice=lattice)
    rng = np.random.default_rng(tile + 1)
    nrm = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32))
    pa, _, row_a, _ = fused_stage1_inputs(pts.T.contiguous(), torch.ones(n, dtype=torch.bool),
                                          nrm, tile)
    pa[3] = torch.from_numpy((rng.uniform(0, 1, n) > 0.1).astype(np.float32))
    return pa, row_a, rng


def _pass_rows(packed, row_a, pass_b, device):
    """The rows of pass A, or of pass B with its pass-A positions (1, N)."""
    pos = None
    if pass_b:
        packed = packed[:, row_a]
        pos = row_a.to(torch.int32)[None].contiguous().to(device)
    return packed.contiguous().to(device), pos


def weight_inputs(tile, scale, pass_b, lattice=False, device="cpu"):
    """Stage-2 FPFH packed rows (37, N) [x, y, z, valid, spfh (33)] of one
    pass of a ``union_cloud`` (N = max(3·tile, 1024)) as
    ``fused_stage1_inputs`` sorts it, with ~10% of the columns invalid
    at random and uniform SPFH rows in [0, 10), and its pass-A positions
    (1, N) int32 (pass B, else None)."""
    pa, row_a, rng = _stage1_rows(max(3 * tile, 1024), tile, scale, lattice)
    spfh = torch.from_numpy(rng.uniform(0, 10, (33, pa.shape[1])).astype(np.float32))
    return _pass_rows(torch.cat([pa[0:4], spfh]), row_a, pass_b, device)


def spfh_inputs(tile, scale, pass_b, lattice=False, device="cpu", n=None):
    """Stage-1 FPFH packed rows (7, N) [x, y, z, valid, nx, ny, nz] of one
    pass of a ``union_cloud`` (N = max(3·tile, 1024) unless given) as
    ``fused_stage1_inputs`` sorts it: duplicate points, ~10% of the
    columns invalid at random, unit normals; and its pass-A positions
    (1, N) int32 (pass B, else None)."""
    pa, row_a, _ = _stage1_rows(n or max(3 * tile, 1024), tile, scale, lattice)
    pa[4:7] /= pa[4:7].norm(dim=0).clamp_min(1e-12)
    return _pass_rows(pa, row_a, pass_b, device)
