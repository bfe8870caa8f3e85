"""Patchwork++ ground segmentation (Lee et al., IROS 2022).

Counterpart of ``threecrate_tpu.ops.ground``: the Concentric Zone Model
(4 zones with their own ring and sector counts) puts every point in a
patch; Region-wise Ground Plane Fitting takes each patch's lowest-z
seed points, fits a PCA plane, refits on the points within the distance
threshold, and keeps the patches whose plane is upright, low and flat.

Every patch is a contiguous run of one sorted array: one (patch, z)
ordering (two stable sorts, z then patch), per-run moments from
segmented sums, and each fit's 3x3 eigensolves on the run-head rows
alone (at most one per patch), read back by each point through its
run's index. No per-patch loop exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.point_cloud import PointCloud
from . import linalg, segmented


@dataclasses.dataclass(frozen=True)
class PatchworkConfig:
    """The JAX package's config, field for field."""

    zone_radii: Sequence[float] = (0.0, 2.7, 12.36, 22.03, 80.0)
    rings_per_zone: Sequence[int] = (2, 4, 4, 4)
    sectors_per_zone: Sequence[int] = (16, 32, 54, 32)
    sensor_height: float = 1.723
    seed_fraction: float = 0.2
    min_seed_points: int = 4
    num_iterations: int = 3
    distance_threshold: float = 0.125
    uprightness_threshold: float = 0.707
    elevation_threshold: float = 1.0     # max plane height above -sensor_h
    flatness_threshold: float = 0.05
    min_patch_points: int = 10

    @property
    def n_patches(self) -> int:
        return sum(r * s for r, s in zip(self.rings_per_zone, self.sectors_per_zone))


class GroundSegmentationResult(NamedTuple):
    ground_mask: torch.Tensor      # (N,) bool
    nonground_mask: torch.Tensor   # (N,) bool
    patch_valid: torch.Tensor      # (P,) bool: the patch produced a ground plane
    patch_normals: torch.Tensor    # (P, 3)


def _patch_tables(config: PatchworkConfig):
    """Per-zone lookup tables as numpy arrays: (radii, rings, sectors,
    first patch id of each zone)."""
    radii = np.asarray(config.zone_radii, np.float32)
    rings = np.asarray(config.rings_per_zone, np.int32)
    sectors = np.asarray(config.sectors_per_zone, np.int32)
    base = np.concatenate([[0], np.cumsum(rings * sectors)])[:-1].astype(np.int32)
    return radii, rings, sectors, base


def _patch_ids(points, mask, radii, rings, sectors, base, n_zones: int):
    """Point → CZM patch id (int32); out of range or masked → -1. The
    tables are tensors on the points' device."""
    x, y = points[:, 0], points[:, 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) + math.pi             # [0, 2π]
    zone = (torch.searchsorted(radii, r, right=True) - 1).clamp(0, n_zones - 1)
    z_lo, z_hi = radii[zone], radii[zone + 1]
    nr, ns = rings[zone], sectors[zone]
    ring = torch.minimum(((r - z_lo) / torch.clamp_min(z_hi - z_lo, 1e-6) * nr)
                         .to(torch.int32).clamp_min(0), nr - 1)
    sector = torch.minimum((theta / (2 * math.pi) * ns).to(torch.int32).clamp_min(0),
                           ns - 1)
    pid = base[zone] + ring * ns + sector
    in_range = (r >= radii[0]) & (r < radii[-1]) & mask
    return torch.where(in_range, pid, -1)


def _f32(x) -> float:
    """``x`` rounded to fp32, as the JAX package passes its thresholds."""
    return float(np.float32(x))


def _rgpf(points, pid, n_patches: int, n_iters: int, seed_fraction, min_seeds: int,
          dist_thresh, uprightness, elevation_max, flatness_max, min_patch_points: int,
          sensor_height):
    """Region-wise ground plane fitting over all patches at once:
    ``(ground (N,), patch_valid (P,), patch_normals (P, 3))``."""
    n = points.shape[0]
    dev = points.device
    n_seg = n_patches + 1
    seg = torch.where(pid >= 0, pid, n_patches)     # overflow bucket
    valid = pid >= 0

    # (patch, z) order: a stable sort by z, then a stable sort by patch
    perm = torch.sort(points[:, 2], stable=True).indices
    perm = perm[torch.sort(seg[perm], stable=True).indices]
    order_pid = seg[perm]
    pts_s = points[perm]
    valid_s = order_pid < n_patches
    head = torch.ones_like(valid_s)
    head[1:] = order_pid[1:] != order_pid[:-1]
    new_run = head & valid_s
    pos = torch.arange(n, device=dev)
    start_el = torch.cummax(torch.where(head, pos, -1), 0).values.clamp_min(0)
    rank = pos - start_el
    run_el = torch.cumsum(head, 0) - 1                 # each row's run index

    # per-patch counts without a reduction: a run ends where the next run
    # starts, the last valid run at the first invalid row
    sp = torch.where(head, pos, n)
    sp_next = torch.cat([sp[1:], sp.new_full((1,), n)])
    ns_el = torch.flip(torch.cummin(torch.flip(sp_next, [0]), 0).values, [0])
    ns_el = torch.minimum(ns_el, valid_s.sum())
    cnt_head = torch.where(new_run, ns_el - pos, 0).to(torch.float32)
    cnt_el = cnt_head[start_el]

    # seeds: the lowest-z seed_fraction of each patch (z orders each run)
    seed_n_el = torch.clamp_min((cnt_el * _f32(seed_fraction)).to(torch.int32), min_seeds)
    w_seed = (rank < seed_n_el) & valid_s

    # the run-head rows first, in run order (at most n_seg runs)
    heads = torch.sort(torch.where(head, 0, 1), stable=True).indices[:n_seg]
    head_pt = pts_s[heads]
    c = pts_s - pts_s[start_el]
    mom9 = torch.cat([c, torch.stack([c[:, 0] * c[:, 0], c[:, 1] * c[:, 1],
                                      c[:, 2] * c[:, 2], c[:, 0] * c[:, 1],
                                      c[:, 0] * c[:, 2], c[:, 1] * c[:, 2]], 1)], 1)

    def fit_planes(w_bool):
        """Per run-head row: (normal, plane offset, mean, eigenvalues,
        weight) of the selected points' plane."""
        s = segmented.sorted_run_sums(mom9, new_run, w_bool)[heads]
        wsum = s[:, 9]
        inv_n = 1.0 / torch.clamp_min(wsum, 1.0)
        mu = s[:, :3] * inv_n[:, None]              # head-centred mean
        denom = torch.clamp_min(wsum - 1.0, 1.0)
        cc = (s[:, 3:9] - wsum[:, None] * torch.stack(
            [mu[:, 0] * mu[:, 0], mu[:, 1] * mu[:, 1], mu[:, 2] * mu[:, 2],
             mu[:, 0] * mu[:, 1], mu[:, 0] * mu[:, 2], mu[:, 1] * mu[:, 2]], 1)) \
            / denom[:, None]
        cov = torch.stack([torch.stack([cc[:, 0], cc[:, 3], cc[:, 4]], -1),
                           torch.stack([cc[:, 3], cc[:, 1], cc[:, 5]], -1),
                           torch.stack([cc[:, 4], cc[:, 5], cc[:, 2]], -1)], -2)
        mean = head_pt + mu
        nrm, _ = linalg.smallest_eigenvector_sym3x3(cov)
        nrm = torch.where((nrm[:, 2] < 0)[:, None], -nrm, nrm)  # face up
        dplane = -(nrm * mean).sum(1)
        return nrm, dplane, mean, linalg.eigvals_sym3x3(cov), wsum

    def distance(fit):
        nrm, dp = fit[0][run_el], fit[1][run_el]
        return ((pts_s * nrm).sum(1) + dp).abs()

    # n_iters refits; the selection is fixed on the extra final pass, so
    # the emitted fit is the fit of the selection it was made on
    w_sel = w_seed
    for _ in range(n_iters):
        w_sel = valid_s & (distance(fit_planes(w_sel)) <= _f32(dist_thresh))
    fit = fit_planes(w_sel)
    nrm, _, mean, vals, wsum = fit

    # patch validation (uprightness / elevation / flatness), per run head
    flat = torch.clamp_min(vals[:, 0], 0.0) / torch.clamp_min(vals.sum(1), 1e-12)
    elev = float(np.float32(-np.float32(sensor_height)) + np.float32(elevation_max))
    ok_head = ((cnt_head[heads] >= min_patch_points)
               & (nrm[:, 2].abs() >= _f32(uprightness))
               & (mean[:, 2] <= elev)
               & (flat <= _f32(flatness_max))
               & (wsum >= 3) & valid_s[heads])
    ground_s = ok_head[run_el] & (distance(fit) <= _f32(dist_thresh))
    ground = torch.empty_like(ground_s)
    ground[perm] = ground_s
    ground &= valid

    # per-patch outputs: the head rows scattered into patch-id order (the
    # overflow bucket and rows past the last head land out of range)
    idx = torch.where(head[heads], order_pid[heads], n_seg)
    patch_ok = torch.zeros(n_seg + 1, dtype=torch.bool, device=dev)
    patch_ok[idx] = ok_head
    patch_nrm = torch.zeros((n_seg + 1, 3), dtype=torch.float32, device=dev)
    patch_nrm[idx] = nrm
    return ground, patch_ok[:n_patches], patch_nrm[:n_patches]


def patchwork_plus_plus(cloud: PointCloud, config: PatchworkConfig = PatchworkConfig()
                        ) -> GroundSegmentationResult:
    """Ground / non-ground split of ``cloud`` (on its device)."""
    dev = cloud.device
    radii, rings, sectors, base = (torch.from_numpy(t).to(dev)
                                   for t in _patch_tables(config))
    pid = _patch_ids(cloud.points, cloud.mask, radii, rings, sectors, base,
                     len(config.rings_per_zone))
    ground, patch_ok, patch_nrm = _rgpf(
        cloud.points, pid, config.n_patches, config.num_iterations, config.seed_fraction,
        config.min_seed_points, config.distance_threshold, config.uprightness_threshold,
        config.elevation_threshold, config.flatness_threshold, config.min_patch_points,
        config.sensor_height)
    return GroundSegmentationResult(ground, cloud.mask & ~ground, patch_ok, patch_nrm)


def segment_ground(cloud: PointCloud, config: PatchworkConfig = PatchworkConfig()
                   ) -> Tuple[PointCloud, PointCloud]:
    """(ground, non-ground) cloud pair."""
    res = patchwork_plus_plus(cloud, config)
    return cloud.select(res.ground_mask), cloud.select(res.nonground_mask)
