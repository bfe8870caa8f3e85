"""Normal Distributions Transform registration (Biber & Straßer 2003).

Counterpart of ``threecrate_tpu.ops.ndt``: the target's sorted voxel
grid (``ops.voxel_hash``) → per-cell Gaussian with a regularised inverse
covariance, cells below ``min_points_per_voxel`` dropped; Gauss-Newton
on the score ``Σ exp(−½ dᵀΣ⁻¹d)`` with the analytic point Jacobian, the
step clamped to ``step_size``, stopping once ‖δ‖ < ε.

Cell statistics are one segmented sum of head-centred moments; the
point → cell association each iteration is a ``searchsorted`` lookup.
The loop runs on the host: each iteration reads the 6x6 system and its
right-hand side back as ONE small tensor; the damped solve, the clamp,
``se3_exp`` and the composition run on the host in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from ..core.transform import Transform, se3_exp
from . import linalg, segmented, voxel_hash
from .gicp import _normal_equations, inv3x3
from .registration import _pose_to, auto_subsample


@dataclasses.dataclass(frozen=True)
class NdtConfig:
    """The JAX package's config, field for field. ``subsample``: source
    stride of the coarse phase (None = ``registration.auto_subsample``)
    for all but the last ``full_iters`` iterations; cell association is
    per point, so a plain stride needs no tile structure."""

    resolution: float = 1.0
    step_size: float = 0.1
    max_iterations: int = 35
    epsilon: float = 1e-4
    min_points_per_voxel: int = 5
    subsample: Optional[int] = None
    full_iters: int = 2


class NdtResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) on the clouds' device
    score: torch.Tensor           # () Σ exp(−½ dᵀΣ⁻¹d) at full resolution
    iterations: int
    converged: bool

    def as_transform(self) -> Transform:
        return Transform(self.transformation)


class NdtGaussians(NamedTuple):
    grid: voxel_hash.VoxelGrid
    means: torch.Tensor      # (N, 3) per unique-cell row
    inv_covs: torch.Tensor   # (N, 3, 3)
    valid: torch.Tensor      # (N,) the cell holds >= min_points


def build_gaussians(points: torch.Tensor, mask: torch.Tensor, resolution,
                    min_points: int) -> NdtGaussians:
    """Per-cell mean and regularised inverse covariance.

    The moments are raw first and second moments of HEAD-CENTRED
    coordinates (c = p − the run's first point, |c| within a cell
    diagonal), summed per cell in one segmented pass; eigenvalues are
    floored at 0.01·λmax before the inverse."""
    grid = voxel_hash.build_voxel_grid(points, mask, resolution)
    n = points.shape[0]
    sorted_pts = points[grid.perm]
    sorted_valid = grid.sorted_keys != voxel_hash.INVALID_KEY
    new_run = torch.ones_like(sorted_valid)
    new_run[1:] = grid.sorted_keys[1:] != grid.sorted_keys[:-1]
    new_run &= sorted_valid

    iota = torch.arange(n, device=points.device)
    start_el = torch.cummax(torch.where(new_run, iota, -1), 0).values.clamp_min(0)
    head_pt = sorted_pts[start_el]
    c = sorted_pts - head_pt
    mom9 = torch.cat([c, torch.stack([c[:, 0] * c[:, 0], c[:, 1] * c[:, 1],
                                      c[:, 2] * c[:, 2], c[:, 0] * c[:, 1],
                                      c[:, 0] * c[:, 2], c[:, 1] * c[:, 2]], 1)], 1)
    s = segmented.sorted_run_sums(mom9, new_run, sorted_valid)
    order = torch.sort(torch.where(new_run, 0, 1), stable=True).indices
    sc = s[order]                                # (n, 10) cell-indexed
    head_c = head_pt[order]
    cnt = sc[:, 9]
    inv_n = 1.0 / torch.clamp_min(cnt, 1.0)
    mu = sc[:, :3] * inv_n[:, None]              # head-centred mean
    means = head_c + mu
    denom = torch.clamp_min(cnt - 1.0, 1.0)
    cc6 = (sc[:, 3:9] - cnt[:, None] * torch.stack(
        [mu[:, 0] * mu[:, 0], mu[:, 1] * mu[:, 1], mu[:, 2] * mu[:, 2],
         mu[:, 0] * mu[:, 1], mu[:, 0] * mu[:, 2], mu[:, 1] * mu[:, 2]], 1)) / denom[:, None]
    xx, yy, zz, xy, xz, yz = (cc6[:, i] for i in range(6))
    covs = torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)

    # eigenvalue-floor regularisation: λᵢ ← max(λᵢ, 0.01·λmax)
    vals, vecs = linalg.eigh3x3(covs)
    floor = 0.01 * torch.clamp_min(vals[..., 2:3], 1e-9)
    vals_r = torch.maximum(vals, floor)
    covs_r = linalg.fp32_matmul(vecs * vals_r[:, None, :], vecs.transpose(1, 2))
    valid = (cnt >= min_points) & (iota < grid.n_cells)
    return NdtGaussians(grid, means, inv3x3(covs_r), valid)


def _score_terms(gaussians: NdtGaussians, t_mat, pts, pmask):
    """(score (), grad (6,), hess (6, 6)) of the points moved by ``t_mat``:
    grad = Σ s·JᵀBd and the Gauss-Newton Hessian Σ s·JᵀBJ, i.e. GICP's
    expanded normal equations with W = s·B and r = d."""
    grid = gaussians.grid
    moved = linalg.transform_points(t_mat, pts)
    cell, found = grid.lookup(grid.key_of(moved))
    ok = found & pmask & gaussians.valid[cell]
    b = gaussians.inv_covs[cell]
    d = moved - gaussians.means[cell]
    q = (d * (b * d[:, None, :]).sum(2)).sum(1)
    s = torch.exp(-0.5 * q.clamp(0.0, 50.0)) * ok.to(torch.float32)
    hess, grad = _normal_equations(moved, d, b * s[:, None, None])
    return s.sum(), grad, hess


def _ndt_loop(src, src_mask, gaussians: NdtGaussians, init, max_iterations,
              step_size, epsilon, subsample=1, full_iters=2):
    """The Gauss-Newton loop; returns ``(t_mat, score, it, conv)`` with
    ``t_mat`` and ``score`` on the source's device. With ``subsample > 1``
    a coarse phase scores every ``subsample``-th source point for all but
    the last ``full_iters`` iterations, then the full set polishes with
    the step norm reset to +inf; one final score at full resolution."""
    device = src.device
    t_host = torch.as_tensor(init, dtype=torch.float32).cpu()
    step = torch.tensor(step_size, dtype=torch.float32)
    eps = torch.tensor(epsilon, dtype=torch.float32)
    phases = [(src, src_mask, max_iterations)]
    if subsample > 1 and max_iterations > full_iters:
        phases.insert(0, (src[::subsample], src_mask[::subsample],
                          max_iterations - full_iters))
    it = 0
    for pts, pmask, budget in phases:
        dn = torch.tensor(torch.inf)
        while it < budget and bool(dn >= eps):
            _, grad, hess = _score_terms(gaussians, _pose_to(t_host, device), pts, pmask)
            host = torch.cat([hess.reshape(36), grad]).cpu()
            delta = -linalg.solve_psd(host[:36].reshape(6, 6), host[36:], damping=1e-2)
            norm = torch.linalg.vector_norm(delta)
            scale = torch.where(norm > step, step / torch.clamp_min(norm, 1e-12), 1.0)
            delta = delta * scale
            t_host = linalg.fp32_matmul(se3_exp(delta), t_host)
            dn = torch.linalg.vector_norm(delta)
            it += 1
    t_mat = t_host.to(device)
    score, _, _ = _score_terms(gaussians, t_mat, src, src_mask)
    return t_mat, score, it, bool(dn < eps)


def ndt_registration(source: PointCloud, target: PointCloud,
                     config: NdtConfig = NdtConfig(),
                     init: Optional[Transform] = None) -> NdtResult:
    """NDT alignment of ``source`` onto ``target`` (both on one device)."""
    if source.capacity == 0 or target.capacity == 0:
        raise InvalidDataError("NDT requires non-empty clouds")
    if source.device != target.device:
        raise InvalidDataError("source and target must be on one device")
    gaussians = build_gaussians(target.points, target.mask, config.resolution,
                                config.min_points_per_voxel)
    init_m = init.matrix if init is not None else torch.eye(4)
    sub = (config.subsample if config.subsample is not None
           else auto_subsample(source.capacity))
    t, score, it, conv = _ndt_loop(source.points, source.mask, gaussians, init_m,
                                   config.max_iterations, config.step_size, config.epsilon,
                                   subsample=sub, full_iters=config.full_iters)
    return NdtResult(t, score, it, conv)
