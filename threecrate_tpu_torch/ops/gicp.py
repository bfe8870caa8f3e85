"""Generalized-ICP (Segal et al. 2009), plane-to-plane.

Counterpart of ``threecrate_tpu.ops.gicp``: per-point k-NN covariances
(+ε·I), degenerate-cloud rejection, and Gauss-Newton over the combined
covariance metric ``M = C_t + R C_s Rᵀ`` with the Jacobian
``[−skew(Rs + t) | I]``. Two neighbour paths, chosen by size as in the
JAX package:

* below ``GICP_WINDOW_THRESHOLD`` source×target pairs, exact kNN for the
  covariances and brute-force 1-NN for the correspondences;
* above it, the covariances come from the union-window sums of the
  default normals (``normals._union_window_sums``: kernels
  ``union_window_a`` / ``_b``) and the correspondences from the
  static-sort search (``registration._static_corr_setup``: kernel
  ``icp_match``), which carries the target's six covariance columns as
  payload rows and the source's through its one-time sort.

The JAX loop is a ``lax.while_loop``; here it runs on the host. Each
iteration forms the 6x6 system, its right-hand side, the MSE and the
match count on the device and reads them back as ONE small tensor (one
device→host copy per iteration); the damped solve, ``se3_exp`` and the
composition run on the host in fp32, and the loop stops once ‖ξ‖ falls
below the threshold, as the JAX loop does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.errors import AlgorithmError, InvalidDataError
from ..core.point_cloud import PointCloud
from ..core.transform import Transform, se3_exp
from . import linalg, neighbors
from .normals import _cov_from_sums, _union_window_sums
from .registration import (ICPResult, _limits, _pose_to, _static_corr_setup, auto_subsample,
                           auto_w_tiles)

GICP_WINDOW_THRESHOLD = 2 ** 35  # n_src · n_tgt above which method="auto"
# takes the window paths


@dataclasses.dataclass(frozen=True)
class GicpConfig:
    """The JAX package's config, field for field.

    ``method``: "exact" | "window" | "auto" (window above
    ``GICP_WINDOW_THRESHOLD`` pairs), for both the covariances and the
    correspondences. ``w_tiles``: static-sort window width in 128-point
    target tiles (None = ``registration.auto_w_tiles``); raise it (6+)
    for clouds with a large local density contrast. ``subsample``:
    coarse-phase source tile stride of the window path (None =
    ``registration.auto_subsample``) for all but the last
    ``full_iters`` iterations.
    """

    max_iterations: int = 50
    max_correspondence_distance: float = 1.0
    convergence_threshold: float = 1e-6
    k_correspondences: int = 20
    covariance_epsilon: float = 1e-4
    method: str = "auto"
    w_tiles: Optional[int] = None
    subsample: Optional[int] = None
    full_iters: int = 2


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), the determinant
    floored at 1e-30 in magnitude."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def point_covariances(points: torch.Tensor, mask: torch.Tensor, k: int,
                      epsilon: float, window: bool = False):
    """Per-point k-NN covariances + ε·I: ``(cov (N, 3, 3), valid (N,))``,
    valid where the point is and has at least 4 neighbours.

    The window path takes the union-window sums of the default normals
    (the union kernels at ``k``), their covariances and counts, and
    scatters the 6 unique columns and the count back to input order
    through the pass-A permutation."""
    eye = epsilon * torch.eye(3, dtype=torch.float32, device=points.device)
    if window:
        n = points.shape[0]
        s, _, _, perm_a = _union_window_sums(points, mask, k)
        cov_s, cnt = _cov_from_sums(s)
        cols_s = torch.cat([_cov_to_cols(cov_s), cnt[:, None]], 1)
        cols = torch.empty_like(cols_s)
        cols[perm_a] = cols_s
        cols = cols[:n]
        return _cols_to_cov(cols[:, :6]) + eye, mask & (cols[:, 6] >= 4)
    res = neighbors.knn(points, mask, points, mask, k)
    _, cov = linalg.weighted_covariance(points[res.indices], res.mask.to(torch.float32))
    return cov + eye, mask & (res.mask.sum(1) >= 4)


_COV6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _cov_to_cols(cov: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) symmetric → (N, 6) unique columns [xx yy zz xy xz yz]."""
    return torch.stack([cov[:, i, j] for i, j in _COV6], 1)


def _cols_to_cov(cols: torch.Tensor) -> torch.Tensor:
    """(6, N) or (N, 6) unique columns → (N, 3, 3) symmetric."""
    if cols.shape[0] == 6:
        cols = cols.T
    xx, yy, zz, xy, xz, yz = (cols[:, i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], -1),
        torch.stack([xy, yy, yz], -1),
        torch.stack([xz, yz, zz], -1)], -2)


def _normal_equations(moved: torch.Tensor, r: torch.Tensor, w_mat: torch.Tensor):
    """Gauss-Newton system ``(Σ JᵀWJ (6, 6), Σ JᵀWr (6,))`` for
    J = [−skew(m) | I], expanded symbolically: with S = skew(m) the blocks
    are [[−SWS, SW], [(SW)ᵀ, W]], so every entry is a sum of elementwise
    products of W's 6 unique entries with m and r (no (N, 3, 6)
    intermediates). The 27 sums reduce in one pass."""
    a, b, c = moved[:, 0], moved[:, 1], moved[:, 2]
    w0, w1, w2 = w_mat[:, 0, 0], w_mat[:, 1, 1], w_mat[:, 2, 2]
    w3, w4, w5 = w_mat[:, 0, 1], w_mat[:, 0, 2], w_mat[:, 1, 2]
    r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]

    # B = S W  (rows of skew(m) times W)
    b00 = -c * w3 + b * w4
    b01 = -c * w1 + b * w5
    b02 = -c * w5 + b * w2
    b10 = c * w0 - a * w4
    b11 = c * w3 - a * w5
    b12 = c * w4 - a * w2
    b20 = -b * w0 + a * w3
    b21 = -b * w3 + a * w1
    b22 = -b * w4 + a * w5

    # A = −B S with S columns (0,c,−b), (−c,0,a), (b,−a,0); symmetric
    a00 = -(b01 * c - b02 * b)
    a01 = -(-b00 * c + b02 * a)
    a02 = -(b00 * b - b01 * a)
    a11 = -(-b10 * c + b12 * a)
    a12 = -(b10 * b - b11 * a)
    a22 = -(b20 * b - b21 * a)

    # g = [B r, W r]
    wr0 = w0 * r0 + w3 * r1 + w4 * r2
    wr1 = w3 * r0 + w1 * r1 + w5 * r2
    wr2 = w4 * r0 + w5 * r1 + w2 * r2
    gt0 = b00 * r0 + b01 * r1 + b02 * r2
    gt1 = b10 * r0 + b11 * r1 + b12 * r2
    gt2 = b20 * r0 + b21 * r1 + b22 * r2

    (sa00, sa01, sa02, sa11, sa12, sa22, sb00, sb01, sb02, sb10, sb11, sb12, sb20, sb21,
     sb22, sw0, sw1, sw2, sw3, sw4, sw5, g0, g1, g2, g3, g4, g5) = torch.stack(
        [a00, a01, a02, a11, a12, a22, b00, b01, b02, b10, b11, b12, b20, b21, b22,
         w0, w1, w2, w3, w4, w5, gt0, gt1, gt2, wr0, wr1, wr2], 1).sum(0)
    h = torch.stack([
        torch.stack([sa00, sa01, sa02, sb00, sb01, sb02]),
        torch.stack([sa01, sa11, sa12, sb10, sb11, sb12]),
        torch.stack([sa02, sa12, sa22, sb20, sb21, sb22]),
        torch.stack([sb00, sb10, sb20, sw0, sw3, sw4]),
        torch.stack([sb01, sb11, sb21, sw3, sw1, sw5]),
        torch.stack([sb02, sb12, sb22, sw4, sw5, sw2])])
    return h, torch.stack([g0, g1, g2, g3, g4, g5])


def _rotate_cov(r_mat: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """R C Rᵀ for each (3, 3) C, in full fp32 (the JAX package's einsum
    at ``Precision.HIGHEST``; TF32 off whatever the caller set)."""
    return linalg.fp32_matmul(linalg.fp32_matmul(r_mat, cov), r_mat.T)


def _gicp_loop(src, src_mask, src_cov, tgt, tgt_mask, tgt_cov, init, max_iterations,
               conv_thresh, max_corr, window=False, w_tiles=3, subsample=1,
               full_iters=2):
    """The Gauss-Newton loop. Returns ``(t_mat, mse, it, conv, n_corr)``
    with ``t_mat`` (4, 4) and ``mse`` () on the clouds' device. With
    ``window`` and ``subsample > 1`` a coarse phase matches every
    ``subsample``-th source tile for all but the last ``full_iters``
    iterations; the full set then polishes, the step norm reset to +inf."""
    device = src.device
    t_host = torch.as_tensor(init, dtype=torch.float32).cpu()
    max_corr, max_d2 = _limits(max_corr)
    thresh = torch.tensor(conv_thresh, dtype=torch.float32)
    if window:
        # the sorts run once per setup; each iteration's match carries the
        # matched target's 6 covariance columns as payload rows, and the
        # source covariance columns ride the one-time source sort
        init_dev = t_host.to(device)
        tgt6, src6 = _cov_to_cols(tgt_cov), _cov_to_cols(src_cov)
        full, src6_s = _static_corr_setup(src, src_mask, tgt, tgt_mask, init_dev, max_d2,
                                          w_tiles, tgt_extra=tgt6, src_extra=src6)
        phases = [(full, _cols_to_cov(src6_s))]
        if subsample > 1 and max_iterations > full_iters:
            coarse, src6_c = _static_corr_setup(src, src_mask, tgt, tgt_mask, init_dev,
                                                max_d2, w_tiles, tgt_extra=tgt6,
                                                src_extra=src6, tile_stride=subsample)
            phases.insert(0, (coarse, _cols_to_cov(src6_c)))
    else:
        phases = [(None, src_cov)]

    def step(t_mat, match_fn, cov_s):
        """One iteration on the device; h, g, mse and the count come back
        in one device→host copy."""
        t_dev = _pose_to(t_mat, device)
        r_mat = t_dev[:3, :3]
        if window:
            moved, matched, ok, _, extra = match_fn(t_dev)
            m = _cols_to_cov(extra) + _rotate_cov(r_mat, cov_s)
        else:
            moved = linalg.transform_points(t_dev, src)
            res = neighbors.knn(tgt, tgt_mask, moved, src_mask, 1)
            idx = res.indices[:, 0]
            ok = res.mask[:, 0] & src_mask & (res.distances[:, 0] <= max_corr)
            matched = tgt[idx]
            m = tgt_cov[idx] + _rotate_cov(r_mat, src_cov)
        w = ok.to(torch.float32)
        w_mat = inv3x3(m) * w[:, None, None]
        r = moved - matched
        h, g = _normal_equations(moved, r, w_mat)
        n_ok = w.sum()
        mse = torch.where(ok, (r * r).sum(1), 0.0).sum() / torch.clamp_min(n_ok, 1.0)
        host = torch.cat([h.reshape(36), g, mse[None], n_ok[None]]).cpu()
        xi = -linalg.solve_psd(host[:36].reshape(6, 6), host[36:42], damping=1e-6)
        return xi, host[42], int(host[43])

    it = 0
    for p, (match_fn, cov_s) in enumerate(phases):
        budget = max_iterations - full_iters if p < len(phases) - 1 else max_iterations
        norm = torch.tensor(torch.inf)
        mse, n_corr = torch.tensor(torch.inf), 0
        while it < budget and bool(norm >= thresh):
            xi, mse, n_corr = step(t_host, match_fn, cov_s)
            t_host = linalg.fp32_matmul(se3_exp(xi), t_host)
            norm = torch.linalg.vector_norm(xi)
            it += 1
    return t_host.to(device), mse.to(device), it, bool(norm < thresh), n_corr


def gicp(source: PointCloud, target: PointCloud, config: GicpConfig = GicpConfig(),
         init: Optional[Transform] = None) -> ICPResult:
    """Align ``source`` onto ``target`` (both on one device)."""
    if source.capacity == 0 or target.capacity == 0:
        raise InvalidDataError("GICP requires non-empty clouds")
    if source.device != target.device:
        raise InvalidDataError("source and target must be on one device")
    window = (config.method == "window"
              or (config.method == "auto"
                  and source.capacity * target.capacity > GICP_WINDOW_THRESHOLD))
    eps = float(torch.tensor(config.covariance_epsilon, dtype=torch.float32))
    k = config.k_correspondences
    src_cov, src_ok = point_covariances(source.points, source.mask, k, eps, window)
    tgt_cov, tgt_ok = point_covariances(target.points, target.mask, k, eps, window)

    # a cloud whose total covariance is rank-deficient in 2 directions (a
    # line or a point) cannot constrain 6 degrees of freedom
    for cloud, name in ((source, "source"), (target, "target")):
        _, cov = linalg.weighted_covariance(cloud.points[None],
                                            cloud.mask[None].to(torch.float32))
        vals = linalg.eigvals_sym3x3(cov)[0].cpu()
        if float(vals[1]) < 1e-5 * max(float(vals[2]), 1e-12):
            raise AlgorithmError(f"GICP: {name} cloud is degenerate "
                                 "(collinear/coincident points)")

    init_m = init.matrix if init is not None else torch.eye(4)
    w = (config.w_tiles if config.w_tiles is not None
         else auto_w_tiles(source.capacity, target.capacity))
    sub = (config.subsample if config.subsample is not None
           else (auto_subsample(source.capacity) if window else 1))
    t, mse, it, conv, n_corr = _gicp_loop(
        source.points, src_ok, src_cov, target.points, tgt_ok, tgt_cov, init_m,
        config.max_iterations, config.convergence_threshold,
        config.max_correspondence_distance, window, w, subsample=sub,
        full_iters=config.full_iters)
    return ICPResult(t, mse, it, conv, n_corr)
