"""FPFH + RANSAC global registration.

Counterpart of ``threecrate_tpu.ops.global_registration``: normals →
FPFH on both clouds → descriptor matching → RANSAC over 3-point samples
→ optional point-to-point ICP refinement. Hypotheses run in batches:
each batch samples its triples at once, fits them as one batched Kabsch
and scores every hypothesis against every correspondence with one
batched matmul; the batch loop stops once the best inlier count reaches
the inlier-ratio target.

Sampling draws from one ``torch.Generator`` seeded with
``config.seed`` on the inputs' device. It gives other numbers than the
JAX package's PRNG from the same seed, so the two packages' poses agree
to the accuracy of the registration, not bit for bit; fed the same
sample indices, ``score_hypotheses`` picks the same hypothesis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud
from ..core.transform import Transform
from ..utils import profiling
from . import features, linalg, registration
from .normals import NormalEstimationConfig, estimate_normals_detailed


@dataclasses.dataclass(frozen=True)
class GlobalRegistrationConfig:
    """The JAX package's config, field for field. ``max_query_descriptors``
    strides the source descriptors down before matching (0 = all);
    ``fpfh_band`` None keeps the exact full-window FPFH."""

    ransac_iterations: int = 50_000
    distance_threshold: float = 0.05
    inlier_ratio: float = 0.25
    fpfh_radius: float = 0.25
    max_correspondences: int = 2048
    max_query_descriptors: int = 16384
    fpfh_band: Optional[int] = None
    refine_with_icp: bool = True
    icp_max_iterations: int = 30
    k_normals: int = 10
    hypothesis_batch: int = 4096
    mutual_check: bool = True
    seed: int = 0


class GlobalRegistrationResult(NamedTuple):
    transformation: torch.Tensor   # (4, 4) src → tgt
    inlier_count: torch.Tensor     # () int32
    inlier_ratio: torch.Tensor     # () float32
    converged: torch.Tensor        # () bool
    mse: torch.Tensor              # () ICP MSE, inf without refinement

    def as_transform(self) -> Transform:
        return Transform(self.transformation)


def sample_hypotheses(generator: torch.Generator, corr_ok: torch.Tensor,
                      n_hyp: int) -> torch.Tensor:
    """(n_hyp, 3) correspondence indices drawn with replacement, with
    probability proportional to ``corr_ok``."""
    probs = corr_ok.to(torch.float32)
    probs = probs / torch.clamp_min(probs.sum(), 1.0)
    return torch.multinomial(probs, n_hyp * 3, replacement=True,
                             generator=generator).reshape(n_hyp, 3)


def score_hypotheses(idx: torch.Tensor, src_pts: torch.Tensor,
                     tgt_pts: torch.Tensor, corr_ok: torch.Tensor,
                     dist_thresh: float):
    """Fit one rigid transform per sampled triple ``idx`` (H, 3) and
    count its inliers among the (M, 3) correspondences: a pair is an
    inlier when valid and ‖R s + t − t'‖² <= τ² in fp32. Returns (best
    (4, 4), its count as a () tensor), the first best on ties."""
    fit = linalg.kabsch_batched(src_pts[idx], tgt_pts[idx],
                                torch.ones(idx.shape, device=idx.device))
    moved = linalg.fp32_matmul(src_pts, fit[:, :3, :3].transpose(1, 2)) \
        + fit[:, None, :3, 3]                                 # (H, M, 3)
    d2 = ((moved - tgt_pts[None]) ** 2).sum(-1)
    thresh = torch.tensor(dist_thresh, dtype=torch.float32)
    inlier = (d2 <= (thresh * thresh).item()) & corr_ok[None, :]
    counts = inlier.sum(1)
    best = torch.argmax(counts)
    with profiling.host_sync("ransac.best", best, 2):     # a 0-d index is read back
        return fit[best], counts[best]


def global_registration_with_features(
        source: PointCloud, target: PointCloud, src_desc, src_valid,
        tgt_desc, tgt_valid,
        config: GlobalRegistrationConfig) -> GlobalRegistrationResult:
    """RANSAC core given precomputed descriptors."""
    n_src = src_desc.shape[0]
    mq = config.max_query_descriptors
    src_points = source.points
    if mq and n_src > mq:
        stride = -(-n_src // mq)
        src_desc, src_valid = src_desc[::stride], src_valid[::stride]
        src_points = src_points[::stride]
    j, dist, ok = features.match_descriptors(src_desc, src_valid, tgt_desc,
                                             tgt_valid, mutual=config.mutual_check)

    with profiling.span("ransac"):
        # the correspondence budget: the best-matched pairs, stable order
        order = torch.argsort(torch.where(ok, dist, torch.inf), stable=True)
        order = order[:config.max_correspondences]
        src_pts = src_points[order]
        tgt_pts = target.points[j[order]]
        corr_ok = ok[order]

        with profiling.host_sync("ransac.valid", corr_ok):
            n_valid = int(corr_ok.sum())
        if n_valid < 3:
            raise InvalidDataError(
                "global registration: fewer than 3 feature correspondences")

        gen = torch.Generator(device=src_pts.device)
        gen.manual_seed(config.seed)
        batch = min(config.hypothesis_batch, config.ransac_iterations)
        n_batches = max(1, config.ransac_iterations // batch)
        best_t = torch.eye(4, device=src_pts.device)
        best_count = -1
        target_count = config.inlier_ratio * max(n_valid, 1)
        for _ in range(n_batches):
            idx = sample_hypotheses(gen, corr_ok, batch)
            t, count = score_hypotheses(idx, src_pts, tgt_pts, corr_ok,
                                        config.distance_threshold)
            profiling.count("ransac.hypotheses", batch)
            with profiling.host_sync("ransac.count", count):
                count = int(count)
            if count > best_count:
                best_count, best_t = count, t
            if best_count >= target_count:   # batch-level early exit
                break

    result_t = best_t
    with profiling.host_sync("ransac.mse", src_pts.device):
        mse = torch.tensor(torch.inf, device=src_pts.device)
    if config.refine_with_icp:
        icp_res = registration.icp_point_to_point(
            source, target, config.icp_max_iterations,
            max_correspondence_distance=config.distance_threshold * 2.0,
            init=Transform(best_t))
        result_t, mse = icp_res.transformation, icp_res.mse

    return GlobalRegistrationResult(
        result_t, torch.tensor(best_count, dtype=torch.int32),
        torch.tensor(best_count / max(n_valid, 1), dtype=torch.float32),
        torch.tensor(best_count >= 3), mse)


def global_registration_with_normals(
        source: PointCloud, target: PointCloud,
        config: GlobalRegistrationConfig = GlobalRegistrationConfig()
        ) -> GlobalRegistrationResult:
    """FPFH on both clouds (which carry normals), then RANSAC."""
    fcfg = features.FpfhConfig(radius=config.fpfh_radius, band=config.fpfh_band)
    sf = features.extract_fpfh_features_with_normals(source, fcfg)
    tf = features.extract_fpfh_features_with_normals(target, fcfg)
    return global_registration_with_features(
        source, target, sf.descriptors, sf.valid, tf.descriptors, tf.valid, config)


def global_registration(source: PointCloud, target: PointCloud,
                        config: GlobalRegistrationConfig = GlobalRegistrationConfig()
                        ) -> GlobalRegistrationResult:
    """The full pipeline: normals on each cloud that has none, then FPFH
    + RANSAC (+ optional ICP refinement)."""
    ncfg = NormalEstimationConfig(k_neighbors=config.k_normals)
    if source.normals is None:
        source = source.with_normals(estimate_normals_detailed(source, ncfg).normals)
    if target.normals is None:
        target = target.with_normals(estimate_normals_detailed(target, ncfg).normals)
    return global_registration_with_normals(source, target, config)
