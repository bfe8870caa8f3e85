"""Auto-reconstruction pipeline: analyze → select → execute → fallback.

Counterpart of ``threecrate_tpu.reconstruction.pipeline``. The analysis's
k-NN and normals run on the cloud's device; the selection, execution
and quality checks are the JAX module's host logic. The fallback chain
moves on after an algorithm's failure, as JAX's does, but never after a
device failure: a ``DeviceError`` (a kernel that does not build or
launch) or torch's device errors (out of memory, a CUDA error) leave
``auto_reconstruct_detailed`` at once, so a broken kernel never turns
silently into another algorithm.

Covers threecrate-reconstruction/src/pipeline.rs: sampled k-NN data
analysis (density uniformity, noise, distribution type, closure,
complexity — pipeline.rs:229-278), algorithm scoring/selection
(:294-320), execution with a fallback chain and quality validation, and
the ``auto_reconstruct*`` entries (:814-846). Analysis statistics are
device-batched; the selection logic is plain Python like the reference.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.errors import AlgorithmError, DeviceError, InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from ..ops import neighbors
from ..ops.normals import NormalEstimationConfig, estimate_normals_detailed
from . import alpha_shape, ball_pivoting, delaunay
from .marching_cubes import reconstruct_marching_cubes
from . import moving_least_squares as mls
from . import poisson as poisson_mod


class Algorithm(enum.Enum):
    """pipeline.rs:12-92 Algorithm enum."""

    POISSON = "poisson"
    BALL_PIVOTING = "ball_pivoting"
    ALPHA_SHAPE = "alpha_shape"
    DELAUNAY = "delaunay"
    MARCHING_CUBES = "marching_cubes"
    MLS = "mls"


class QualityLevel(enum.Enum):
    FAST = "fast"
    BALANCED = "balanced"
    HIGH = "high"


class UseCase(enum.Enum):
    GENERAL = "general"
    TERRAIN = "terrain"
    ORGANIC = "organic"
    MECHANICAL = "mechanical"


class DataCharacteristics(NamedTuple):
    """pipeline.rs DataCharacteristics (:12-92)."""

    n_points: int
    density_uniformity: float    # 1 = perfectly uniform spacing
    noise_level: float           # mean curvature proxy
    distribution: str            # "planar" | "spherical" | "general"
    is_closed: bool              # normals point away from centroid
    mean_spacing: float


class QualityMetrics(NamedTuple):
    n_vertices: int
    n_faces: int
    watertight_score: float      # fraction of edges shared by 2 faces


class ReconstructionResult(NamedTuple):
    """pipeline.rs:135-160."""

    mesh: TriangleMesh
    algorithm: Algorithm
    fallbacks_used: List[Algorithm]
    characteristics: DataCharacteristics
    quality: QualityMetrics


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """pipeline.rs:95 PipelineConfig."""

    quality: QualityLevel = QualityLevel.BALANCED
    use_case: UseCase = UseCase.GENERAL
    preferred: Optional[Algorithm] = None
    fallback_chain: Sequence[Algorithm] = (
        Algorithm.DELAUNAY, Algorithm.BALL_PIVOTING, Algorithm.MLS)
    analysis_samples: int = 2000
    min_faces: int = 4


def analyze_data(cloud: PointCloud,
                 samples: int = 2000) -> DataCharacteristics:
    """Sampled k-NN statistics (analyze_data, pipeline.rs:229-278)."""
    pts = cloud.to_numpy()
    n = len(pts)
    if n < 4:
        raise InvalidDataError("too few points to analyze")
    sel = np.linspace(0, n - 1, min(samples, n)).astype(np.int64)
    q = torch.from_numpy(pts[sel]).to(cloud.device)
    res = neighbors.knn(cloud.points, cloud.mask, q, None, 8,
                        exclude_self=False)
    d = res.distances.cpu().numpy()[:, 1:]  # drop self
    m = res.mask.cpu().numpy()[:, 1:]
    spacing = d[m & np.isfinite(d)]
    mean_sp = float(spacing.mean()) if spacing.size else 0.0
    uniformity = float(1.0 / (1.0 + spacing.std() / max(mean_sp, 1e-9))) \
        if spacing.size else 0.0

    # distribution type from global PCA eigenvalues
    c = pts - pts.mean(0)
    cov = (c.T @ c) / max(n - 1, 1)
    vals = np.linalg.eigvalsh(cov)
    ratio0 = vals[0] / max(vals[2], 1e-12)
    ratio1 = vals[1] / max(vals[2], 1e-12)
    if ratio0 < 0.01:
        dist = "planar"
    elif ratio0 > 0.4 and ratio1 > 0.4:
        dist = "spherical"
    else:
        dist = "general"

    # noise proxy: local plane-fit residual via curvature
    nres = estimate_normals_detailed(
        cloud, NormalEstimationConfig(k_neighbors=8))
    valid = nres.valid.cpu().numpy()
    curv = nres.curvature.cpu().numpy()[valid]
    noise = float(np.median(curv)) if curv.size else 0.0

    # closure: normals oriented from centroid mostly outward?
    centroid = pts.mean(0)
    nn = nres.normals.cpu().numpy()[valid]
    pp = cloud.points.cpu().numpy()[valid] - centroid
    dots = (nn * pp).sum(1)
    closed = dist == "spherical" and np.abs(np.sign(dots).mean()) > 0.5

    return DataCharacteristics(n, uniformity, noise, dist, bool(closed),
                               mean_sp)


def select_algorithm(ch: DataCharacteristics,
                     config: PipelineConfig) -> Algorithm:
    """Score-table selection (select_algorithm, pipeline.rs:294-320)."""
    if config.preferred is not None:
        return config.preferred
    if config.use_case == UseCase.TERRAIN or ch.distribution == "planar":
        return Algorithm.DELAUNAY
    if ch.is_closed and ch.noise_level < 0.05:
        return Algorithm.POISSON
    if ch.noise_level > 0.05:
        return Algorithm.MLS
    if ch.density_uniformity > 0.6:
        return Algorithm.BALL_PIVOTING
    return Algorithm.ALPHA_SHAPE


def _execute(cloud: PointCloud, algo: Algorithm,
             ch: DataCharacteristics) -> TriangleMesh:
    if algo == Algorithm.POISSON:
        c = cloud
        if c.normals is None:
            nres = estimate_normals_detailed(
                c, NormalEstimationConfig(k_neighbors=10))
            c = c.with_normals(nres.normals)
        return poisson_mod.poisson_reconstruct(c)
    if algo == Algorithm.BALL_PIVOTING:
        return ball_pivoting.ball_pivoting_reconstruction(cloud)
    if algo == Algorithm.ALPHA_SHAPE:
        return alpha_shape.alpha_shape_reconstruction(cloud)
    if algo == Algorithm.DELAUNAY:
        return delaunay.delaunay_reconstruction(
            cloud, delaunay.DelaunayConfig(
                max_edge_length=ch.mean_spacing * 8 if ch.mean_spacing
                else None))
    if algo == Algorithm.MARCHING_CUBES:
        return reconstruct_marching_cubes(cloud)
    if algo == Algorithm.MLS:
        return mls.mls_reconstruct(
            cloud, mls.MlsConfig(search_radius=max(ch.mean_spacing * 4,
                                                   1e-3)))
    raise AlgorithmError(f"unknown algorithm {algo}")


def _quality(mesh: TriangleMesh) -> QualityMetrics:
    v, f = mesh.to_numpy()
    if len(f) == 0:
        return QualityMetrics(len(v), 0, 0.0)
    edges = np.sort(np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    watertight = float((counts == 2).mean())
    return QualityMetrics(len(v), len(f), watertight)


def _device_failure(e: BaseException) -> bool:
    """True for a failure of the device or a kernel, which no other
    algorithm can repair."""
    if isinstance(e, (DeviceError, torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def auto_reconstruct_detailed(cloud: PointCloud,
                              config: PipelineConfig = PipelineConfig()
                              ) -> ReconstructionResult:
    """Full pipeline with fallback chain (pipeline.rs:814-846). A device
    failure is re-raised instead of falling back."""
    ch = analyze_data(cloud, config.analysis_samples)
    primary = select_algorithm(ch, config)
    chain = [primary] + [a for a in config.fallback_chain if a != primary]
    fallbacks: List[Algorithm] = []
    last_err: Optional[Exception] = None
    for algo in chain:
        try:
            mesh = _execute(cloud, algo, ch)
            q = _quality(mesh)
            if q.n_faces >= config.min_faces:
                return ReconstructionResult(mesh, algo, fallbacks, ch, q)
            fallbacks.append(algo)
        except Exception as e:  # noqa: BLE001 — fallback chain semantics
            if _device_failure(e):
                raise
            fallbacks.append(algo)
            last_err = e
    raise AlgorithmError(
        f"all reconstruction algorithms failed (tried {chain}): {last_err}")


def auto_reconstruct(cloud: PointCloud,
                     config: PipelineConfig = PipelineConfig()
                     ) -> TriangleMesh:
    """auto_reconstruct (pipeline.rs:814-818)."""
    return auto_reconstruct_detailed(cloud, config).mesh
