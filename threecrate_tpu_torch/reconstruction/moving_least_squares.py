"""Moving Least Squares surface smoothing / reconstruction.

Counterpart of ``threecrate_tpu.reconstruction.moving_least_squares``,
on the cloud's device: one radius search (``ops.neighbors``), then every
point's weighted normal equations in the dimensionless local basis, with
the trace-relative Tikhonov term, solved as a batch of ≤6×6 Cholesky
factorisations (``torch.linalg.cholesky_ex``, no host sync). Every
product runs in full fp32 (``ops.linalg.fp32_matmul``; the JAX package
asks for ``Precision.HIGHEST``), never TF32. The implicit-surface path
evaluates the signed distance along the nearest point's fitted normal at
grid nodes and feeds ``reconstruction.marching_cubes``.

Covers threecrate-reconstruction/src/moving_least_squares.rs: local
weighted polynomial fits with selectable weight kernels and basis
orders (moving_least_squares.rs:13-74), point projection, and
grid-sampled implicit surface → isosurface extraction.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from ..ops import linalg, neighbors
from .marching_cubes import VolumetricGrid, _index_grid
from .marching_cubes import marching_cubes as _extract_mesh


class WeightKernel(enum.Enum):
    """moving_least_squares.rs weight kernels (4)."""

    GAUSSIAN = "gaussian"
    WENDLAND = "wendland"
    CUBIC = "cubic"
    CONSTANT = "constant"


class PolynomialBasis(enum.Enum):
    """Basis order for the local height fit (const → cubic ≈ quadric)."""

    CONSTANT = 0
    LINEAR = 1
    QUADRATIC = 2


@dataclasses.dataclass(frozen=True)
class MlsConfig:
    """Mirrors MLSConfig (moving_least_squares.rs:39)."""

    search_radius: float = 0.1
    max_neighbors: int = 32
    kernel: WeightKernel = WeightKernel.GAUSSIAN
    basis: PolynomialBasis = PolynomialBasis.QUADRATIC
    regularization: float = 1e-6
    compute_normals: bool = True


def _weights(dist, radius: float, kernel: WeightKernel):
    t = torch.clamp(dist / max(radius, 1e-12), 0.0, 1.0)
    if kernel == WeightKernel.GAUSSIAN:
        return torch.exp(-(dist / max(radius / 2, 1e-12)) ** 2)
    if kernel == WeightKernel.WENDLAND:
        return (1 - t) ** 4 * (4 * t + 1)
    if kernel == WeightKernel.CUBIC:
        return 1 - 3 * t * t + 2 * t * t * t
    return torch.ones_like(dist)


def _basis_terms(u, v, order: int):
    terms = [torch.ones_like(u)]
    if order >= 1:
        terms += [u, v]
    if order >= 2:
        terms += [u * u, u * v, v * v]
    return torch.stack(terms, dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_j a[..., j]·b[..., j] over the last axis of length 3."""
    return (a * b).sum(-1)


def _mls_project(points, mask, radius: float, max_neighbors: int, kernel, order: int,
                 reg: float):
    """Project every point onto its local MLS surface; returns
    (projected points, fitted normals, valid)."""
    res = neighbors.radius_neighbors(points, mask, points, mask, radius, max_neighbors)
    nbr = points[res.indices]                      # (N, k, 3)
    return _mls_project_rows(nbr, res.mask, res.distances, points, mask, radius, kernel,
                             order, reg)


def _mls_project_rows(nbr, nbr_ok, nbr_dist, points, mask, radius: float, kernel,
                      order: int, reg: float):
    """MLS projection core over pre-gathered neighborhoods (N, k, ·)."""
    w = torch.where(nbr_ok, _weights(nbr_dist, radius, kernel), 0.0)

    # local frame from the weighted covariance (plane fit)
    mean, cov = linalg.weighted_covariance(nbr, w)
    normal, _ = linalg.smallest_eigenvector_sym3x3(cov)
    # tangent basis
    eye = torch.eye(3, device=points.device)
    helper = torch.where(normal[:, 2:3].abs() < 0.9, eye[2], eye[0])
    t1 = torch.linalg.cross(normal, helper, dim=-1)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-12)
    t2 = torch.linalg.cross(normal, t1, dim=-1)

    d = nbr - mean[:, None, :]
    # DIMENSIONLESS local coordinates: the raw basis [1,u,v,u²,uv,v²]
    # spans (radius²)² dynamic range, which at mm scale collapses an f32
    # Cholesky. Dividing by the radius makes the normal matrix scale-free;
    # the fitted height rescales back and the first derivatives are
    # unchanged.
    inv_r = float(np.float32(1.0) / np.float32(max(radius, 1e-30)))
    u = _dot3(d, t1[:, None, :]) * inv_r
    v = _dot3(d, t2[:, None, :]) * inv_r
    h = _dot3(d, normal[:, None, :]) * inv_r

    b = _basis_terms(u, v, order)                  # (N, k, m)
    bw = b * w[..., None]
    ata = linalg.fp32_matmul(bw.transpose(1, 2), b)
    m_dim = b.shape[-1]
    # SCALE-RELATIVE Tikhonov: ata entries scale like radius², so an
    # absolute reg would dominate (and flatten the fit) on mm-scale
    # neighborhoods; scaling by the mean diagonal keeps the conditioning
    # effect the same at every scene scale.
    tr = ata.diagonal(dim1=-2, dim2=-1).sum(-1) / m_dim
    reg_eff = reg * torch.clamp_min(tr, 1e-30)
    ata = ata + reg_eff[:, None, None] * torch.eye(m_dim, dtype=ata.dtype,
                                                   device=ata.device)
    atb = linalg.fp32_matmul(bw.transpose(1, 2), h[..., None])
    chol, _ = torch.linalg.cholesky_ex(ata)
    coef = torch.cholesky_solve(atb, chol)[..., 0]

    # the query point in dimensionless local coords; evaluate the fit
    # there and move along the normal (heights rescale by radius)
    dp = points - mean
    u0 = _dot3(dp, t1) * inv_r
    v0 = _dot3(dp, t2) * inv_r
    b0 = _basis_terms(u0, v0, order)
    h_fit = (b0 * coef).sum(-1) * radius
    projected = mean + (u0 * radius)[:, None] * t1 \
        + (v0 * radius)[:, None] * t2 + h_fit[:, None] * normal

    # analytic fitted normal: n ∝ (-∂h/∂u, -∂h/∂v, 1) in local frame
    if order >= 1:
        dhu = coef[:, 1]
        dhv = coef[:, 2]
        if order >= 2:
            dhu = dhu + 2 * coef[:, 3] * u0 + coef[:, 4] * v0
            dhv = dhv + coef[:, 4] * u0 + 2 * coef[:, 5] * v0
        n_fit = normal - dhu[:, None] * t1 - dhv[:, None] * t2
    else:
        n_fit = normal
    n_fit = n_fit / torch.clamp_min(torch.linalg.vector_norm(n_fit, dim=-1, keepdim=True),
                                    1e-12)

    valid = mask & (nbr_ok.sum(1) >= 3)
    projected = torch.where(valid[:, None], projected, points)
    return projected, torch.where(valid[:, None], n_fit, 0.0), valid


def mls_smooth(cloud: PointCloud, config: MlsConfig = MlsConfig()) -> PointCloud:
    """Project points onto their local MLS surface (denoising) —
    the point-projection half of the reference MLS."""
    proj, nrm, valid = _mls_project(
        cloud.points, cloud.mask, float(np.float32(config.search_radius)),
        config.max_neighbors, config.kernel, config.basis.value,
        float(np.float32(config.regularization)))
    out = cloud.with_points(proj)
    if config.compute_normals:
        out = out.with_normals(nrm)
    return out


def mls_reconstruct(cloud: PointCloud, config: MlsConfig = MlsConfig(),
                    grid_resolution: int = 48) -> TriangleMesh:
    """Implicit MLS surface sampled on a dense grid → isosurface
    (the reference's grid-sampled MLS → MC pipeline)."""
    smoothed = mls_smooth(cloud, config)
    if smoothed.normals is None:
        raise InvalidDataError("MLS reconstruction requires normals")
    grid = _signed_field(smoothed, grid_resolution)
    return _extract_mesh(grid, 0.0)


def _signed_field(cloud: PointCloud, resolution: int) -> VolumetricGrid:
    """Signed distance to the locally fitted surface: for each grid node,
    distance along the nearest point's MLS normal (exact 1-NN, 16,384
    nodes a chunk)."""
    mn, mx = cloud.bounding_box()
    ext = mx - mn
    pad = ext.max() * 0.1
    origin = mn - pad
    span = ext.max() + 2 * pad
    spacing = span / (resolution - 1)
    r = resolution
    nodes = origin + _index_grid((r, r, r), cloud.device) * spacing
    flat = nodes.reshape(-1, 3)
    res = neighbors.knn(cloud.points, cloud.mask, flat, None, 1, query_chunk=16384)
    nearest = cloud.points[res.indices[:, 0]]
    nrm = cloud.normals[res.indices[:, 0]]
    sd = ((flat - nearest) * nrm).sum(-1)
    return VolumetricGrid(sd.reshape(r, r, r), origin, spacing)
