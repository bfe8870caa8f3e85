"""Screened Poisson surface reconstruction on a dense grid.

Counterpart of ``threecrate_tpu.reconstruction.poisson``:

1. splat the oriented normals into a vector field V (trilinear: eight
   scatter-adds over the whole cloud, flat ``index_add_``);
2. b = ∇·V by central differences with replicate boundaries;
3. solve (εI − ∇²) χ = −b by CG (``solver="cg"``) or by the multigrid
   V-cycle of ``multigrid.py`` (``"multigrid"``);
4. iso level = mean of χ sampled trilinearly at the points; the surface
   by marching cubes, faces without splat support trimmed.

Everything up to the mesh runs on the cloud's device without a host
sync; the density trim reads the mesh and its support back, as in JAX.
On the card the scatter-adds land in atomic order, so two calls may give
fields that differ in the last bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from . import multigrid
from .marching_cubes import VolumetricGrid
from .marching_cubes import marching_cubes as _extract_mesh


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Depth up to 8 (256³). ``solver``: "auto" = CG at depth ≤ 6,
    multigrid above; "cg" / "multigrid" force a path. ``density_trim``
    drops output faces whose vertices all have zero splat support (χ is
    unconstrained away from the data, so its level can cross anywhere in
    the far field)."""

    depth: int = 6
    scale: float = 1.1
    cg_iterations: int = 200
    screening: float = 1e-4
    iso_from_points: bool = True
    solver: str = "auto"
    mg_cycles: int = 8
    density_trim: bool = True

    @property
    def resolution(self) -> int:
        return 1 << min(self.depth, 8)


def _shift_clip(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """``a`` shifted by ``d`` along ``axis``, the edge repeated."""
    n = a.shape[axis]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return a.index_select(axis, idx)


def _divergence(vfield: torch.Tensor) -> torch.Tensor:
    """∇·V by central differences with replicate boundaries."""
    def ddx(a, axis):
        return (_shift_clip(a, 1, axis) - _shift_clip(a, -1, axis)) * 0.5
    return ddx(vfield[..., 0], 0) + ddx(vfield[..., 1], 1) + ddx(vfield[..., 2], 2)


def _box3(a: torch.Tensor) -> torch.Tensor:
    """3³ box sum (the density-trim support field: each splat leaks one
    cell outward, so every voxel the surface passes through sees
    support)."""
    for axis in range(3):
        a = _shift_clip(a, -1, axis) + a + _shift_clip(a, 1, axis)
    return a


def _corners(frac: torch.Tensor):
    """The eight trilinear corners: ((dx, dy, dz), weight (N,))."""
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                yield (dx, dy, dz), w


def _voxel(g0: torch.Tensor, d, res: int) -> torch.Tensor:
    """Flat index of each point's corner ``d`` of its cell, clipped."""
    ix, iy, iz = (torch.clamp(g0[:, a] + d[a], 0, res - 1).long() for a in range(3))
    return (ix * res + iy) * res + iz


def _splat(points, normals, mask, origin, spacing, res: int):
    """The right-hand side −∇·V (res³) of the normal field V splatted
    trilinearly, the splat weights (res³), and each point's cell (int32)
    and fraction in it. The splat is a flat ``index_add_``: in point order
    on the CPU (XLA's scatter order), in atomic order on the card."""
    dev = points.device
    g = (points - origin) / spacing
    g0 = torch.floor(g).to(torch.int32)
    frac = g - g0
    m = mask.to(torch.float32)
    # padded rows may carry NaN normals: zero them under the mask
    normals = torch.where(mask[:, None], torch.nan_to_num(normals), 0.0)
    vfield = torch.zeros((res ** 3, 3), dtype=torch.float32, device=dev)
    wfield = torch.zeros((res ** 3,), dtype=torch.float32, device=dev)
    for d, w in _corners(frac):
        w = w * m
        flat = _voxel(g0, d, res)
        vfield.index_add_(0, flat, normals * w[:, None])
        wfield.index_add_(0, flat, w)
    vfield = (vfield / torch.clamp_min(wfield, 1e-6)[:, None]).reshape(res, res, res, 3)
    return -_divergence(vfield), wfield.reshape(res, res, res), g0, frac


def _solve(points, normals, mask, origin, spacing, res: int, iters: int, screening,
           solver: str = "cg", mg_cycles: int = 8):
    """(χ (res³), iso level (0-d), support field (res³)) on the points'
    device: (εI − ∇²) χ = −∇·V by CG or multigrid."""
    rhs, wfield, g0, frac = _splat(points, normals, mask, origin, spacing, res)
    screening = torch.as_tensor(screening, dtype=torch.float32, device=points.device)
    if solver == "multigrid":
        x = multigrid.mg_solve(rhs, screening, cycles=mg_cycles)
    else:
        x = multigrid._cg(lambda p: multigrid._apply_a(p, screening), rhs, iters)

    # iso level from the points (trilinear sample of χ)
    xf = x.reshape(-1)
    acc = torch.zeros(points.shape[0], dtype=torch.float32, device=points.device)
    for d, w in _corners(frac):
        acc = acc + w * xf[_voxel(g0, d, res)]
    iso = torch.where(mask, acc, 0.0).sum() / torch.clamp_min(mask.sum(), 1).to(torch.float32)
    return x, iso, _box3(wfield)


def _sample_support(support: torch.Tensor, origin: torch.Tensor, spacing,
                    verts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the splat-support field at mesh vertices."""
    res = support.shape[0]
    g = (verts - origin[None, :]) / spacing
    g0 = torch.clamp(torch.floor(g).to(torch.int32), 0, res - 2)
    fr = g - g0.to(torch.float32)
    flat = support.reshape(-1)
    dens = torch.zeros(verts.shape[0], dtype=torch.float32, device=verts.device)
    for d, w in _corners(fr):
        ix, iy, iz = (g0[:, a].long() + d[a] for a in range(3))
        dens = dens + w * flat[(ix * res + iy) * res + iz]
    return dens


def poisson_reconstruct(cloud: PointCloud, config: PoissonConfig = PoissonConfig()
                        ) -> TriangleMesh:
    """Poisson surface reconstruction of an oriented cloud (≥ 10 points
    with normals) on the cloud's device."""
    if cloud.normals is None:
        raise InvalidDataError("Poisson reconstruction requires normals")
    n_valid = int(cloud.size())
    if n_valid < 10:
        raise InvalidDataError(f"Poisson needs >= 10 points, got {n_valid}")
    res = config.resolution
    mn, mx = cloud.bounding_box()
    span = (mx - mn).max() * config.scale
    origin = (mn + mx) * 0.5 - span / 2
    spacing = span / (res - 1)

    solver = config.solver
    if solver == "auto":
        solver = "cg" if res <= 64 else "multigrid"
    if solver not in ("cg", "multigrid"):
        raise InvalidDataError(
            f"solver must be 'auto', 'cg' or 'multigrid', got {solver!r}")
    chi, iso, support = _solve(cloud.points, cloud.normals, cloud.mask, origin, spacing, res,
                               config.cg_iterations, config.screening, solver=solver,
                               mg_cycles=config.mg_cycles)
    return _mesh_from_fields(chi, iso, support, origin, spacing, config)


def _mesh_from_fields(chi, iso, support, origin, spacing,
                      config: PoissonConfig) -> TriangleMesh:
    """Extract the level of χ and trim faces without splat support."""
    grid = VolumetricGrid(chi, origin, spacing)
    level = iso if config.iso_from_points else 0.0
    mesh = _extract_mesh(grid, level)
    if not config.density_trim:
        return mesh
    v, f = mesh.to_numpy()
    if len(f) == 0:
        return mesh
    dens = _sample_support(support, origin, spacing,
                           torch.from_numpy(v).to(chi.device)).cpu().numpy()
    # threshold: 5% of the median positive vertex density (the surface
    # sits at O(median), far-field components at exactly 0)
    pos = dens[dens > 0]
    thresh = 0.05 * float(np.median(pos)) if len(pos) else 0.0
    keep = (dens[f] > thresh).any(axis=1)
    if keep.all():
        return mesh
    f2 = f[keep]
    used = np.unique(f2)
    remap = np.full(len(v), -1, np.int64)
    remap[used] = np.arange(len(used))
    return TriangleMesh.from_numpy(v[used], remap[f2].astype(np.int32), device=chi.device)
