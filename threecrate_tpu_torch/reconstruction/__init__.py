"""Surface reconstruction: the grid algorithms, on the grid's or the
cloud's device. Marching cubes and tetrahedra over dense grids (with
the band-compacted sweep and both welds) and screened Poisson on the
CG and multigrid solvers; the rest of the JAX package's
``reconstruction`` (ball pivoting, alpha shapes, Delaunay, MLS and the
pipeline) is not ported yet."""

from .marching_cubes import (
    VolumetricGrid,
    create_cube_volume,
    create_sphere_volume,
    marching_cubes,
    reconstruct_marching_cubes,
)
from .poisson import PoissonConfig, poisson_reconstruct

__all__ = [
    "VolumetricGrid", "create_cube_volume", "create_sphere_volume",
    "marching_cubes", "reconstruct_marching_cubes",
    "PoissonConfig", "poisson_reconstruct",
]
