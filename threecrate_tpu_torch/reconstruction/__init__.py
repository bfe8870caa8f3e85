"""Surface reconstruction, on the cloud's or the grid's device.

Marching cubes and tetrahedra over dense grids (with the band-compacted
sweep and both welds), screened Poisson on the CG and multigrid solvers
and MLS run fully on the device. Alpha shapes and ball pivoting search
neighbours and test their balls on the device and keep their greedy
passes on the host; Delaunay runs on the host, as in the JAX package
(SURVEY §7.8). ``pipeline`` analyses a cloud, picks one of them and
falls back along a chain when an algorithm fails.
"""

from .alpha_shape import (
    AlphaMode,
    AlphaShapeConfig,
    alpha_shape_reconstruction,
    estimate_optimal_alpha,
)
from .ball_pivoting import (
    BallPivotingConfig,
    ball_pivoting_reconstruction,
    estimate_radii,
    fill_boundary_holes,
)
from .delaunay import DelaunayConfig, ProjectionPlane, delaunay_reconstruction
from .marching_cubes import (
    VolumetricGrid,
    create_cube_volume,
    create_sphere_volume,
    marching_cubes,
    reconstruct_marching_cubes,
)
from .moving_least_squares import (
    MlsConfig,
    PolynomialBasis,
    WeightKernel,
    mls_reconstruct,
    mls_smooth,
)
from .pipeline import (
    Algorithm,
    DataCharacteristics,
    PipelineConfig,
    QualityLevel,
    ReconstructionResult,
    UseCase,
    analyze_data,
    auto_reconstruct,
    auto_reconstruct_detailed,
    select_algorithm,
)
from .poisson import PoissonConfig, poisson_reconstruct

__all__ = [
    "AlphaMode", "AlphaShapeConfig", "alpha_shape_reconstruction",
    "estimate_optimal_alpha",
    "BallPivotingConfig", "ball_pivoting_reconstruction", "estimate_radii",
    "fill_boundary_holes",
    "DelaunayConfig", "ProjectionPlane", "delaunay_reconstruction",
    "VolumetricGrid", "create_cube_volume", "create_sphere_volume",
    "marching_cubes", "reconstruct_marching_cubes",
    "MlsConfig", "PolynomialBasis", "WeightKernel", "mls_reconstruct",
    "mls_smooth",
    "Algorithm", "DataCharacteristics", "PipelineConfig", "QualityLevel",
    "ReconstructionResult", "UseCase", "analyze_data", "auto_reconstruct",
    "auto_reconstruct_detailed", "select_algorithm",
    "PoissonConfig", "poisson_reconstruct",
]
