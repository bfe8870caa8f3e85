"""The flat user-facing API: ``import threecrate_tpu_torch as tc``.

Counterpart of ``threecrate_tpu.api``. Mirrors the reference's Python
surface (threecrate-python/src/lib.rs, 15 classes + ~55 functions
registered at :2504-2591, typed in threecrate.pyi): same names, NumPy in
/ NumPy-friendly containers out. Functions accept either a
PointCloud/TriangleMesh or a raw ``(N, 3)`` array, converted on entry
onto ``device`` (the card unless the caller asks for the CPU) like the
PyO3 layer's numpy interop (lib.rs:63-80).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .core.mesh import TriangleMesh
from .core.organized import CameraIntrinsics, OrganizedPointCloud
from .core.point_cloud import PointCloud
from .core.transform import Transform

# -- io ---------------------------------------------------------------------
from .io import (
    read_point_cloud, write_point_cloud, read_mesh, write_mesh,
    read_point_cloud_iter, read_mesh_iter, MeshChunk,
    supported_extensions,
)
from .io.compression import (
    CompressionConfig, compress_point_cloud, decompress_point_cloud,
    compress_draco, decompress_draco,
)
from .io.ros2 import (
    PointField, PointCloud2Data, make_pointcloud2, from_pointcloud2,
    make_pointcloud2_organized, from_pointcloud2_organized,
    pointcloud2_to_xyz, pointcloud2_to_normals, pointcloud2_to_colored,
    pointcloud2_to_colored_normals, xyz_to_pointcloud2,
    normals_to_pointcloud2, colored_to_pointcloud2,
    colored_normals_to_pointcloud2,
)
from .core.typed_clouds import (
    NormalPointCloud, ColoredPointCloud, ColoredNormalPointCloud,
)

# -- ops ----------------------------------------------------------------------
from .ops.filtering import (
    voxel_grid_filter, voxel_grid_filter_detailed,
    statistical_outlier_removal, statistical_outlier_removal_with_threshold,
    radius_outlier_removal, passthrough_filter, range_filter,
)
from .ops.normals import (
    NormalEstimationConfig, estimate_normals, estimate_normals_detailed,
    estimate_normals_with_config,
)
from .ops.neighbors import (
    KnnResult, BruteForceSearch, KdTree, knn, knn_grid, knn_window,
    radius_neighbors, nearest_one,
)
from .ops.registration import (
    ICPConfig, ICPResult, MultiscaleConfig, icp, icp_point_to_point,
    icp_point_to_plane, multiscale_icp_point_to_point,
)
from .ops.gicp import GicpConfig, gicp
from .ops.kiss_icp import KissIcpConfig, KissIcpOdometry, kiss_icp
from .ops.ndt import NdtConfig, NdtResult, ndt_registration
from .ops.features import (
    FPFH_DIM, SHOT_DIM, USC_DIM, FpfhConfig, ShotConfig,
    extract_fpfh_features, extract_fpfh_features_with_normals,
    extract_shot_features, extract_usc_features, match_descriptors,
)
from .ops.global_registration import (
    GlobalRegistrationConfig, GlobalRegistrationResult, global_registration,
    global_registration_with_normals,
)
from .ops.segmentation import (
    ClusterResult, EuclideanClusterConfig, PlaneModel,
    PlaneSegmentationResult, extract_euclidean_clusters, extract_plane,
    segment_plane, segment_plane_parallel,
)
from .ops.ground import (
    GroundSegmentationResult, PatchworkConfig, patchwork_plus_plus,
    segment_ground,
)
from .ops.mesh_boolean import (
    BooleanOp, mesh_boolean, mesh_difference, mesh_intersection, mesh_union,
)
from .ops.mesh_smoothing import (
    HcConfig, LaplacianConfig, TaubinConfig, smooth_hc, smooth_laplacian,
    smooth_taubin,
)
from .ops.colorization import (
    InterpolationMode, RgbImageView, colorize_from_images,
    colorize_point_cloud,
)
from .ops import point_cloud_ops  # attaches PointCloud neighbor methods
from .ops.point_cloud_ops import (
    concatenate, k_nearest_neighbors, nearest_neighbor, neighbors_within)
from .ops.tsdf import (
    TsdfVolume, create_volume as create_tsdf_volume, extract_surface
    as tsdf_extract_surface, integrate as tsdf_integrate,
    integrate_sequence as tsdf_integrate_sequence,
    extract_surface_banded_auto as tsdf_extract_surface_banded,
)
from .ops.tsdf_sparse import (
    SparseTsdfVolume, create_sparse_volume as create_sparse_tsdf_volume,
    sparse_extract_surface as sparse_tsdf_extract_surface,
    sparse_integrate as sparse_tsdf_integrate,
    sparse_marching_cubes_soup as sparse_tsdf_marching_cubes_soup,
    sparse_to_dense as sparse_tsdf_to_dense,
)
from .ops.tsdf_raycast import (
    RaycastResult, raycast as tsdf_raycast,
    shade as tsdf_shade,
    shade_rgb as tsdf_shade_rgb,
    sparse_raycast as sparse_tsdf_raycast,
)
from .ops.frame_to_model import (
    FrameToModelConfig, FrameToModelOdometry, TrackResult,
    track as track_frame_to_model,
)

# -- reconstruction ------------------------------------------------------------
from .reconstruction import (
    PoissonConfig, poisson_reconstruct,
    BallPivotingConfig, ball_pivoting_reconstruction, fill_boundary_holes,
    AlphaShapeConfig, alpha_shape_reconstruction, estimate_optimal_alpha,
    DelaunayConfig, delaunay_reconstruction,
    MlsConfig, mls_reconstruct, mls_smooth,
    VolumetricGrid, marching_cubes, reconstruct_marching_cubes,
    PipelineConfig, auto_reconstruct, auto_reconstruct_detailed,
    analyze_data,
)

# -- simplification -------------------------------------------------------------
from .parallel.streaming import (
    BackpressureConfig, RealtimeMetrics, RealtimePipeline,
    RealtimeVoxelFilter, RunOptions, RunStats, StreamingCollector,
    StreamingStatistics, StreamingVoxelFilter, run_pipeline,
)
from .simplification import (
    ClusteringSimplifier, EdgeCollapseSimplifier, ProgressiveMesh,
    QuadricErrorSimplifier, simplify_mesh,
)

# -- reference-python drop-in surface -----------------------------------------
# (compat.py) — MUST come after the native imports: these names adapt
# the reference module's exact calling conventions (lib.rs:2504-2591)
# on top of the native entry points, dispatching to both styles.
from .compat import (
    IcpResult,
    remove_statistical_outliers, remove_radius_outliers, extract_clusters,
    smooth_mesh_laplacian, smooth_mesh_taubin, smooth_mesh_hc,
    reconstruct, ball_pivoting_reconstruct, alpha_shape_reconstruct,
    delaunay_triangulate, moving_least_squares_reconstruct,
    compress, decompress,
    icp, icp_point_to_plane, gicp, kiss_icp, ndt_registration,
    global_registration, global_registration_with_normals,
    estimate_normals, segment_plane, extract_fpfh_features,
    simplify_mesh, colorize_point_cloud, poisson_reconstruct,
)


def as_point_cloud(x: Union[PointCloud, np.ndarray], **attrs) -> PointCloud:
    """Coerce an (N, 3) array, typed view, or PointCloud to a PointCloud
    (an array lands on ``device``, default the card; ``attrs`` go to
    ``PointCloud.from_numpy``)."""
    from .core.typed_clouds import unwrap
    x = unwrap(x)
    if isinstance(x, PointCloud):
        return x
    return PointCloud.from_numpy(np.asarray(x), **attrs)


def transform_point_cloud(cloud: Union[PointCloud, np.ndarray],
                          matrix, *, device="cuda") -> PointCloud:
    """Apply a 4×4 homogeneous matrix (the PyO3 layer's transform
    utility, lib.rs:63-80)."""
    return as_point_cloud(cloud, device=device).transform(
        Transform.from_matrix(np.asarray(matrix, np.float32)))


def voxel_downsample(cloud: Union[PointCloud, np.ndarray],
                     voxel_size: float, *, device="cuda") -> PointCloud:
    """Open3D-style alias for voxel_grid_filter."""
    return voxel_grid_filter(as_point_cloud(cloud, device=device), voxel_size)


# the flat tc.* surface = every public framework name defined or
# re-exported above (keeps star-import from leaking np/typing imports);
# tools/gen_torch_stub.py derives threecrate_tpu_torch/__init__.pyi from this
__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and n != "point_cloud_ops"
    and (getattr(v, "__module__", "").startswith("threecrate_tpu_torch")
         or isinstance(v, (int, float, str)))
)
