"""threecrate-tpu's PyTorch/CUDA port.

The same point-cloud library as ``threecrate_tpu`` (the JAX reference,
which stays beside it), in eager PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (``csrc/``). Nine slices are ported:
``PerceptionStep`` (union-window normals and static-sort point-to-point
ICP), ``RegistrationModel`` (fused-window FPFH, descriptor matching,
batched RANSAC, then ICP), the Morton-window neighbourhood ops (FPFH
at its default band rungs, the window kNN family, ``method="window"``
normals, the staged window FPFH and statistical outlier removal), the
SHOT/USC descriptors (the fused band path and the staged path), and
``method="window_fast"`` normals with the voxel grid, the crops and
point-to-plane, batched and multiscale ICP; then the registration
family beyond point-to-point ICP: GICP (the union kernels at k = 20 and
``icp_match`` with six payload rows), NDT on the sorted voxel hash,
Patchwork++ ground segmentation, and KISS-ICP with ``OdometryModel``;
then the depth-camera mapping slice: dense and block-sparse TSDF
fusion, TSDF raycasting and frame-to-model tracking with
``FrameToModelOdometry`` (no kernel of its own); then surface
reconstruction: ``TriangleMesh``, marching cubes (dense, banded and
over the sparse TSDF) with both welds, and screened Poisson on the CG
and multigrid solvers (no kernel of its own); then mesh processing
(``ReconstructionModel``, MLS, alpha shapes, ball pivoting, Delaunay,
the simplifiers, smoothing and booleans); then the file-to-segments
slice: the I/O registry (PLY, PCD, OBJ, STL, XYZ/CSV and the LiDAR
formats, parsed on the host with the C++ helpers of ``native``), plane
RANSAC, Euclidean clustering, ``knn_grid`` and the point-cloud ops;
then the survey-tile slice: LAS/LAZ (the LASzip codec of ``native``),
E57, rosbag2 and MCAP with the ROS 2 converters, GLB, ``.tcz`` and
``.npz`` artifacts, the out-of-core streaming pipelines of ``parallel``
(the voxel accumulator on the card) and colorization from images;
with the data model, Morton keys, small linear algebra and exact
neighbour search they need. Clouds built with ``PointCloud.from_numpy``
live on the card unless the caller asks for the CPU. Modules mirror the
JAX package's layout and public names.
"""

__version__ = "0.1.0"

from . import (core, interop, io, kernels, models, native, ops, parallel,
               reconstruction, simplification, utils)
from .core import (
    AlgorithmError,
    CameraIntrinsics,
    DeviceError,
    InvalidDataError,
    IoError,
    OrganizedPointCloud,
    PointCloud,
    ThreeCrateError,
    Transform,
    TriangleMesh,
    UnsupportedError,
    UnsupportedFormatError,
    VisualizationError,
)
from .core.typed_clouds import ColoredNormalPointCloud, ColoredPointCloud, NormalPointCloud
from .models import (OdometryModel, PerceptionResult, PerceptionStep, ReconstructionModel,
                     RegistrationModel)
from .ops.features import (FPFH_DIM, SHOT_DIM, USC_DIM, FpfhConfig, FpfhResult, ShotConfig,
                           ShotResult, extract_fpfh_features,
                           extract_fpfh_features_with_normals, extract_shot_features,
                           extract_usc_features, match_descriptors)
from .ops.filtering import (OutlierResult, VoxelGridResult, passthrough_filter,
                            radius_outlier_removal, range_filter,
                            statistical_outlier_removal,
                            statistical_outlier_removal_with_threshold,
                            voxel_grid_filter, voxel_grid_filter_detailed)
from .ops.gicp import GicpConfig, gicp
from .ops.global_registration import (GlobalRegistrationConfig,
                                      GlobalRegistrationResult, global_registration,
                                      global_registration_with_normals)
from .ops.frame_to_model import FrameToModelConfig, FrameToModelOdometry, TrackResult
from .ops.frame_to_model import track as track_frame_to_model
from .ops.ground import (GroundSegmentationResult, PatchworkConfig,
                         patchwork_plus_plus, segment_ground)
from .ops.kiss_icp import KissIcpConfig, KissIcpOdometry, kiss_icp
from .io import (MeshChunk, read_mesh, read_mesh_iter, read_point_cloud,
                 read_point_cloud_iter, supported_extensions, write_mesh, write_point_cloud)
from .io.compression import (CompressionConfig, compress_draco, compress_point_cloud,
                             decompress_draco, decompress_point_cloud)
from .io.ros2 import (PointCloud2Data, PointField, colored_normals_to_pointcloud2,
                      colored_to_pointcloud2, from_pointcloud2, from_pointcloud2_organized,
                      make_pointcloud2, make_pointcloud2_organized, normals_to_pointcloud2,
                      pointcloud2_to_colored, pointcloud2_to_colored_normals,
                      pointcloud2_to_normals, pointcloud2_to_xyz, xyz_to_pointcloud2)
from .ops.colorization import (InterpolationMode, RgbImageView, colorize_from_images,
                               colorize_point_cloud)
from .parallel.streaming import (BackpressureConfig, RealtimeMetrics, RealtimePipeline,
                                 RealtimeVoxelFilter, RunOptions, RunStats,
                                 StreamingCollector, StreamingStatistics,
                                 StreamingVoxelFilter, run_pipeline)
from .ops.neighbors import (BruteForceSearch, KdTree, KnnResult, knn, knn_grid, knn_window,
                            nearest_one, radius_neighbors)
from .ops.point_cloud_ops import (concatenate, k_nearest_neighbors, nearest_neighbor,
                                  neighbors_within)
from .ops.segmentation import (ClusterResult, EuclideanClusterConfig, PlaneModel,
                               PlaneSegmentationResult, extract_euclidean_clusters,
                               extract_plane, segment_plane, segment_plane_parallel)
from .ops.ndt import NdtConfig, NdtResult, ndt_registration
from .ops.normals import (NormalEstimationConfig, estimate_normals,
                          estimate_normals_detailed,
                          estimate_normals_with_config)
from .ops.registration import (ICPConfig, ICPResult, MultiscaleConfig, icp,
                                icp_point_to_plane, icp_point_to_point,
                                multiscale_icp_point_to_point)
from .ops.mesh_boolean import (BooleanOp, mesh_boolean, mesh_difference,
                               mesh_intersection, mesh_union)
from .ops.mesh_smoothing import (HcConfig, LaplacianConfig, TaubinConfig, smooth_hc,
                                 smooth_laplacian, smooth_taubin)
from .reconstruction import (AlphaShapeConfig, BallPivotingConfig, DelaunayConfig,
                             MlsConfig, PipelineConfig, PoissonConfig, VolumetricGrid,
                             alpha_shape_reconstruction, analyze_data, auto_reconstruct,
                             auto_reconstruct_detailed, ball_pivoting_reconstruction,
                             delaunay_reconstruction, estimate_optimal_alpha,
                             fill_boundary_holes, marching_cubes, mls_reconstruct,
                             mls_smooth, poisson_reconstruct, reconstruct_marching_cubes)
from .simplification import (ClusteringSimplifier, EdgeCollapseSimplifier, ProgressiveMesh,
                             QuadricErrorSimplifier, simplify_mesh)
from .ops.tsdf import TsdfVolume
from .ops.tsdf import create_volume as create_tsdf_volume
from .ops.tsdf import extract_surface as tsdf_extract_surface
from .ops.tsdf import extract_surface_banded_auto as tsdf_extract_surface_banded
from .ops.tsdf import integrate as tsdf_integrate
from .ops.tsdf import integrate_sequence as tsdf_integrate_sequence
from .ops.tsdf_raycast import RaycastResult
from .ops.tsdf_raycast import raycast as tsdf_raycast
from .ops.tsdf_raycast import shade as tsdf_shade
from .ops.tsdf_raycast import shade_rgb as tsdf_shade_rgb
from .ops.tsdf_raycast import sparse_raycast as sparse_tsdf_raycast
from .ops.tsdf_sparse import SparseTsdfVolume
from .ops.tsdf_sparse import create_sparse_volume as create_sparse_tsdf_volume
from .ops.tsdf_sparse import sparse_extract_surface as sparse_tsdf_extract_surface
from .ops.tsdf_sparse import sparse_integrate as sparse_tsdf_integrate
from .ops.tsdf_sparse import sparse_marching_cubes_soup as sparse_tsdf_marching_cubes_soup
from .ops.tsdf_sparse import sparse_to_dense as sparse_tsdf_to_dense

__all__ = [
    "core", "interop", "io", "kernels", "models", "native", "ops", "parallel",
    "reconstruction", "simplification", "utils",
    "PointCloud", "Transform", "PerceptionStep", "PerceptionResult",
    "RegistrationModel", "OdometryModel", "FpfhConfig", "FpfhResult", "extract_fpfh_features",
    "extract_fpfh_features_with_normals", "match_descriptors", "ShotConfig",
    "ShotResult", "SHOT_DIM", "USC_DIM", "extract_shot_features",
    "extract_usc_features",
    "GlobalRegistrationConfig", "GlobalRegistrationResult", "global_registration",
    "NormalEstimationConfig", "estimate_normals", "estimate_normals_detailed",
    "estimate_normals_with_config", "ICPConfig", "ICPResult", "MultiscaleConfig",
    "icp", "icp_point_to_point", "icp_point_to_plane",
    "multiscale_icp_point_to_point", "gicp", "GicpConfig", "ndt_registration",
    "NdtConfig", "NdtResult", "patchwork_plus_plus", "segment_ground",
    "PatchworkConfig", "GroundSegmentationResult", "kiss_icp", "KissIcpConfig",
    "KissIcpOdometry", "OutlierResult", "VoxelGridResult",
    "voxel_grid_filter", "voxel_grid_filter_detailed", "passthrough_filter",
    "range_filter", "statistical_outlier_removal",
    "statistical_outlier_removal_with_threshold", "radius_outlier_removal",
    "ThreeCrateError", "IoError", "InvalidDataError", "AlgorithmError",
    "DeviceError", "VisualizationError", "UnsupportedError",
    "UnsupportedFormatError", "CameraIntrinsics", "OrganizedPointCloud",
    "TsdfVolume", "create_tsdf_volume", "tsdf_extract_surface", "tsdf_integrate",
    "tsdf_integrate_sequence", "tsdf_extract_surface_banded", "SparseTsdfVolume",
    "create_sparse_tsdf_volume", "sparse_tsdf_extract_surface", "sparse_tsdf_integrate",
    "sparse_tsdf_marching_cubes_soup", "sparse_tsdf_to_dense", "RaycastResult",
    "tsdf_raycast", "tsdf_shade", "tsdf_shade_rgb", "sparse_tsdf_raycast",
    "FrameToModelConfig", "FrameToModelOdometry", "TrackResult", "track_frame_to_model",
    "TriangleMesh", "VolumetricGrid", "marching_cubes", "reconstruct_marching_cubes",
    "PoissonConfig", "poisson_reconstruct", "FPFH_DIM", "global_registration_with_normals",
    "KnnResult", "knn", "knn_window", "nearest_one", "radius_neighbors",
    "ReconstructionModel", "NormalPointCloud", "ColoredPointCloud",
    "ColoredNormalPointCloud", "BooleanOp", "mesh_boolean", "mesh_difference",
    "mesh_intersection", "mesh_union", "HcConfig", "LaplacianConfig", "TaubinConfig",
    "smooth_hc", "smooth_laplacian", "smooth_taubin", "BallPivotingConfig",
    "ball_pivoting_reconstruction", "fill_boundary_holes", "AlphaShapeConfig",
    "alpha_shape_reconstruction", "estimate_optimal_alpha", "DelaunayConfig",
    "delaunay_reconstruction", "MlsConfig", "mls_reconstruct", "mls_smooth",
    "PipelineConfig", "auto_reconstruct", "auto_reconstruct_detailed", "analyze_data",
    "ClusteringSimplifier", "EdgeCollapseSimplifier", "ProgressiveMesh",
    "QuadricErrorSimplifier", "simplify_mesh",
    "read_point_cloud", "write_point_cloud", "read_mesh", "write_mesh",
    "read_point_cloud_iter", "read_mesh_iter", "MeshChunk", "supported_extensions",
    "BruteForceSearch", "KdTree", "knn_grid", "ClusterResult", "EuclideanClusterConfig",
    "PlaneModel", "PlaneSegmentationResult", "extract_euclidean_clusters", "extract_plane",
    "segment_plane", "segment_plane_parallel", "concatenate", "k_nearest_neighbors",
    "nearest_neighbor", "neighbors_within",
    "CompressionConfig", "compress_point_cloud", "decompress_point_cloud",
    "compress_draco", "decompress_draco",
    "PointField", "PointCloud2Data", "make_pointcloud2", "from_pointcloud2",
    "make_pointcloud2_organized", "from_pointcloud2_organized", "pointcloud2_to_xyz",
    "pointcloud2_to_normals", "pointcloud2_to_colored", "pointcloud2_to_colored_normals",
    "xyz_to_pointcloud2", "normals_to_pointcloud2", "colored_to_pointcloud2",
    "colored_normals_to_pointcloud2",
    "InterpolationMode", "RgbImageView", "colorize_from_images", "colorize_point_cloud",
    "BackpressureConfig", "RealtimeMetrics", "RealtimePipeline", "RealtimeVoxelFilter",
    "RunOptions", "RunStats", "StreamingCollector", "StreamingStatistics",
    "StreamingVoxelFilter", "run_pipeline",
    "__version__",
]
