"""Prelude: one import for the common surface.

Counterpart of ``threecrate_tpu.prelude``, with the same 33 names. Mirrors
the reference umbrella's ``prelude`` module (src/lib.rs:49-87 /
threecrate-umbrella/src/lib.rs): ``from threecrate_tpu_torch.prelude
import *`` brings the types + the everyday pipeline functions into scope.
"""

from .core import (  # noqa: F401
    CameraIntrinsics,
    OrganizedPointCloud,
    PointCloud,
    Transform,
    TriangleMesh,
)
from .api import (  # noqa: F401
    auto_reconstruct,
    estimate_normals,
    extract_euclidean_clusters,
    gicp,
    global_registration,
    icp,
    icp_point_to_plane,
    icp_point_to_point,
    kiss_icp,
    marching_cubes,
    mesh_difference,
    mesh_intersection,
    mesh_union,
    ndt_registration,
    poisson_reconstruct,
    radius_outlier_removal,
    read_mesh,
    read_point_cloud,
    segment_plane,
    simplify_mesh,
    smooth_laplacian,
    smooth_taubin,
    statistical_outlier_removal,
    transform_point_cloud,
    voxel_downsample,
    voxel_grid_filter,
    write_mesh,
    write_point_cloud,
)

__all__ = [
    "CameraIntrinsics", "OrganizedPointCloud", "PointCloud", "Transform",
    "TriangleMesh",
    "auto_reconstruct", "estimate_normals", "extract_euclidean_clusters",
    "gicp", "global_registration", "icp", "icp_point_to_plane",
    "icp_point_to_point", "kiss_icp", "marching_cubes", "mesh_difference",
    "mesh_intersection", "mesh_union", "ndt_registration",
    "poisson_reconstruct", "radius_outlier_removal", "read_mesh",
    "read_point_cloud", "segment_plane", "simplify_mesh",
    "smooth_laplacian", "smooth_taubin", "statistical_outlier_removal",
    "transform_point_cloud", "voxel_downsample", "voxel_grid_filter",
    "write_mesh", "write_point_cloud",
]
