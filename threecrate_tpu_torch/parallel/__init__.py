"""Counterpart of ``threecrate_tpu.parallel``: device meshes, the
collectives over their shards, the sharded operations and the
out-of-core streaming pipeline. Every module of the JAX package's
``parallel`` is ported.

``mesh`` (``Mesh``, ``make_mesh``, the specs and placement helpers, the
``Sharded`` value), ``collectives`` (``shard_map`` and ``ppermute`` /
``psum`` / ``pmin`` / ``pmax`` / ``all_gather`` / ``axis_index`` /
``axis_size`` for one controller), ``sharded`` (the ring kNN with the ICP
family, ring normals, the distributed Morton sort with the sharded window
normals (kernel 4 once a shard), the sharded voxel and outlier filters,
the x-slab TSDF with its raycast and ``ShardedFrameToModelOdometry``, the
sharded FPFH → matching → RANSAC chain, NDT, ground, clusters, SHOT,
plane RANSAC, MLS and colorize), ``poisson_mg`` (the x-slab multigrid and
the sharded Poisson reconstruction) and ``streaming``."""

from . import collectives
from .collectives import shard_map
from .mesh import (POINTS_AXIS, Mesh, P, PartitionSpec, Sharded, make_mesh, put,
                   put_replicated, put_sharded, replicated_spec, shard_cloud_spec)
from .poisson_mg import (
    make_sharded_mg_solver,
    make_sharded_poisson,
    make_sharded_poisson_fields,
)
from .sharded import (
    ShardedFrameToModelOdometry,
    ShardedTsdf,
    ShardedTsdfState,
    global_stats_local,
    icp_sharded_loop,
    icp_sharded_step,
    make_distributed_morton_sort,
    make_sharded_batch_icp,
    make_sharded_clusters,
    make_sharded_colorize,
    make_sharded_fpfh,
    make_sharded_gicp,
    make_sharded_global_registration,
    make_sharded_ground,
    make_sharded_icp,
    make_sharded_icp_p2plane,
    make_sharded_knn,
    make_sharded_match_descriptors,
    make_sharded_mls,
    make_sharded_ndt,
    make_sharded_normals,
    make_sharded_normals_window,
    make_sharded_outlier_stats,
    make_sharded_plane_ransac,
    make_sharded_shot,
    make_sharded_tsdf,
    make_sharded_voxel_filter,
    morton_presort,
    ring_gather_rows_local,
    ring_knn_local,
    ring_knn_payload_local,
    ring_match1_local,
    sharded_fpfh_local,
)
from .streaming import (
    BackpressureConfig,
    RealtimeMetrics,
    RealtimePipeline,
    RealtimeVoxelFilter,
    RunOptions,
    RunStats,
    StreamingCollector,
    StreamingDeviceMap,
    StreamingPipeline,
    StreamingStatistics,
    StreamingVoxelFilter,
    run_pipeline,
)

__all__ = [
    "POINTS_AXIS", "Mesh", "P", "PartitionSpec", "Sharded", "make_mesh", "put",
    "put_replicated", "put_sharded", "replicated_spec", "shard_cloud_spec",
    "collectives", "shard_map",
    "global_stats_local", "icp_sharded_loop", "icp_sharded_step",
    "make_distributed_morton_sort", "make_sharded_batch_icp", "make_sharded_fpfh",
    "make_sharded_gicp", "make_sharded_global_registration", "make_sharded_icp",
    "make_sharded_icp_p2plane", "make_sharded_knn", "make_sharded_match_descriptors",
    "make_sharded_normals", "make_sharded_normals_window", "make_sharded_outlier_stats",
    "make_sharded_voxel_filter", "morton_presort", "ring_gather_rows_local",
    "ring_knn_local", "ring_knn_payload_local", "ring_match1_local",
    "sharded_fpfh_local",
    "make_sharded_clusters", "make_sharded_colorize", "make_sharded_ground",
    "make_sharded_mls", "make_sharded_ndt", "make_sharded_plane_ransac",
    "make_sharded_shot", "make_sharded_tsdf", "ShardedTsdf", "ShardedTsdfState",
    "ShardedFrameToModelOdometry",
    "make_sharded_mg_solver", "make_sharded_poisson", "make_sharded_poisson_fields",
    "BackpressureConfig", "RealtimeMetrics", "RealtimePipeline",
    "RealtimeVoxelFilter", "RunOptions", "RunStats", "StreamingCollector",
    "StreamingDeviceMap", "StreamingPipeline", "StreamingStatistics",
    "StreamingVoxelFilter", "run_pipeline",
]
