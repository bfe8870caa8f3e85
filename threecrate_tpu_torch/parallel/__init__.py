"""Counterpart of ``threecrate_tpu.parallel``: device meshes, the
collectives over their shards, the points-axis sharded operations and
the out-of-core streaming pipeline.

Ported: ``mesh`` (``Mesh``, ``make_mesh``, the specs and placement
helpers, the ``Sharded`` value), ``collectives`` (``shard_map`` and
``ppermute`` / ``psum`` / ``pmin`` / ``pmax`` / ``all_gather`` /
``axis_index`` / ``axis_size`` for one controller), and of ``sharded``
the ring kNN with the ICP family (point-to-point, point-to-plane, GICP,
batched on a 2-D mesh), ring normals, the distributed Morton sort with
the sharded window normals (kernel 4 once a shard), the sharded voxel and
outlier filters and the sharded FPFH → matching → RANSAC chain. Not
ported yet: the rest of ``sharded`` (the slab TSDF with its raycaster
and ``ShardedFrameToModelOdometry``, NDT, ground, clusters, SHOT, plane
RANSAC, MLS, colorize) and ``poisson_mg``."""

from . import collectives
from .collectives import shard_map
from .mesh import (POINTS_AXIS, Mesh, P, PartitionSpec, Sharded, make_mesh, put,
                   put_replicated, put_sharded, replicated_spec, shard_cloud_spec)
from .sharded import (
    global_stats_local,
    icp_sharded_loop,
    icp_sharded_step,
    make_distributed_morton_sort,
    make_sharded_batch_icp,
    make_sharded_fpfh,
    make_sharded_gicp,
    make_sharded_global_registration,
    make_sharded_icp,
    make_sharded_icp_p2plane,
    make_sharded_knn,
    make_sharded_match_descriptors,
    make_sharded_normals,
    make_sharded_normals_window,
    make_sharded_outlier_stats,
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
    "BackpressureConfig", "RealtimeMetrics", "RealtimePipeline",
    "RealtimeVoxelFilter", "RunOptions", "RunStats", "StreamingCollector",
    "StreamingDeviceMap", "StreamingPipeline", "StreamingStatistics",
    "StreamingVoxelFilter", "run_pipeline",
]
