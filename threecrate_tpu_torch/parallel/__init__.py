"""Counterpart of ``threecrate_tpu.parallel``: the out-of-core
streaming pipeline. The device meshes, the collectives and the sharded
solvers (``mesh``, ``sharded``, ``poisson_mg``) are not ported yet."""

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
    "BackpressureConfig", "RealtimeMetrics", "RealtimePipeline",
    "RealtimeVoxelFilter", "RunOptions", "RunStats", "StreamingCollector",
    "StreamingDeviceMap", "StreamingPipeline", "StreamingStatistics",
    "StreamingVoxelFilter", "run_pipeline",
]
