"""threecrate-tpu's PyTorch/CUDA port.

The same point-cloud library as ``threecrate_tpu`` (the JAX reference,
which stays beside it), in eager PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (``csrc/``). Every module of the JAX package is
ported, slice by slice:
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
then the multi-shard points axis of ``parallel`` (device meshes,
collectives, ring kNN, the sharded ICP family, the distributed Morton
sort with sharded window normals, the sharded filters and FPFH →
RANSAC); then the rest of ``parallel``: the x-slab block-sparse TSDF
with its halo-extended sharded raycast and
``ShardedFrameToModelOdometry``, the sharded NDT, ground, clusters,
SHOT, plane RANSAC, MLS and colorize, and the x-slab Poisson multigrid
(``parallel.poisson_mg``); then the user-facing surface: the reference-compatible root
API (``compat``'s adapters of the reference module's calling
conventions, ``api``'s helpers, ``prelude``, ``utils.debug`` and the
typed stub ``__init__.pyi``) and ``viz`` (the point and mesh
rasterisers, PBR shading and the viewer; imported explicitly, as
``threecrate_tpu_torch.viz``); with the data model, Morton keys, small
linear algebra and exact neighbour search they need. Clouds built with ``PointCloud.from_numpy``,
and the clouds the root names build from NumPy arrays, live on the card
unless the caller asks for the CPU (``device="cpu"``). Modules mirror the
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
from .models import (OdometryModel, PerceptionResult, PerceptionStep, ReconstructionModel,
                     RegistrationModel)
from .ops.features import FpfhResult, ShotResult
from .ops.filtering import OutlierResult, VoxelGridResult
# the flat tc.* surface, as the JAX package's: api.py imports the native
# names, then compat.py's adapters, which take 13 of the shared names
from .api import *  # noqa: F401,F403
from . import api

__all__ = [
    "core", "interop", "io", "kernels", "models", "native", "ops", "parallel",
    "reconstruction", "simplification", "utils", "api",
    "ThreeCrateError", "IoError", "InvalidDataError", "AlgorithmError",
    "DeviceError", "VisualizationError", "UnsupportedError",
    "UnsupportedFormatError",
    "PerceptionStep", "PerceptionResult", "RegistrationModel", "OdometryModel",
    "ReconstructionModel", "FpfhResult", "ShotResult", "OutlierResult",
    "VoxelGridResult",
    *api.__all__,
    "__version__",
]
