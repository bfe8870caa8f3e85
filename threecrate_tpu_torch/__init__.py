"""threecrate-tpu's PyTorch/CUDA port.

The same point-cloud library as ``threecrate_tpu`` (the JAX reference,
which stays beside it), in eager PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (``csrc/``). This slice covers ``PerceptionStep``:
union-window normals and static-sort point-to-point ICP, with the data
model, Morton keys, small linear algebra and exact neighbour search
they need. Modules mirror the JAX package's layout and public names.
"""

__version__ = "0.1.0"

from . import core, interop, kernels, models, ops, utils
from .core import (
    AlgorithmError,
    DeviceError,
    InvalidDataError,
    IoError,
    PointCloud,
    ThreeCrateError,
    Transform,
    UnsupportedError,
    UnsupportedFormatError,
    VisualizationError,
)
from .models import PerceptionResult, PerceptionStep
from .ops.normals import (NormalEstimationConfig, estimate_normals,
                          estimate_normals_detailed,
                          estimate_normals_with_config)
from .ops.registration import ICPResult, icp, icp_point_to_point

__all__ = [
    "core", "interop", "kernels", "models", "ops", "utils",
    "PointCloud", "Transform", "PerceptionStep", "PerceptionResult",
    "NormalEstimationConfig", "estimate_normals", "estimate_normals_detailed",
    "estimate_normals_with_config", "ICPResult", "icp", "icp_point_to_point",
    "ThreeCrateError", "IoError", "InvalidDataError", "AlgorithmError",
    "DeviceError", "VisualizationError", "UnsupportedError",
    "UnsupportedFormatError", "__version__",
]
