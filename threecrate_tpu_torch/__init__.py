"""threecrate-tpu's PyTorch/CUDA port.

The same point-cloud library as ``threecrate_tpu`` (the JAX reference,
which stays beside it), in eager PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (``csrc/``). Four slices are ported:
``PerceptionStep`` (union-window normals and static-sort point-to-point
ICP), ``RegistrationModel`` (fused-window FPFH, descriptor matching,
batched RANSAC, then ICP), the Morton-window neighbourhood ops (FPFH
at its default band rungs, the window kNN family, ``method="window"``
normals, the staged window FPFH and statistical outlier removal) and
the SHOT/USC descriptors (the fused band path and the staged path),
with the data model, Morton keys, small linear algebra and exact
neighbour search they need. Clouds built with ``PointCloud.from_numpy``
live on the card unless the caller asks for the CPU. Modules mirror the
JAX package's layout and public names.
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
from .models import PerceptionResult, PerceptionStep, RegistrationModel
from .ops.features import (SHOT_DIM, USC_DIM, FpfhConfig, FpfhResult, ShotConfig,
                           ShotResult, extract_fpfh_features,
                           extract_fpfh_features_with_normals, extract_shot_features,
                           extract_usc_features, match_descriptors)
from .ops.filtering import (OutlierResult, radius_outlier_removal,
                            statistical_outlier_removal,
                            statistical_outlier_removal_with_threshold)
from .ops.global_registration import (GlobalRegistrationConfig,
                                      GlobalRegistrationResult, global_registration)
from .ops.normals import (NormalEstimationConfig, estimate_normals,
                          estimate_normals_detailed,
                          estimate_normals_with_config)
from .ops.registration import ICPResult, icp, icp_point_to_point

__all__ = [
    "core", "interop", "kernels", "models", "ops", "utils",
    "PointCloud", "Transform", "PerceptionStep", "PerceptionResult",
    "RegistrationModel", "FpfhConfig", "FpfhResult", "extract_fpfh_features",
    "extract_fpfh_features_with_normals", "match_descriptors", "ShotConfig",
    "ShotResult", "SHOT_DIM", "USC_DIM", "extract_shot_features",
    "extract_usc_features",
    "GlobalRegistrationConfig", "GlobalRegistrationResult", "global_registration",
    "NormalEstimationConfig", "estimate_normals", "estimate_normals_detailed",
    "estimate_normals_with_config", "ICPResult", "icp", "icp_point_to_point",
    "OutlierResult", "statistical_outlier_removal",
    "statistical_outlier_removal_with_threshold", "radius_outlier_removal",
    "ThreeCrateError", "IoError", "InvalidDataError", "AlgorithmError",
    "DeviceError", "VisualizationError", "UnsupportedError",
    "UnsupportedFormatError", "__version__",
]
