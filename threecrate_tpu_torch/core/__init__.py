"""Data model: clouds, transforms, errors."""

from .errors import (
    AlgorithmError,
    DeviceError,
    InvalidDataError,
    IoError,
    ThreeCrateError,
    UnsupportedError,
    UnsupportedFormatError,
    VisualizationError,
)
from .organized import CameraIntrinsics, OrganizedPointCloud
from .point_cloud import NORMALS, PointCloud
from .transform import (Transform, matrix_to_quaternion, quaternion_to_matrix, se3_exp,
                        skew)

__all__ = [
    "AlgorithmError", "DeviceError", "InvalidDataError", "IoError",
    "ThreeCrateError", "UnsupportedError", "UnsupportedFormatError",
    "VisualizationError", "PointCloud", "NORMALS",
    "Transform", "se3_exp", "skew", "quaternion_to_matrix", "matrix_to_quaternion",
    "CameraIntrinsics", "OrganizedPointCloud",
]
