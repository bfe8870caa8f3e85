"""Data model: clouds, meshes, transforms, errors."""

from .errors import (
    AlgorithmError,
    DeviceError,
    InvalidDataError,
    IoError,
    ThreeCrateError,
    UnsupportedError,
    UnsupportedFormatError,
    VisualizationError,
    require,
)
from .mesh import TriangleMesh
from .organized import CameraIntrinsics, OrganizedPointCloud
from .point_cloud import COLORS, INTENSITY, NORMALS, PointCloud
from .transform import (Transform, axis_angle_to_matrix, matrix_to_quaternion,
                        quaternion_to_matrix, se3_exp, skew)

__all__ = [
    "AlgorithmError", "DeviceError", "InvalidDataError", "IoError",
    "ThreeCrateError", "UnsupportedError", "UnsupportedFormatError",
    "VisualizationError", "require", "TriangleMesh", "PointCloud", "COLORS",
    "INTENSITY", "NORMALS",
    "Transform", "se3_exp", "skew", "quaternion_to_matrix", "matrix_to_quaternion",
    "axis_angle_to_matrix",
    "CameraIntrinsics", "OrganizedPointCloud",
]
