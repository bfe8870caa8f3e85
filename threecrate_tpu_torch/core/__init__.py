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
from .point_cloud import NORMALS, PointCloud
from .transform import Transform, se3_exp, skew

__all__ = [
    "AlgorithmError", "DeviceError", "InvalidDataError", "IoError",
    "ThreeCrateError", "UnsupportedError", "UnsupportedFormatError",
    "VisualizationError", "PointCloud", "NORMALS",
    "Transform", "se3_exp", "skew",
]
