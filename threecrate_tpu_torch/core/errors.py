"""Error types of the PyTorch port: the same hierarchy and names as
``threecrate_tpu.core.errors``, so callers catch one set of classes."""

from __future__ import annotations


class ThreeCrateError(Exception):
    """Base class for all threecrate errors."""


class IoError(ThreeCrateError):
    """File / stream I/O failure."""


class InvalidDataError(ThreeCrateError):
    """Input data is malformed (empty cloud, NaNs, wrong shape...)."""


class AlgorithmError(ThreeCrateError):
    """An algorithm could not run or converge given its inputs/config."""


class DeviceError(ThreeCrateError):
    """Accelerator/runtime failure: a kernel failed to build or launch."""


class VisualizationError(ThreeCrateError):
    """Viewer / rendering failure."""


class UnsupportedError(ThreeCrateError):
    """Requested operation not supported in this configuration."""


class UnsupportedFormatError(IoError, UnsupportedError):
    """File format/extension has no registered reader or writer."""

