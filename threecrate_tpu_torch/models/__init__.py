"""Pipeline models."""

from .perception import (OdometryModel, PerceptionResult, PerceptionStep,
                         ReconstructionModel, RegistrationModel)

__all__ = ["OdometryModel", "PerceptionResult", "PerceptionStep", "RegistrationModel",
           "ReconstructionModel"]
