"""Pipeline models."""

from .perception import OdometryModel, PerceptionResult, PerceptionStep, RegistrationModel

__all__ = ["OdometryModel", "PerceptionResult", "PerceptionStep", "RegistrationModel"]
