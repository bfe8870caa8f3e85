"""Pipeline models."""

from .perception import PerceptionResult, PerceptionStep, RegistrationModel

__all__ = ["PerceptionResult", "PerceptionStep", "RegistrationModel"]
