"""Pipeline models."""

from .perception import PerceptionResult, PerceptionStep

__all__ = ["PerceptionResult", "PerceptionStep"]
