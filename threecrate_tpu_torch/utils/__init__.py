from . import padding, profiling

__all__ = ["padding", "profiling"]
