from . import debug, padding, profiling

__all__ = ["debug", "padding", "profiling"]
