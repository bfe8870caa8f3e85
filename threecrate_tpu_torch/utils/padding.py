"""Padding policy of the port: clouds are padded to a multiple of the
kernel tile width. The JAX package's geometric capacity buckets exist
for XLA's shape-keyed compile cache; eager PyTorch has none, so only
the round-up is kept."""

from __future__ import annotations

# Row multiple every padded cloud keeps (the ICP tile width).
LANE = 128


def round_up(n: int, multiple: int = LANE) -> int:
    return ((n + multiple - 1) // multiple) * multiple
