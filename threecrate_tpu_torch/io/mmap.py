"""Memory-mapped file reading for large binary assets.

Counterpart of ``threecrate_tpu.io.mmap``, the same code.
Covers threecrate-io/src/mmap.rs:14-60: an ``MmapReader`` gated to
files above a size threshold (64 KiB like the reference) with graceful
fallback to buffered IO. NumPy's ``memmap`` keeps the page cache as the
backing store, so binary PLY/PCD/LAS payload decoding becomes zero-copy
views instead of a full read() allocation.
"""

from __future__ import annotations

import mmap as _mmap
import os
from typing import Union

import numpy as np

from ..core.errors import IoError

MMAP_THRESHOLD = 64 * 1024  # io-mmap feature gate (mmap.rs:29)


class MmapReader:
    """Read-only view over a file: mmap above the threshold, buffered
    below it or when mapping fails (mmap.rs:29-60)."""

    def __init__(self, path, threshold: int = MMAP_THRESHOLD):
        self.path = str(path)
        try:
            size = os.path.getsize(self.path)
        except OSError as e:
            raise IoError(f"cannot stat {self.path}: {e}") from e
        self.size = size
        self.is_mapped = False
        self._buf: Union[memoryview, bytes]
        if size >= threshold:
            try:
                with open(self.path, "rb") as f:
                    self._mm = _mmap.mmap(f.fileno(), 0,
                                          access=_mmap.ACCESS_READ)
                self._buf = memoryview(self._mm)
                self.is_mapped = True
                return
            except (OSError, ValueError):
                pass  # graceful fallback (mmap.rs:50-52)
        with open(self.path, "rb") as f:
            self._buf = f.read()

    def data(self) -> Union[memoryview, bytes]:
        return self._buf

    def frombuffer(self, dtype, count: int = -1, offset: int = 0
                   ) -> np.ndarray:
        """Zero-copy typed view into the file."""
        return np.frombuffer(self._buf, dtype=dtype, count=count,
                             offset=offset)

    def close(self) -> None:
        if self.is_mapped:
            try:
                self._buf.release()
                self._mm.close()
            except BufferError:
                # live views still reference the mapping; leave cleanup
                # to GC (the mapping stays valid for those views)
                pass
            self.is_mapped = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
