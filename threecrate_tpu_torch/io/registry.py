"""Format registry: extension-dispatched point-cloud & mesh I/O.

Counterpart of ``threecrate_tpu.io.registry``, the analog of the
reference's trait-object registry
(threecrate-io/src/registry.rs:12-117 and the lazy_static IO_REGISTRY
wiring in threecrate-io/src/lib.rs:95-158). Readers/writers are plain
callables; the registry maps lower-cased extensions to them. Parsing
stays on the host (NumPy); a reader uploads its result to ``device``
(the card unless the caller asks for the CPU). The chunked iterators
yield host arrays, so their full-read fallbacks read onto the CPU.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np

from ..core.errors import IoError, UnsupportedFormatError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud

CloudReader = Callable[..., PointCloud]
CloudWriter = Callable[..., None]
MeshReader = Callable[..., TriangleMesh]
MeshWriter = Callable[..., None]


class MeshChunk(NamedTuple):
    """One streamed piece of a mesh (read_mesh_iter): exactly one of
    ``vertices`` ((n, 3) f32) / ``faces`` ((m, 3) i32, indices into the
    full vertex sequence) is set. The analog of the reference's
    streaming mesh iterator items (io/src/lib.rs:292), widened to
    stream vertices too instead of buffering them all."""

    vertices: Optional[np.ndarray] = None
    faces: Optional[np.ndarray] = None


class IoRegistry:
    """Extension → handler map (registry.rs:12-117)."""

    def __init__(self) -> None:
        self.cloud_readers: Dict[str, CloudReader] = {}
        self.cloud_writers: Dict[str, CloudWriter] = {}
        self.mesh_readers: Dict[str, MeshReader] = {}
        self.mesh_writers: Dict[str, MeshWriter] = {}
        self.cloud_stream_readers: Dict[str, Callable] = {}
        self.mesh_stream_readers: Dict[str, Callable] = {}

    # -- registration ------------------------------------------------------
    def register(self, ext: str, *, cloud_reader=None, cloud_writer=None,
                 mesh_reader=None, mesh_writer=None, cloud_stream_reader=None,
                 mesh_stream_reader=None):
        ext = ext.lower().lstrip(".")
        if cloud_reader:
            self.cloud_readers[ext] = cloud_reader
        if cloud_writer:
            self.cloud_writers[ext] = cloud_writer
        if mesh_reader:
            self.mesh_readers[ext] = mesh_reader
        if mesh_writer:
            self.mesh_writers[ext] = mesh_writer
        if cloud_stream_reader:
            self.cloud_stream_readers[ext] = cloud_stream_reader
        if mesh_stream_reader:
            self.mesh_stream_readers[ext] = mesh_stream_reader

    def supported_extensions(self):
        return sorted(set(self.cloud_readers) | set(self.cloud_writers)
                      | set(self.mesh_readers) | set(self.mesh_writers))

    # -- dispatch ---------------------------------------------------------
    @staticmethod
    def _ext(path: str) -> str:
        ext = os.path.splitext(str(path))[1].lower().lstrip(".")
        if not ext:
            raise UnsupportedFormatError(f"no file extension on {path!r}")
        return ext

    def read_point_cloud(self, path, **kw) -> PointCloud:
        ext = self._ext(path)
        fn = self.cloud_readers.get(ext)
        if fn is None:
            raise UnsupportedFormatError(
                f"no point-cloud reader for .{ext} "
                f"(supported: {self.supported_extensions()})")
        if not os.path.exists(path):
            raise IoError(f"file not found: {path}")
        return fn(path, **kw)

    def write_point_cloud(self, path, cloud: PointCloud, **kw) -> None:
        ext = self._ext(path)
        fn = self.cloud_writers.get(ext)
        if fn is None:
            raise UnsupportedFormatError(f"no point-cloud writer for .{ext}")
        fn(path, cloud, **kw)

    def read_mesh(self, path, **kw) -> TriangleMesh:
        ext = self._ext(path)
        fn = self.mesh_readers.get(ext)
        if fn is None:
            raise UnsupportedFormatError(f"no mesh reader for .{ext}")
        if not os.path.exists(path):
            raise IoError(f"file not found: {path}")
        return fn(path, **kw)

    def write_mesh(self, path, mesh: TriangleMesh, **kw) -> None:
        ext = self._ext(path)
        fn = self.mesh_writers.get(ext)
        if fn is None:
            raise UnsupportedFormatError(f"no mesh writer for .{ext}")
        fn(path, mesh, **kw)

    def read_point_cloud_iter(self, path, chunk_size: int = 65536, **kw
                              ) -> Iterator[np.ndarray]:
        """Chunked streaming read (lib.rs:233-320): yields host (n, 3)
        arrays without materialising the whole file."""
        ext = self._ext(path)
        fn = self.cloud_stream_readers.get(ext)
        if fn is None:
            # fallback: read fully, slice
            cloud = self.read_point_cloud(path, **{**kw, "device": "cpu"})
            pts = cloud.to_numpy()

            def gen():
                for i in range(0, len(pts), chunk_size):
                    yield pts[i:i + chunk_size]
            return gen()
        if not os.path.exists(path):
            raise IoError(f"file not found: {path}")
        return fn(path, chunk_size=chunk_size, **kw)

    def read_mesh_iter(self, path, chunk_size: int = 65536, **kw
                       ) -> Iterator[MeshChunk]:
        """Chunked streaming mesh read (io/src/lib.rs:292): yields
        MeshChunk host arrays — vertex chunks and face chunks —
        without materialising the whole file (for formats with a
        native streaming reader; others read fully and slice)."""
        ext = self._ext(path)
        fn = self.mesh_stream_readers.get(ext)
        if fn is None:
            mesh = self.read_mesh(path, **{**kw, "device": "cpu"})
            v, f = mesh.to_numpy()

            def gen():
                for i in range(0, len(v), chunk_size):
                    yield MeshChunk(vertices=v[i:i + chunk_size])
                for i in range(0, len(f), chunk_size):
                    yield MeshChunk(faces=f[i:i + chunk_size])
            return gen()
        if not os.path.exists(path):
            raise IoError(f"file not found: {path}")
        return fn(path, chunk_size=chunk_size, **kw)


# global default registry, populated by threecrate_tpu_torch.io.__init__
REGISTRY = IoRegistry()
