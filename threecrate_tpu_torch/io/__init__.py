"""File I/O with extension auto-detection.

Counterpart of ``threecrate_tpu.io`` for PLY, OBJ(+MTL), PCD, STL,
XYZ/CSV/TXT, KITTI .bin, LAS/LAZ, E57, .tcz and GLB readers/writers,
the Velodyne/Ouster PCAP, Livox LVX/LVX2, rosbag2 (.db3) and MCAP
decoders, ``.npz`` artifacts, the format registry with extension
dispatch (threecrate-io/src/lib.rs:95-203) and the streaming chunk
iterators (lib.rs:233-320). Parsing is host-side NumPy (ASCII floats,
Velodyne packets, LZF and LASzip through the C++ libraries of
``native``); the readers return clouds and meshes on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from . import (artifacts, compression, e57, gltf, las, lidar,
               mesh_attributes, mmap, obj, pcd, ply, ros2, rosbag, stl,
               xyz_csv)
from .registry import REGISTRY, IoRegistry, MeshChunk

# -- wire the default registry (lib.rs:95-158 lazy_static block) ----------
REGISTRY.register("ply", cloud_reader=ply.read_point_cloud,
                  cloud_writer=ply.write_point_cloud,
                  mesh_reader=ply.read_mesh, mesh_writer=ply.write_mesh,
                  cloud_stream_reader=ply.read_point_cloud_stream,
                  mesh_stream_reader=ply.read_mesh_stream)
REGISTRY.register("obj", cloud_reader=obj.read_point_cloud,
                  cloud_writer=obj.write_point_cloud,
                  mesh_reader=obj.read_mesh, mesh_writer=obj.write_mesh,
                  mesh_stream_reader=obj.read_mesh_stream)
REGISTRY.register("pcd", cloud_reader=pcd.read_point_cloud,
                  cloud_writer=pcd.write_point_cloud)
REGISTRY.register("stl", mesh_reader=stl.read_mesh, mesh_writer=stl.write_mesh)
for _ext in ("xyz", "csv", "txt"):
    REGISTRY.register(_ext, cloud_reader=xyz_csv.read_point_cloud,
                      cloud_writer=xyz_csv.write_point_cloud,
                      cloud_stream_reader=xyz_csv.read_point_cloud_stream)
REGISTRY.register("bin", cloud_reader=lidar.read_kitti_bin,
                  cloud_writer=lidar.write_kitti_bin)
REGISTRY.register("pcap", cloud_reader=lidar.read_velodyne_pcap)
REGISTRY.register("lvx", cloud_reader=lidar.read_livox_lvx)
REGISTRY.register("lvx2", cloud_reader=lidar.read_livox_lvx2)
REGISTRY.register("las", cloud_reader=las.read_point_cloud,
                  cloud_writer=las.write_point_cloud)
REGISTRY.register("laz", cloud_reader=las.read_point_cloud,
                  cloud_writer=las.write_point_cloud)
REGISTRY.register("db3", cloud_reader=rosbag.read_point_cloud)
REGISTRY.register("mcap", cloud_reader=rosbag.read_point_cloud_mcap)
REGISTRY.register("tcz", cloud_reader=compression.read_point_cloud,
                  cloud_writer=compression.write_point_cloud)
REGISTRY.register("e57", cloud_reader=e57.read_point_cloud,
                  cloud_writer=e57.write_point_cloud)
REGISTRY.register("glb", mesh_reader=gltf.read_mesh_glb,
                  mesh_writer=gltf.write_mesh_glb)


# -- top-level convenience API (lib.rs:159-203) ----------------------------

def read_point_cloud(path, **kw) -> PointCloud:
    """Read any supported point-cloud format by extension, onto
    ``device=`` (default the card)."""
    return REGISTRY.read_point_cloud(path, **kw)


def _path_first(a, b):
    """Accept both argument orders: the reference python API writes
    ``write_point_cloud(cloud, path)`` / ``write_mesh(mesh, path)``
    (threecrate-python/src/lib.rs:1695,1713 and threecrate.pyi:571,579)
    while this package historically took ``(path, obj)``. The two are
    type-disjoint (path: str/PathLike, payload: PointCloud/TriangleMesh),
    so dispatch on the first argument."""
    return (a, b) if isinstance(a, (str, bytes)) or hasattr(a, "__fspath__") \
        else (b, a)


def write_point_cloud(path, cloud: PointCloud = None, **kw) -> None:
    """Write a point cloud; accepts ``(path, cloud)`` or the reference
    order ``(cloud, path)`` (lib.rs:1695)."""
    path, cloud = _path_first(path, cloud)
    REGISTRY.write_point_cloud(path, cloud, **kw)


def read_mesh(path, **kw) -> TriangleMesh:
    """Read any supported mesh format by extension, onto ``device=``
    (default the card)."""
    return REGISTRY.read_mesh(path, **kw)


def write_mesh(path, mesh: TriangleMesh = None, **kw) -> None:
    """Write a mesh; accepts ``(path, mesh)`` or the reference order
    ``(mesh, path)`` (lib.rs:1713)."""
    path, mesh = _path_first(path, mesh)
    REGISTRY.write_mesh(path, mesh, **kw)


def read_mesh_iter(path, chunk_size: int = 65536, **kw):
    """Chunked streaming mesh read (io/src/lib.rs:292): yields
    MeshChunk(vertices=...) then MeshChunk(faces=...) host arrays."""
    return REGISTRY.read_mesh_iter(path, chunk_size=chunk_size, **kw)


def read_point_cloud_iter(path, chunk_size: int = 65536, **kw
                          ) -> Iterator[np.ndarray]:
    """Streaming chunked read (lib.rs:233-260): host (n, 3) arrays."""
    return REGISTRY.read_point_cloud_iter(path, chunk_size=chunk_size, **kw)


def supported_extensions():
    return REGISTRY.supported_extensions()


__all__ = [
    "read_point_cloud", "write_point_cloud", "read_mesh", "write_mesh",
    "read_point_cloud_iter", "read_mesh_iter", "supported_extensions",
    "REGISTRY", "IoRegistry", "MeshChunk",
    "ply", "obj", "pcd", "stl", "xyz_csv", "lidar", "mesh_attributes", "mmap",
    "las", "e57", "ros2", "rosbag", "gltf", "compression", "artifacts",
]
