"""Mesh simplification: counterpart of ``threecrate_tpu.simplification``.

Every simplifier runs on the host in NumPy, as the JAX package's do
(the greedy queues are sequential), and returns its mesh on the input
mesh's device.

``MeshSimplifier`` protocol (threecrate-simplification/src/lib.rs:21-25)
implemented by QuadricErrorSimplifier, EdgeCollapseSimplifier and
ClusteringSimplifier; ProgressiveMesh provides invertible LOD streams.
"""

from typing import Protocol

from ..core.mesh import TriangleMesh
from .clustering import (
    ClusteringConfig,
    ClusteringMode,
    ClusteringSimplifier,
    RepresentativeStrategy,
    cluster_simplify,
)
from .edge_collapse import EdgeCollapseConfig, EdgeCollapseSimplifier
from .progressive import ProgressiveMesh, VertexSplit
from .quadric import (
    QuadricErrorConfig,
    QuadricErrorSimplifier,
    qem_simplify,
    vertex_quadrics,
)


class MeshSimplifier(Protocol):
    """threecrate-simplification/src/lib.rs:21-25."""

    def simplify(self, mesh: TriangleMesh, target_faces: int
                 ) -> TriangleMesh: ...

    def simplify_ratio(self, mesh: TriangleMesh, ratio: float
                       ) -> TriangleMesh: ...


def simplify_mesh(mesh: TriangleMesh, target_faces: int,
                  method: str = "quadric") -> TriangleMesh:
    """Convenience dispatcher (the python API's ``simplify_mesh``)."""
    simplifiers = {
        "quadric": QuadricErrorSimplifier,
        "edge_collapse": EdgeCollapseSimplifier,
        "clustering": ClusteringSimplifier,
    }
    if method not in simplifiers:
        raise ValueError(f"unknown method {method!r}; "
                         f"have {sorted(simplifiers)}")
    return simplifiers[method]().simplify(mesh, target_faces)


__all__ = [
    "MeshSimplifier", "simplify_mesh",
    "ClusteringConfig", "ClusteringMode", "ClusteringSimplifier",
    "RepresentativeStrategy", "cluster_simplify",
    "EdgeCollapseConfig", "EdgeCollapseSimplifier",
    "ProgressiveMesh", "VertexSplit",
    "QuadricErrorConfig", "QuadricErrorSimplifier", "qem_simplify",
    "vertex_quadrics",
]
