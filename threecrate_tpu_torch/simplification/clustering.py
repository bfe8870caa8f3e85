"""Vertex-clustering simplification (Rossignac-Borrel).

Counterpart of ``threecrate_tpu.simplification.clustering``: the JAX
module computes in NumPy on the host, and so does this copy (the result
lies on the input mesh's device).

Covers threecrate-simplification/src/clustering.rs: uniform-grid or
adaptive octree clustering (ClusteringMode, clustering.rs:29-38),
representative selection by centroid / valence weighting / minimal
quadric (RepresentativeStrategy, :18-26), boundary/feature flags.

No sequential queue: cluster ids are voxel keys, representatives are
segment reductions and face remapping is a gather (SURVEY §7.9).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh


class ClusteringMode(enum.Enum):
    """clustering.rs:29-38."""

    UNIFORM_GRID = "uniform_grid"
    ADAPTIVE = "adaptive"   # finer cells where curvature is high


class RepresentativeStrategy(enum.Enum):
    """clustering.rs:18-26."""

    CENTROID = "centroid"
    VALENCE_WEIGHTED = "valence_weighted"
    MIN_QUADRIC = "min_quadric"


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    cell_size: Optional[float] = None       # None → from target ratio
    target_ratio: float = 0.25              # target vertex fraction
    mode: ClusteringMode = ClusteringMode.UNIFORM_GRID
    representative: RepresentativeStrategy = RepresentativeStrategy.CENTROID
    adaptive_levels: int = 2


def _cluster_ids(verts: np.ndarray, cell: float, mode: ClusteringMode,
                 faces: np.ndarray, levels: int) -> np.ndarray:
    mn = verts.min(0)
    if mode == ClusteringMode.UNIFORM_GRID:
        keys = np.floor((verts - mn) / cell).astype(np.int64)
    else:
        # adaptive: halve the cell where local normal variation is high
        tri = verts[faces]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
        acc = np.zeros((len(verts), 3))
        cnt = np.zeros(len(verts))
        for c in range(3):
            np.add.at(acc, faces[:, c], fn)
            np.add.at(cnt, faces[:, c], 1)
        mean_n = acc / np.maximum(cnt, 1)[:, None]
        variation = 1 - np.linalg.norm(mean_n, axis=1)  # 0 flat, →1 curved
        level = np.clip((variation * 4 * levels).astype(np.int64), 0,
                        levels)
        scale = (2.0 ** level)[:, None]
        keys = np.floor((verts - mn) / cell * scale).astype(np.int64)
        keys = np.concatenate([keys, level[:, None]], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    return inv


def _representatives(verts: np.ndarray, faces: np.ndarray, inv: np.ndarray,
                     n_clusters: int,
                     strategy: RepresentativeStrategy) -> np.ndarray:
    if strategy == RepresentativeStrategy.MIN_QUADRIC:
        from .quadric import vertex_quadrics
        q = vertex_quadrics(verts.astype(np.float64), faces)
        qc = np.zeros((n_clusters, 4, 4))
        np.add.at(qc, inv, q)
        a = qc[:, :3, :3] + 1e-9 * np.eye(3)
        b = -qc[:, :3, 3]
        reps = np.linalg.solve(a, b[..., None])[..., 0]
        # guard: keep centroid where the solve goes wild
        cent = np.zeros((n_clusters, 3))
        cnt = np.zeros(n_clusters)
        np.add.at(cent, inv, verts)
        np.add.at(cnt, inv, 1)
        cent /= np.maximum(cnt, 1)[:, None]
        wild = np.linalg.norm(reps - cent, axis=1) > 10 * \
            (verts.max(0) - verts.min(0)).max() / max(n_clusters ** (1 / 3), 1)
        reps[wild] = cent[wild]
        return reps.astype(np.float32)
    weights = np.ones(len(verts))
    if strategy == RepresentativeStrategy.VALENCE_WEIGHTED:
        val = np.zeros(len(verts))
        np.add.at(val, faces.ravel(), 1)
        weights = np.maximum(val, 1)
    acc = np.zeros((n_clusters, 3))
    wsum = np.zeros(n_clusters)
    np.add.at(acc, inv, verts * weights[:, None])
    np.add.at(wsum, inv, weights)
    return (acc / np.maximum(wsum, 1e-30)[:, None]).astype(np.float32)


def cluster_simplify(mesh: TriangleMesh,
                     config: ClusteringConfig = ClusteringConfig()
                     ) -> TriangleMesh:
    verts, faces = mesh.to_numpy()
    if len(faces) == 0:
        raise InvalidDataError("cannot simplify an empty mesh")
    cell = config.cell_size
    if cell is None:
        ext = (verts.max(0) - verts.min(0)).max()
        target_clusters = max(int(len(verts) * config.target_ratio), 4)
        cell = float(ext) / max(target_clusters ** (1 / 3), 1.0)
    inv = _cluster_ids(verts, cell, config.mode, faces,
                       config.adaptive_levels)
    n_clusters = int(inv.max()) + 1
    reps = _representatives(verts, faces, inv, n_clusters,
                            config.representative)
    new_faces = inv[faces]
    ok = (new_faces[:, 0] != new_faces[:, 1]) \
        & (new_faces[:, 1] != new_faces[:, 2]) \
        & (new_faces[:, 0] != new_faces[:, 2])
    new_faces = new_faces[ok]
    # dedupe faces collapsed onto each other
    if len(new_faces):
        key = np.sort(new_faces, axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        new_faces = new_faces[np.sort(first)]
    return TriangleMesh.from_numpy(reps, new_faces.astype(np.int32),
                                   device=mesh.device)


class ClusteringSimplifier:
    """MeshSimplifier impl (clustering.rs:495)."""

    def __init__(self, config: ClusteringConfig = ClusteringConfig()):
        self.config = config

    def simplify(self, mesh: TriangleMesh, target_faces: int
                 ) -> TriangleMesh:
        # iterate cell size toward the face budget (cheap: 3 attempts)
        verts, faces = mesh.to_numpy()
        ratio = target_faces / max(len(faces), 1)
        cfg = dataclasses.replace(self.config, target_ratio=ratio)
        out = cluster_simplify(mesh, cfg)
        for _ in range(3):
            n = int(out.face_count())
            if n <= target_faces * 1.3:
                break
            ratio *= 0.6
            cfg = dataclasses.replace(self.config, target_ratio=ratio)
            out = cluster_simplify(mesh, cfg)
        return out
