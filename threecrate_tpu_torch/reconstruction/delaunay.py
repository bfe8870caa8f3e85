"""2.5D Delaunay surface reconstruction.

Counterpart of ``threecrate_tpu.reconstruction.delaunay``, a host copy
(the JAX module has no device work either); the mesh lies on the
cloud's device.

Covers threecrate-reconstruction/src/delaunay.rs: project points to 2D
(PCA plane / axis drop / auto-select, delaunay.rs:8,100,299), run a 2D
Delaunay triangulation, lift triangles back to 3D.

The reference outsources triangulation to the ``spade`` crate; this
environment has no computational-geometry package, so the Bowyer-Watson
incremental triangulation is implemented here in NumPy. Triangulation
is an inherently sequential pointer algorithm (SURVEY §7.8 keeps it
host-side on purpose); the in-circumcircle tests inside each insertion
are vectorised over all current triangles.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from ..core.errors import AlgorithmError, InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud


class ProjectionPlane(enum.Enum):
    """delaunay.rs projection strategies (:8,100,299)."""

    AUTO = "auto"
    PCA = "pca"
    XY = "xy"
    XZ = "xz"
    YZ = "yz"


@dataclasses.dataclass(frozen=True)
class DelaunayConfig:
    projection: ProjectionPlane = ProjectionPlane.AUTO
    max_edge_length: Optional[float] = None  # filter sliver border tris


def delaunay_2d(pts2: np.ndarray) -> np.ndarray:
    """Bowyer-Watson incremental Delaunay. pts2: (N, 2) → (T, 3) int32.

    In-circumcircle tests are evaluated for all triangles of the current
    triangulation in one vectorised pass per insertion.
    """
    n = len(pts2)
    if n < 3:
        raise InvalidDataError("Delaunay needs >= 3 points")
    # super-triangle enclosing everything
    mn, mx = pts2.min(0), pts2.max(0)
    c = (mn + mx) / 2
    span = max(float((mx - mn).max()), 1e-9)
    st = np.array([
        c + [-20 * span, -10 * span],
        c + [20 * span, -10 * span],
        c + [0, 20 * span]], np.float64)
    pts = np.concatenate([pts2.astype(np.float64), st])
    si = np.array([n, n + 1, n + 2])

    tris = np.array([[n, n + 1, n + 2]], np.int64)

    # precompute circumcircles incrementally
    def circum(t):
        a, b, cc = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
        d = 2 * (a[:, 0] * (b[:, 1] - cc[:, 1])
                 + b[:, 0] * (cc[:, 1] - a[:, 1])
                 + cc[:, 0] * (a[:, 1] - b[:, 1]))
        d = np.where(np.abs(d) < 1e-30, 1e-30, d)
        a2 = (a * a).sum(1)
        b2 = (b * b).sum(1)
        c2 = (cc * cc).sum(1)
        ux = (a2 * (b[:, 1] - cc[:, 1]) + b2 * (cc[:, 1] - a[:, 1])
              + c2 * (a[:, 1] - b[:, 1])) / d
        uy = (a2 * (cc[:, 0] - b[:, 0]) + b2 * (a[:, 0] - cc[:, 0])
              + c2 * (b[:, 0] - a[:, 0])) / d
        ctr = np.stack([ux, uy], 1)
        r2 = ((pts[t[:, 0]] - ctr) ** 2).sum(1)
        return ctr, r2

    ctr, r2 = circum(tris)
    order = np.argsort(pts2[:, 0], kind="stable")  # insertion locality
    for p in order:
        d2 = ((ctr - pts[p]) ** 2).sum(1)
        bad = d2 <= r2 * (1 + 1e-12)
        if not bad.any():
            # numerical safety: attach to nearest triangle's cavity
            bad = d2 <= d2.min() * (1 + 1e-9)
        bad_tris = tris[bad]
        # boundary of the cavity: edges appearing exactly once
        edges = np.concatenate([bad_tris[:, [0, 1]], bad_tris[:, [1, 2]],
                                bad_tris[:, [2, 0]]])
        ek = np.sort(edges, axis=1)
        _, first_idx, counts = np.unique(
            ek, axis=0, return_index=True, return_counts=True)
        boundary = edges[first_idx[counts == 1]]
        new = np.concatenate(
            [boundary, np.full((len(boundary), 1), p, np.int64)], axis=1)
        tris = np.concatenate([tris[~bad], new])
        nctr, nr2 = circum(new)
        ctr = np.concatenate([ctr[~bad], nctr])
        r2 = np.concatenate([r2[~bad], nr2])

    keep = ~np.isin(tris, si).any(axis=1)
    return tris[keep].astype(np.int32)


def _project(points: np.ndarray, mode: ProjectionPlane
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(points2d, basis (2,3)) for the chosen projection."""
    if mode in (ProjectionPlane.AUTO, ProjectionPlane.PCA):
        mean = points.mean(0)
        cov = np.cov((points - mean).T)
        vals, vecs = np.linalg.eigh(cov)
        if mode == ProjectionPlane.AUTO and \
                vals[0] > 0.2 * max(vals[2], 1e-12):
            raise AlgorithmError(
                "Delaunay auto-projection: cloud is not height-field-like "
                "(smallest PCA extent is not small); use another algorithm")
        basis = vecs[:, 1:].T[::-1]   # two largest axes
        return (points - mean) @ basis.T, basis
    axes = {ProjectionPlane.XY: (0, 1), ProjectionPlane.XZ: (0, 2),
            ProjectionPlane.YZ: (1, 2)}[mode]
    basis = np.zeros((2, 3))
    basis[0, axes[0]] = 1
    basis[1, axes[1]] = 1
    return points[:, list(axes)], basis


def delaunay_reconstruction(cloud: PointCloud,
                            config: DelaunayConfig = DelaunayConfig()
                            ) -> TriangleMesh:
    """Height-field style surface triangulation (delaunay.rs entry)."""
    pts = cloud.to_numpy()
    if len(pts) < 3:
        raise InvalidDataError("Delaunay needs >= 3 points")
    pts2, _ = _project(pts, config.projection)
    faces = delaunay_2d(pts2)
    if config.max_edge_length is not None:
        tri = pts[faces]
        e = np.stack([
            np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1),
            np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1),
            np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1)], 1)
        faces = faces[e.max(1) <= config.max_edge_length]
    return TriangleMesh.from_numpy(pts, faces, device=cloud.device)
