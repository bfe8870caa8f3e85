"""Ball-pivoting surface reconstruction (BPA).

Counterpart of ``threecrate_tpu.reconstruction.ball_pivoting``. The
k-NN searches (radius percentiles, candidate lists) run on the cloud's
device through ``ops.neighbors.knn``; the seed and front loop and the
hole filling are a host copy of the JAX module's, in float64, so equal
candidate lists give the same mesh. The mesh lies on the cloud's device.

Covers threecrate-reconstruction/src/ball_pivoting.rs: multi-scale
radii, adaptive radius selection from k-NN density percentiles
(AdaptiveStrategy, ball_pivoting.rs:46-56), triangle-quality gating and
the pivoting front itself (config :13-77, entries :833-869).

The front propagation is an inherently sequential region-grow (SURVEY
§7.8), the split the reference makes between its spatial hash grid and
its sequential pivot loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from ..ops import neighbors


@dataclasses.dataclass(frozen=True)
class BallPivotingConfig:
    """Mirrors BallPivotingConfig (ball_pivoting.rs:13-77)."""

    radii: Optional[Sequence[float]] = None   # None → adaptive
    k_candidates: int = 16
    adaptive_percentiles: Sequence[float] = (50.0, 90.0)
    adaptive_factor: float = 1.3
    min_triangle_quality: float = 0.05        # area / (longest edge)²
    max_triangles: int = 500_000
    # Post-pass hole filling (ball_pivoting.rs:34-35 declares
    # fill_holes and defaults it true — though the reference never
    # actually consumes the flag, we implement the promised behavior):
    # boundary-edge loops of at most max_hole_edges edges are closed
    # by quality-greedy ear clipping. Loops larger than the cap are
    # treated as the real surface boundary (an open scan's silhouette
    # must stay open) and left alone.
    fill_holes: bool = True
    max_hole_edges: int = 12


def estimate_radii(cloud: PointCloud, config: BallPivotingConfig
                   ) -> List[float]:
    """Adaptive multi-scale radii from k-NN spacing percentiles
    (AdaptiveStrategy, ball_pivoting.rs:46-56)."""
    res = neighbors.knn(cloud.points, cloud.mask, cloud.points, cloud.mask,
                        4, exclude_self=True)
    d = res.distances.cpu().numpy()
    m = res.mask.cpu().numpy()
    vals = d[m & np.isfinite(d)]
    if vals.size == 0:
        raise InvalidDataError("BPA: cloud too sparse for radius estimate")
    return [float(np.percentile(vals, p)) * config.adaptive_factor
            for p in config.adaptive_percentiles]


def _candidates(cloud: PointCloud, k: int):
    """Host (ids, valid, distances) of each point's ``k`` nearest other
    points, searched on the cloud's device."""
    res = neighbors.knn(cloud.points, cloud.mask, cloud.points, cloud.mask,
                        k, exclude_self=True)
    return (res.indices.cpu().numpy(), res.mask.cpu().numpy(),
            res.distances.cpu().numpy())


def _ball_center(a, b, c, rho):
    """Center of the radius-ρ ball resting on triangle (a, b, c) on the
    side of the triangle normal; None if ρ < circumradius."""
    ab, ac = b - a, c - a
    n = np.cross(ab, ac)
    n2 = float(n @ n)
    if n2 < 1e-20:
        return None
    cc = a + (float(ab @ ab) * np.cross(n, ac)
              + float(ac @ ac) * np.cross(ab, n)) / (2 * n2)
    r2 = float(((a - cc) ** 2).sum())
    h2 = rho * rho - r2
    if h2 <= 0:
        return None
    return cc + n / np.sqrt(n2) * np.sqrt(h2)


def _quality(a, b, c) -> float:
    e = max(float(((a - b) ** 2).sum()), float(((b - c) ** 2).sum()),
            float(((c - a) ** 2).sum()))
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
    return area / e if e > 0 else 0.0


def _boundary_loops(faces: List[Tuple[int, int, int]],
                    edge_count: Dict[Tuple[int, int], int]
                    ) -> List[List[int]]:
    """Closed loops of directed boundary edges (count==1), in the
    orientation they appear on their faces. Vertices where the
    boundary branches (non-manifold rims) poison their loops, which
    are then skipped rather than mis-stitched."""
    nxt: Dict[int, Optional[int]] = {}
    for (i, j, k) in faces:
        for u, v in ((i, j), (j, k), (k, i)):
            if edge_count.get((u, v) if u < v else (v, u), 0) == 1:
                nxt[u] = None if u in nxt else v
    loops: List[List[int]] = []
    visited: Set[int] = set()
    for start, v in nxt.items():
        if start in visited or v is None:
            continue
        loop, cur, ok = [start], v, True
        while cur != start:
            if cur in visited or nxt.get(cur) is None \
                    or len(loop) > 100_000:
                ok = False
                break
            loop.append(cur)
            cur = nxt[cur]
        visited.update(loop)
        if ok and len(loop) >= 3:
            loops.append(loop)
    return loops


def fill_boundary_holes(mesh: TriangleMesh,
                        max_hole_edges: int = 12) -> TriangleMesh:
    """Close boundary-edge loops of at most ``max_hole_edges`` edges by
    quality-greedy ear clipping (the behavior ball_pivoting.rs:34-35
    promises with its ``fill_holes: true`` default).

    Loops longer than the cap are kept open — an open scan's
    silhouette is a real boundary, not a hole. New faces take the
    orientation consistent with their ring neighbors (the loop is
    traversed opposite to the face-directed boundary edges).
    """
    verts, face_arr = mesh.to_numpy()
    pts = verts.astype(np.float64)
    faces = [tuple(int(x) for x in f) for f in face_arr]
    edge_count: Dict[Tuple[int, int], int] = {}
    used: Set[Tuple[int, int, int]] = set()
    for (i, j, k) in faces:
        used.add(tuple(sorted((i, j, k))))
        for e in ((i, j), (j, k), (k, i)):
            ek = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
            edge_count[ek] = edge_count.get(ek, 0) + 1
    new_faces = _fill_holes_inplace(pts, faces, edge_count, used,
                                    max_hole_edges)
    if not new_faces:
        return mesh
    return TriangleMesh.from_numpy(verts.astype(np.float32),
                                   np.asarray(faces, np.int32), device=mesh.device)


def _fill_holes_inplace(pts, faces, edge_count, used, max_hole_edges
                        ) -> List[Tuple[int, int, int]]:
    """Shared fill core: appends ear faces to ``faces`` (and updates
    ``edge_count``/``used``), returns just the added faces."""

    def add_face(i, j, k):
        key = tuple(sorted((i, j, k)))
        if key in used:
            return False
        for e in ((i, j), (j, k), (k, i)):
            ek = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
            if edge_count.get(ek, 0) >= 2:
                return False
        used.add(key)
        faces.append((i, j, k))
        for e in ((i, j), (j, k), (k, i)):
            ek = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
            edge_count[ek] = edge_count.get(ek, 0) + 1
        return True

    added: List[Tuple[int, int, int]] = []
    for loop in _boundary_loops(faces, edge_count):
        if len(loop) > max_hole_edges:
            continue
        # Faces carry directed edges (v_i, v_{i+1}); the closing fan
        # must carry the reverses, i.e. triangulate the reversed loop.
        poly = loop[::-1]
        while len(poly) >= 3:
            m = len(poly)
            ears = sorted(
                range(m),
                key=lambda i: -_quality(pts[poly[i - 1]], pts[poly[i]],
                                        pts[poly[(i + 1) % m]]))
            placed = False
            for i in ears:
                a, b, c = poly[i - 1], poly[i], poly[(i + 1) % m]
                if _quality(pts[a], pts[b], pts[c]) <= 1e-12:
                    break                      # only degenerates left
                if add_face(a, b, c):
                    added.append((a, b, c))
                    poly.pop(i)
                    placed = True
                    break
            if not placed:
                break                 # edge budget / degenerate: stop
    return added


def ball_pivoting_reconstruction(cloud: PointCloud,
                                 config: BallPivotingConfig =
                                 BallPivotingConfig()) -> TriangleMesh:
    """BPA entry (ball_pivoting.rs:833-869)."""
    pts = cloud.to_numpy().astype(np.float64)
    n = len(pts)
    if n < 3:
        raise InvalidDataError("BPA needs >= 3 points")
    radii = list(config.radii) if config.radii is not None \
        else estimate_radii(cloud, config)

    # device-batched candidate lists (the reference's spatial hash role)
    nbr, nbr_ok, nbr_d = _candidates(cloud, config.k_candidates)

    def empty_ball(center, rho, exclude):
        """No point strictly inside the ball (checked via candidates of
        the triangle's own vertices — local emptiness like the
        reference's hash-grid query)."""
        for v in exclude:
            cand = nbr[v][nbr_ok[v]]
            d2 = ((pts[cand] - center) ** 2).sum(1)
            inside = d2 < (rho * rho) * (1 - 1e-6)
            if np.any(inside & ~np.isin(cand, exclude)):
                return False
        return True

    faces: List[Tuple[int, int, int]] = []
    edge_count: Dict[Tuple[int, int], int] = {}
    used: Set[Tuple[int, int, int]] = set()
    vertex_used = np.zeros(n, bool)

    def add_face(i, j, k):
        key = tuple(sorted((i, j, k)))
        if key in used:
            return False
        for e in ((i, j), (j, k), (k, i)):
            if edge_count.get(tuple(sorted(e)), 0) >= 2:
                return False
        used.add(key)
        faces.append((i, j, k))
        for e in ((i, j), (j, k), (k, i)):
            ek = tuple(sorted(e))
            edge_count[ek] = edge_count.get(ek, 0) + 1
        vertex_used[[i, j, k]] = True
        return True

    for rho in radii:
        # -- seed triangles -----------------------------------------------
        front: List[Tuple[int, int, int]] = []  # directed edges + opposite
        for i in range(n):
            if vertex_used[i] or len(faces) >= config.max_triangles:
                continue
            cs = nbr[i][nbr_ok[i] & (nbr_d[i] <= 2 * rho)]
            seeded = False
            for x in range(len(cs)):
                for y in range(x + 1, len(cs)):
                    j, k = int(cs[x]), int(cs[y])
                    if _quality(pts[i], pts[j], pts[k]) \
                            < config.min_triangle_quality:
                        continue
                    center = _ball_center(pts[i], pts[j], pts[k], rho)
                    if center is None or not empty_ball(center, rho,
                                                        (i, j, k)):
                        center = _ball_center(pts[i], pts[k], pts[j], rho)
                        if center is None or not empty_ball(center, rho,
                                                            (i, k, j)):
                            continue
                        j, k = k, j
                    if add_face(i, j, k):
                        front += [(i, j, k), (j, k, i), (k, i, j)]
                        seeded = True
                        break
                if seeded:
                    break

            # -- expand the front from this seed --------------------------
            while front and len(faces) < config.max_triangles:
                a, b, o = front.pop()
                ek = tuple(sorted((a, b)))
                if edge_count.get(ek, 0) >= 2:
                    continue
                best, best_q = -1, -1.0
                cand = np.unique(np.concatenate([
                    nbr[a][nbr_ok[a]], nbr[b][nbr_ok[b]]]))
                for c in cand:
                    c = int(c)
                    if c in (a, b, o):
                        continue
                    if _quality(pts[a], pts[b], pts[c]) \
                            < config.min_triangle_quality:
                        continue
                    center = _ball_center(pts[b], pts[a], pts[c], rho)
                    if center is None:
                        continue
                    if not empty_ball(center, rho, (a, b, c)):
                        continue
                    q = _quality(pts[a], pts[b], pts[c])
                    if q > best_q:
                        best, best_q = c, q
                if best >= 0 and add_face(b, a, best):
                    front += [(b, best, a), (best, a, b)]

    if not faces:
        return TriangleMesh.empty(device=cloud.device)
    if config.fill_holes:
        _fill_holes_inplace(pts, faces, edge_count, used,
                            config.max_hole_edges)
    return TriangleMesh.from_numpy(pts.astype(np.float32),
                                   np.asarray(faces, np.int32), device=cloud.device)
