"""Alpha-shape surface reconstruction.

Counterpart of ``threecrate_tpu.reconstruction.alpha_shape``. The k-NN
searches, the α estimate, the circumspheres and both empty-ball tests
run on the cloud's device; the candidate triples, their ``np.unique``
dedupe, the greedy edge-use pruning and the remap are a host copy. The
mesh lies on the cloud's device.

Covers threecrate-reconstruction/src/alpha_shape.rs: alpha complex over
local neighborhoods with fixed or adaptive alpha (AlphaMode,
alpha_shape.rs:22) and ``estimate_optimal_alpha`` from k-NN spacing
(alpha_shape.rs:543).

Formulation: instead of walking a global Delaunay complex, candidate
triangles are generated from each point's k-NN pairs (batched), and the
alpha test — circumradius ≤ α AND empty circumsphere — is evaluated for
*all* candidates at once; the emptiness test is one kNN query against
the triangle circumcenters. Duplicate triangles from multiple seeds are
welded host-side. This matches the reference's "alpha complex over
local neighborhoods" structure (it is also neighborhood-local, not a
full 3D Delaunay).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from ..ops import neighbors


class AlphaMode(enum.Enum):
    """alpha_shape.rs:22."""

    FIXED = "fixed"
    ADAPTIVE = "adaptive"


@dataclasses.dataclass(frozen=True)
class AlphaShapeConfig:
    alpha: Optional[float] = None      # None + ADAPTIVE → estimated
    mode: AlphaMode = AlphaMode.ADAPTIVE
    k_neighbors: int = 12
    adaptive_factor: float = 2.0


def estimate_optimal_alpha(cloud: PointCloud, k: int = 8,
                           factor: float = 2.0) -> float:
    """α from mean k-NN spacing (estimate_optimal_alpha,
    alpha_shape.rs:543)."""
    res = neighbors.knn(cloud.points, cloud.mask, cloud.points, cloud.mask,
                        k, exclude_self=True)
    d = torch.where(res.mask, res.distances, 0.0)
    cnt = torch.clamp_min(res.mask.sum(), 1)
    return float(d.sum() / cnt) * factor


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _circumspheres(tri: torch.Tensor):
    """(T, 3, 3) triangles → (centers (T,3), radii (T,))."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    n = _cross(ab, ac)
    n2 = (n * n).sum(-1)
    ab2 = (ab * ab).sum(-1)
    ac2 = (ac * ac).sum(-1)
    denom = torch.where(n2 > 1e-20, 2 * n2, 1.0)
    center = a + (ab2[:, None] * _cross(n, ac)
                  + ac2[:, None] * _cross(ab, n)) / denom[:, None]
    r = torch.linalg.vector_norm(center - a, dim=-1)
    degenerate = n2 <= 1e-20
    return center, torch.where(degenerate, torch.inf, r)


def alpha_shape_reconstruction(cloud: PointCloud,
                               config: AlphaShapeConfig = AlphaShapeConfig()
                               ) -> TriangleMesh:
    """Alpha-complex surface (alpha_shape.rs entry)."""
    n_valid = int(cloud.size())
    if n_valid < 4:
        raise InvalidDataError("alpha shape needs >= 4 points")
    alpha = config.alpha
    if alpha is None:
        if config.mode == AlphaMode.FIXED:
            raise InvalidDataError("FIXED mode requires an alpha value")
        alpha = estimate_optimal_alpha(cloud, config.k_neighbors,
                                       config.adaptive_factor)

    k = config.k_neighbors
    res = neighbors.knn(cloud.points, cloud.mask, cloud.points, cloud.mask,
                        k, exclude_self=True)
    nbr = res.indices.cpu().numpy()
    ok = res.mask.cpu().numpy()
    pts = cloud.points.cpu().numpy()
    mask = cloud.mask.cpu().numpy()
    dev = cloud.device

    # candidate triangles: (i, nbr_a, nbr_b) for all neighbor pairs
    ii, aa, bb = [], [], []
    pairs = [(a, b) for a in range(k) for b in range(a + 1, k)]
    for a, b in pairs:
        valid = mask & ok[:, a] & ok[:, b]
        idx = np.nonzero(valid)[0]
        ii.append(idx)
        aa.append(nbr[idx, a])
        bb.append(nbr[idx, b])
    i0 = np.concatenate(ii)
    i1 = np.concatenate(aa)
    i2 = np.concatenate(bb)
    faces = np.stack([i0, i1, i2], 1)
    # dedupe (sorted index triple)
    key = np.sort(faces, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    faces = faces[first]

    tri = torch.from_numpy(pts[faces]).to(dev)
    centers, radii = _circumspheres(tri)
    small = radii.cpu().numpy() <= alpha
    faces = faces[small]
    if faces.shape[0] == 0:
        return TriangleMesh.empty(device=dev)
    keep = torch.from_numpy(small).to(dev)
    tri = tri[keep]
    centers = centers[keep]
    radii_s = radii[keep]

    # alpha test: a radius-α ball *through the 3 vertices* must be empty.
    # The two candidate ball centers sit at circumcenter ± n̂·√(α²−r²);
    # the face belongs to the α-shape if either ball contains no other
    # point (checked as nearest-point distance ≥ α−ε, batched kNN).
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    nrm = _cross(b - a, c - a)
    nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True),
                                1e-12)
    h = torch.sqrt(torch.clamp_min(alpha * alpha - radii_s * radii_s, 0.0))
    c_up = centers + nrm * h[:, None]
    c_dn = centers - nrm * h[:, None]
    q_up = neighbors.knn(cloud.points, cloud.mask, c_up, None, 1)
    q_dn = neighbors.knn(cloud.points, cloud.mask, c_dn, None, 1)
    tol = alpha * (1 - 1e-4)
    empty = (q_up.distances[:, 0].cpu().numpy() >= tol) \
        | (q_dn.distances[:, 0].cpu().numpy() >= tol)
    faces = faces[empty]
    radii_f = radii_s.cpu().numpy()[empty]
    if faces.shape[0] == 0:
        return TriangleMesh.empty(device=dev)

    # manifold pruning: the α-complex of a surface sample is "thick"
    # (overlapping tangential faces); greedily keep the best faces
    # (smallest circumradius first) subject to each edge being used at
    # most twice — yields the clean ~2n-face boundary surface
    order = np.argsort(radii_f)
    edge_use = {}
    kept = []
    for fi in order:
        f = faces[fi]
        ek = [tuple(sorted((f[0], f[1]))), tuple(sorted((f[1], f[2]))),
              tuple(sorted((f[2], f[0])))]
        if any(edge_use.get(e, 0) >= 2 for e in ek):
            continue
        kept.append(fi)
        for e in ek:
            edge_use[e] = edge_use.get(e, 0) + 1
    faces = faces[np.asarray(kept, np.int64)]

    # remap padded-array indices → compact vertex indices
    remap = np.cumsum(mask) - 1
    compact_pts = pts[mask]
    faces = remap[faces].astype(np.int32)
    return TriangleMesh.from_numpy(compact_pts, faces, device=dev)
