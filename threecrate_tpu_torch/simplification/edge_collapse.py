"""Edge-collapse simplifier with explicit topology validity checks.

Counterpart of ``threecrate_tpu.simplification.edge_collapse``, a host
copy (the result lies on the input mesh's device).

Covers threecrate-simplification/src/edge_collapse.rs: the reference
builds a half-edge mesh (HalfEdge{target,twin,next,prev,face},
edge_collapse.rs:20-43) and performs QEM-prioritised collapses gated by
topological validity (:474-511). This rebuild keeps the same gating —
the **link condition** (the one-rings of the edge endpoints must
intersect in exactly the edge's two opposite vertices, which the
half-edge structure exists to answer) plus normal-flip rejection —
implemented over vertex→face adjacency sets rather than half-edge
pointers, with all cost math batched (shared with .quadric)."""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Set

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from .quadric import collapse_cost, edges_and_boundary, vertex_quadrics


@dataclasses.dataclass(frozen=True)
class EdgeCollapseConfig:
    """Mirrors EdgeCollapseSimplifier knobs (edge_collapse.rs:511)."""

    check_link_condition: bool = True
    prevent_normal_flips: bool = True
    collapse_to_midpoint: bool = False  # else QEM-optimal position


def _link_condition(a: int, b: int, faces, vfaces) -> bool:
    """Collapse (a,b) is topology-safe iff N(a) ∩ N(b) equals exactly
    the opposite vertices of the shared faces (edge_collapse.rs validity
    checks)."""
    na = {v for fi in vfaces[a] for v in faces[fi]} - {a, b}
    nb = {v for fi in vfaces[b] for v in faces[fi]} - {a, b}
    shared_faces = vfaces[a] & vfaces[b]
    opp = set()
    for fi in shared_faces:
        for v in faces[fi]:
            if v not in (a, b):
                opp.add(v)
    return (na & nb) == opp and len(shared_faces) in (1, 2)


class EdgeCollapseSimplifier:
    """MeshSimplifier impl (edge_collapse.rs:511)."""

    def __init__(self, config: EdgeCollapseConfig = EdgeCollapseConfig()):
        self.config = config

    def simplify(self, mesh: TriangleMesh, target_faces: int
                 ) -> TriangleMesh:
        verts, faces = mesh.to_numpy()
        verts = verts.astype(np.float64)
        faces = faces.astype(np.int64)
        if len(faces) == 0:
            raise InvalidDataError("cannot simplify an empty mesh")

        edges, _ = edges_and_boundary(faces.astype(np.int32))
        q = vertex_quadrics(verts, faces.astype(np.int64))

        vfaces: List[Set[int]] = [set() for _ in range(len(verts))]
        for fi, f in enumerate(faces):
            for c in f:
                vfaces[c].add(fi)
        alive = np.ones(len(faces), bool)
        n_alive = len(faces)

        cost, pos = collapse_cost(
            q[edges[:, 0]] + q[edges[:, 1]],
            verts[edges[:, 0]], verts[edges[:, 1]],
            optimal=not self.config.collapse_to_midpoint)
        if self.config.collapse_to_midpoint:
            pos = (verts[edges[:, 0]] + verts[edges[:, 1]]) / 2
        version = np.zeros(len(verts), np.int64)
        heap = [(c, int(a), int(b), 0, 0, tuple(p))
                for c, (a, b), p in zip(cost, edges, pos)
                if np.isfinite(c)]
        heapq.heapify(heap)

        while heap and n_alive > target_faces:
            c, a, b, av, bv, p = heapq.heappop(heap)
            if version[a] != av or version[b] != bv or a == b:
                continue
            shared = vfaces[a] & vfaces[b]
            if not shared:
                continue
            if self.config.check_link_condition and \
                    not _link_condition(a, b, faces, vfaces):
                continue
            p = np.asarray(p)
            moved = (vfaces[a] | vfaces[b]) - shared
            if self.config.prevent_normal_flips:
                bad = False
                for fi in moved:
                    f = faces[fi]
                    vv = [p if v in (a, b) else verts[v] for v in f]
                    n_new = np.cross(vv[1] - vv[0], vv[2] - vv[0])
                    old = verts[f]
                    n_old = np.cross(old[1] - old[0], old[2] - old[0])
                    if n_new @ n_old <= 0:
                        bad = True
                        break
                if bad:
                    continue

            verts[a] = p
            q[a] = q[a] + q[b]
            version[a] += 1
            version[b] += 1
            for fi in shared:
                if alive[fi]:
                    alive[fi] = False
                    n_alive -= 1
                for v in faces[fi]:
                    vfaces[v].discard(fi)
            for fi in moved:
                faces[fi][faces[fi] == b] = a
                vfaces[a].add(fi)
            vfaces[b] = set()

            nbrs = sorted({v for fi in vfaces[a] for v in faces[fi]} - {a})
            for v in nbrs:
                cc, pp = collapse_cost(
                    (q[a] + q[v])[None], verts[a][None], verts[v][None],
                    optimal=not self.config.collapse_to_midpoint)
                if self.config.collapse_to_midpoint:
                    pp = ((verts[a] + verts[v]) / 2)[None]
                if np.isfinite(cc[0]):
                    heapq.heappush(heap, (float(cc[0]), a, int(v),
                                          int(version[a]), int(version[v]),
                                          tuple(pp[0])))

        out_faces = faces[alive]
        used = np.unique(out_faces)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        return TriangleMesh.from_numpy(
            verts[used].astype(np.float32),
            remap[out_faces].astype(np.int32), device=mesh.device)

    def simplify_ratio(self, mesh: TriangleMesh, ratio: float
                       ) -> TriangleMesh:
        n = int(mesh.face_count())
        return self.simplify(mesh, max(int(n * ratio), 1))
