"""Progressive meshes (Hoppe 1996): invertible collapse logs + LOD.

Counterpart of ``threecrate_tpu.simplification.progressive``, a host
copy with the same ``.npz`` format. The container holds host arrays; a
mesh taken from it goes to the card unless the caller asks for the CPU.

Covers threecrate-simplification/src/progressive.rs: record collapses
as invertible VertexSplit operations (progressive.rs:20-45), a
serialisable ``ProgressiveMesh{base_mesh, vertex_splits, counts}``
(:50-61) and refine-to-any-LOD. Consumed by the viewer's LOD meshes
(the reference feeds it to threecrate-gpu's LodMesh, gpu/src/mesh.rs:
1254)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from .quadric import QuadricErrorConfig, qem_simplify


@dataclasses.dataclass
class VertexSplit:
    """Inverse of one edge collapse (progressive.rs:20-45)."""

    kept: int                       # surviving vertex id (original index)
    removed: int                    # vertex id restored by this split
    kept_old_pos: np.ndarray        # kept vertex position BEFORE collapse
    removed_pos: np.ndarray
    removed_faces: List[Tuple[int, np.ndarray]]   # (face id, corners)
    remapped: List[Tuple[int, int]]               # (face id, corner slot)


@dataclasses.dataclass
class ProgressiveMesh:
    """Coarse base mesh + ordered split log (progressive.rs:50-61)."""

    base_vertices: np.ndarray       # positions in ORIGINAL index space
    base_faces: np.ndarray          # (F, 3) original-index faces
    base_face_alive: np.ndarray     # (F,) bool at base level
    splits: List[VertexSplit]       # apply in order to refine
    full_vertex_count: int
    full_face_count: int

    # -- construction ------------------------------------------------------
    @classmethod
    def from_mesh(cls, mesh: TriangleMesh, base_faces: int,
                  config: QuadricErrorConfig = QuadricErrorConfig()
                  ) -> "ProgressiveMesh":
        verts, faces = mesh.to_numpy()
        _, records = qem_simplify(mesh, base_faces, config,
                                  record_splits=True)
        # replay the collapses on an index-stable copy to get base state
        v = verts.astype(np.float64).copy()
        f = faces.astype(np.int64).copy()
        alive = np.ones(len(f), bool)
        splits: List[VertexSplit] = []
        for rec in records:
            a, b = rec["kept"], rec["removed"]
            splits.append(VertexSplit(
                kept=a, removed=b,
                kept_old_pos=np.asarray(rec["kept_old_pos"]),
                removed_pos=np.asarray(rec["removed_pos"]),
                removed_faces=[(fi, np.asarray(corn))
                               for fi, corn in rec["removed_faces"]],
                remapped=list(rec["remapped"])))
            for fi, _ in rec["removed_faces"]:
                alive[fi] = False
            for fi, slot in rec["remapped"]:
                f[fi, slot] = a
            v[a] = np.asarray(rec["new_pos"])  # collapse target position
        splits.reverse()  # refine order = reverse collapse order
        return cls(v.astype(np.float32), f.astype(np.int32), alive, splits,
                   len(verts), len(faces))

    # -- LOD extraction ----------------------------------------------------
    def mesh_at(self, n_splits: Optional[int] = None, device="cuda") -> TriangleMesh:
        """Apply the first ``n_splits`` splits (None = all → full mesh),
        the mesh on ``device``."""
        if n_splits is None:
            n_splits = len(self.splits)
        n_splits = int(np.clip(n_splits, 0, len(self.splits)))
        v = self.base_vertices.astype(np.float64).copy()
        f = self.base_faces.astype(np.int64).copy()
        alive = self.base_face_alive.copy()
        for s in self.splits[:n_splits]:
            v[s.removed] = s.removed_pos
            v[s.kept] = s.kept_old_pos
            for fi, slot in s.remapped:
                f[fi, slot] = s.removed
            for fi, corners in s.removed_faces:
                f[fi] = corners
                alive[fi] = True
        faces = f[alive]
        used = np.unique(faces)
        remap = np.full(len(v), -1, np.int64)
        remap[used] = np.arange(len(used))
        return TriangleMesh.from_numpy(
            v[used].astype(np.float32),
            remap[faces].astype(np.int32), device=device)

    def base_mesh(self, device="cuda") -> TriangleMesh:
        return self.mesh_at(0, device)

    def full_mesh(self, device="cuda") -> TriangleMesh:
        return self.mesh_at(None, device)

    def lod_levels(self, n_levels: int, device="cuda") -> List[TriangleMesh]:
        """Evenly spaced LODs coarse→fine (LodMesh::from_progressive_mesh,
        gpu/src/mesh.rs:1242-1291)."""
        steps = np.linspace(0, len(self.splits), n_levels).astype(int)
        return [self.mesh_at(s, device) for s in steps]

    # -- serialisation (progressive.rs is serde+bincode; like it, this is
    # a DATA-ONLY container — flat arrays in an npz, never pickle, so
    # loading an untrusted file cannot execute code) -----------------------
    def save(self, path) -> None:
        s = self.splits
        rf_counts = np.array([len(x.removed_faces) for x in s], np.int64)
        rm_counts = np.array([len(x.remapped) for x in s], np.int64)
        rf_ids = np.array([fi for x in s for fi, _ in x.removed_faces],
                          np.int64)
        rf_corners = (np.array(
            [c for x in s for _, c in x.removed_faces], np.int64)
            .reshape(-1, 3))
        rm_pairs = (np.array(
            [p for x in s for p in x.remapped], np.int64).reshape(-1, 2))
        with open(path, "wb") as f:
            np.savez(
                f,
                magic=np.frombuffer(b"TCPM", np.uint8), version=np.int64(1),
                base_vertices=self.base_vertices,
                base_faces=self.base_faces,
                base_face_alive=self.base_face_alive,
                full_counts=np.array(
                    [self.full_vertex_count, self.full_face_count],
                    np.int64),
                kept=np.array([x.kept for x in s], np.int64),
                removed=np.array([x.removed for x in s], np.int64),
                kept_old_pos=(np.array(
                    [x.kept_old_pos for x in s], np.float64)
                    .reshape(-1, 3)),
                removed_pos=(np.array(
                    [x.removed_pos for x in s], np.float64).reshape(-1, 3)),
                rf_counts=rf_counts, rf_ids=rf_ids, rf_corners=rf_corners,
                rm_counts=rm_counts, rm_pairs=rm_pairs)

    @classmethod
    def load(cls, path) -> "ProgressiveMesh":
        try:
            with np.load(path, allow_pickle=False) as z:
                if bytes(z["magic"].tobytes()) != b"TCPM":
                    raise InvalidDataError("not a ProgressiveMesh file")
                rf_off = np.concatenate(
                    [[0], np.cumsum(z["rf_counts"])]).astype(np.int64)
                rm_off = np.concatenate(
                    [[0], np.cumsum(z["rm_counts"])]).astype(np.int64)
                kept, removed = z["kept"], z["removed"]
                kop, rp = z["kept_old_pos"], z["removed_pos"]
                rf_ids, rf_corners = z["rf_ids"], z["rf_corners"]
                rm_pairs = z["rm_pairs"]
                splits = [
                    VertexSplit(
                        kept=int(kept[i]), removed=int(removed[i]),
                        kept_old_pos=kop[i], removed_pos=rp[i],
                        removed_faces=[
                            (int(rf_ids[j]), rf_corners[j])
                            for j in range(rf_off[i], rf_off[i + 1])],
                        remapped=[
                            (int(a), int(b))
                            for a, b in rm_pairs[rm_off[i]:rm_off[i + 1]]])
                    for i in range(len(kept))]
                fc = z["full_counts"]
                return cls(z["base_vertices"], z["base_faces"],
                           z["base_face_alive"], splits,
                           int(fc[0]), int(fc[1]))
        except InvalidDataError:
            raise
        except Exception as e:
            raise InvalidDataError(
                f"not a ProgressiveMesh file: {e}") from e
