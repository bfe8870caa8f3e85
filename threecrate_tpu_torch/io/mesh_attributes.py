"""Extended mesh attributes + attribute-preserving serialization.

Counterpart of ``threecrate_tpu.io.mesh_attributes``, the same host
NumPy code around a mesh on ``device``.
Covers threecrate-io/src/mesh_attributes.rs:17-56 (ExtendedTriangleMesh
with UVs, tangents, generic custom attributes and metadata) and
src/serialization.rs:14-51 (attribute-preserving round-trip with
validation / recompute options). The container format is PLY with
extra vertex properties plus a JSON metadata comment — readable by any
PLY tool, lossless for ours.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from . import ply


@dataclasses.dataclass
class ExtendedTriangleMesh:
    """TriangleMesh + UV/tangent/custom attributes + metadata
    (mesh_attributes.rs:17-56)."""

    mesh: TriangleMesh
    uvs: Optional[np.ndarray] = None          # (V, 2)
    tangents: Optional[np.ndarray] = None     # (V, 3)
    custom: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        """Length guards (serialization.rs validation options)."""
        n = int(self.mesh.vertex_count())
        for name, arr in [("uvs", self.uvs), ("tangents", self.tangents),
                          *self.custom.items()]:
            if arr is not None and len(arr) != n:
                raise InvalidDataError(
                    f"attribute {name!r} length {len(arr)} != vertices {n}")

    def recompute_normals(self) -> "ExtendedTriangleMesh":
        return dataclasses.replace(self,
                                   mesh=self.mesh.compute_vertex_normals())

    def recompute_tangents(self) -> "ExtendedTriangleMesh":
        """Tangents from UV gradients (falls back to an arbitrary frame
        when no UVs exist)."""
        v, f = self.mesh.to_numpy()
        if self.uvs is None:
            nrm = (self.mesh.attr_to_numpy("normals")
                   if self.mesh.normals is not None
                   else np.tile([0, 0, 1.0], (len(v), 1)))
            helper = np.where(np.abs(nrm[:, 2:3]) < 0.9,
                              [0, 0, 1.0], [1.0, 0, 0])
            t = np.cross(nrm, helper)
            t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-30)
            return dataclasses.replace(self, tangents=t.astype(np.float32))
        uv = self.uvs
        tan = np.zeros_like(v)
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        du1 = uv[f[:, 1]] - uv[f[:, 0]]
        du2 = uv[f[:, 2]] - uv[f[:, 0]]
        det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        t_face = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) / det[:, None]
        for c in range(3):
            np.add.at(tan, f[:, c], t_face)
        tan /= np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-30)
        return dataclasses.replace(self, tangents=tan.astype(np.float32))


def write_extended_mesh(path, ext: ExtendedTriangleMesh,
                        validate: bool = True) -> None:
    """Attribute-preserving write (serialization.rs:14-51)."""
    if validate:
        ext.validate()
    extra: Dict[str, np.ndarray] = {}
    if ext.uvs is not None:
        extra["u"] = ext.uvs[:, 0].astype(np.float32)
        extra["v"] = ext.uvs[:, 1].astype(np.float32)
    if ext.tangents is not None:
        for i, c in enumerate("xyz"):
            extra[f"tangent_{c}"] = ext.tangents[:, i].astype(np.float32)
    for name, arr in ext.custom.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            extra[f"custom_{name}"] = arr
        else:
            for i in range(arr.shape[1]):
                extra[f"custom_{name}_{i}"] = arr[:, i]
    comments = []
    if ext.metadata:
        comments.append("tc_meta " + json.dumps(ext.metadata))
    opts = ply.PlyWriteOptions(binary=True, comments=comments,
                               extra_properties=extra)
    ply.write_mesh(path, ext.mesh, opts)


def read_extended_mesh(path, device="cuda") -> ExtendedTriangleMesh:
    """Attribute-preserving read — inverse of write_extended_mesh."""
    decoded = ply.read_ply_raw(path)
    mesh = ply.read_mesh(path, device=device)
    vert = decoded.get("vertex", {})
    uvs = None
    if "u" in vert and "v" in vert:
        uvs = np.stack([vert["u"], vert["v"]], -1).astype(np.float32)
    tangents = None
    if all(f"tangent_{c}" in vert for c in "xyz"):
        tangents = np.stack([vert[f"tangent_{c}"] for c in "xyz"],
                            -1).astype(np.float32)
    custom: Dict[str, np.ndarray] = {}
    comps: Dict[str, Dict[int, np.ndarray]] = {}
    for key, arr in vert.items():
        if not key.startswith("custom_"):
            continue
        rest = key[len("custom_"):]
        if "_" in rest and rest.rsplit("_", 1)[1].isdigit():
            base, i = rest.rsplit("_", 1)
            comps.setdefault(base, {})[int(i)] = arr
        else:
            custom[rest] = np.asarray(arr)
    for base, parts in comps.items():
        custom[base] = np.stack([parts[i] for i in sorted(parts)], -1)

    metadata: Dict[str, str] = {}
    with open(path, "rb") as f:
        head = f.read(65536)
    header = ply.parse_header(head)
    for c in header.comments:
        if c.startswith("tc_meta "):
            try:
                metadata = json.loads(c[len("tc_meta "):])
            except json.JSONDecodeError:
                pass
    return ExtendedTriangleMesh(mesh, uvs, tangents, custom, metadata)
