"""TriangleMesh: padded vertex and face tensors with validity masks.

Counterpart of ``threecrate_tpu.core.mesh``: vertices, faces, optional
per-vertex normals and colours, face normals and areas, area-weighted
vertex normals. Both arrays are padded (``padding.pad_capacity``) with
masks, and every tensor of a mesh lies on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..utils import padding
from .errors import InvalidDataError
from .transform import Transform


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Padded triangle mesh.

    Attributes:
      vertices: ``(VC, 3)`` float32; rows past the valid count are padding.
      faces: ``(FC, 3)`` int32 vertex indices; invalid faces point at 0.
      vertex_mask: ``(VC,)`` bool.
      face_mask: ``(FC,)`` bool.
      attrs: optional per-vertex tensors ("normals": (VC, 3), "colors": (VC, 3)).
    """

    vertices: torch.Tensor
    faces: torch.Tensor
    vertex_mask: torch.Tensor
    face_mask: torch.Tensor
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_numpy(cls, vertices, faces, normals=None, colors=None,
                   vertex_capacity: Optional[int] = None,
                   face_capacity: Optional[int] = None, device="cuda") -> "TriangleMesh":
        """Build from host ``(V, 3)`` vertices and ``(F, 3)`` faces, padded
        to the capacities, on ``device``: the card unless the caller asks
        for the CPU."""
        v = np.asarray(vertices, dtype=np.float32)
        f = np.asarray(faces, dtype=np.int32)
        if v.ndim != 2 or v.shape[1] != 3:
            raise InvalidDataError(f"vertices must be (V, 3), got {v.shape}")
        if f.ndim != 2 or f.shape[1] != 3:
            raise InvalidDataError(f"faces must be (F, 3), got {f.shape}")
        if f.size and (f.min() < 0 or f.max() >= max(v.shape[0], 1)):
            raise InvalidDataError("face indices out of vertex range")
        vc = vertex_capacity or padding.pad_capacity(v.shape[0])
        fc = face_capacity or padding.pad_capacity(f.shape[0])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        attrs = {}
        for key, arr in (("normals", normals), ("colors", colors)):
            if arr is None:
                continue
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape[0] != v.shape[0]:
                raise InvalidDataError(
                    f"{key} length {arr.shape[0]} != vertex count {v.shape[0]}")
            attrs[key] = put(padding.pad_array(arr, vc))
        return cls(put(padding.pad_array(v, vc)), put(padding.pad_array(f, fc)),
                   put(padding.make_mask(v.shape[0], vc)),
                   put(padding.make_mask(f.shape[0], fc)), attrs)

    @classmethod
    def _from_tensors(cls, vertices: torch.Tensor, faces: torch.Tensor) -> "TriangleMesh":
        """Pad valid ``(V, 3)`` vertices and ``(F, 3)`` faces that already
        lie on a device, with no host round trip (the faces are trusted to
        index the vertices)."""
        dev = vertices.device
        nv, nf = vertices.shape[0], faces.shape[0]
        vc, fc = padding.pad_capacity(nv), padding.pad_capacity(nf)
        v = torch.zeros((vc, 3), dtype=torch.float32, device=dev)
        f = torch.zeros((fc, 3), dtype=torch.int32, device=dev)
        v[:nv] = vertices
        f[:nf] = faces
        vm = torch.arange(vc, device=dev) < nv
        fm = torch.arange(fc, device=dev) < nf
        return cls(v, f, vm, fm, {})

    @classmethod
    def empty(cls, vertex_capacity: int = padding.LANE, face_capacity: int = padding.LANE,
              device="cuda") -> "TriangleMesh":
        return cls(torch.zeros((vertex_capacity, 3), dtype=torch.float32, device=device),
                   torch.zeros((face_capacity, 3), dtype=torch.int32, device=device),
                   torch.zeros((vertex_capacity,), dtype=torch.bool, device=device),
                   torch.zeros((face_capacity,), dtype=torch.bool, device=device), {})

    # -- info -------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def vertex_capacity(self) -> int:
        return self.vertices.shape[0]

    @property
    def face_capacity(self) -> int:
        return self.faces.shape[0]

    def vertex_count(self) -> torch.Tensor:
        return self.vertex_mask.sum().to(torch.int32)

    def face_count(self) -> torch.Tensor:
        return self.face_mask.sum().to(torch.int32)

    def is_empty(self) -> torch.Tensor:
        return ~self.vertex_mask.any()

    @property
    def normals(self) -> Optional[torch.Tensor]:
        return self.attrs.get("normals")

    @property
    def colors(self) -> Optional[torch.Tensor]:
        return self.attrs.get("colors")

    # -- ops ----------------------------------------------------------------
    def triangles(self) -> torch.Tensor:
        """Face corner positions: ``(FC, 3, 3)``."""
        return self.vertices[self.faces]

    def _face_cross(self) -> torch.Tensor:
        tri = self.triangles()
        return _cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])

    def face_normals(self, normalize: bool = True) -> torch.Tensor:
        """Per-face normals by the cross product; invalid faces give zeros."""
        n = self._face_cross()
        if normalize:
            n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-30)
        return torch.where(self.face_mask[:, None], n, 0.0)

    def face_areas(self) -> torch.Tensor:
        n = self._face_cross()
        return torch.where(self.face_mask, 0.5 * torch.linalg.vector_norm(n, dim=-1), 0.0)

    def compute_vertex_normals(self) -> "TriangleMesh":
        """Area-weighted vertex normals: each face's cross product added to
        its three corners (``index_add_``, in face order, corner by corner),
        then normalised."""
        fn = torch.where(self.face_mask[:, None], self._face_cross(), 0.0)
        acc = torch.zeros_like(self.vertices)
        for c in range(3):
            acc.index_add_(0, self.faces[:, c], fn)
        acc = acc / torch.clamp_min(torch.linalg.vector_norm(acc, dim=-1, keepdim=True), 1e-30)
        return self.with_attr("normals", torch.where(self.vertex_mask[:, None], acc, 0.0))

    def with_attr(self, key: str, value: torch.Tensor) -> "TriangleMesh":
        return TriangleMesh(self.vertices, self.faces, self.vertex_mask, self.face_mask,
                            {**self.attrs, key: value})

    def with_vertices(self, vertices: torch.Tensor) -> "TriangleMesh":
        return TriangleMesh(vertices, self.faces, self.vertex_mask, self.face_mask,
                            self.attrs)

    def _vertex_field(self, key: str, value) -> "TriangleMesh":
        value = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        if value.shape != self.vertices.shape:
            raise InvalidDataError(
                f"{key} shape {tuple(value.shape)} != vertices {tuple(self.vertices.shape)}")
        return self.with_attr(key, value)

    def set_normals(self, normals) -> "TriangleMesh":
        return self._vertex_field("normals", normals)

    def set_colors(self, colors) -> "TriangleMesh":
        return self._vertex_field("colors", colors)

    def transform(self, t: Transform) -> "TriangleMesh":
        """Apply a rigid transform (its matrix moved to the mesh's device);
        normals, where present, rotate with it."""
        t = Transform(t.matrix.to(self.device))
        attrs = dict(self.attrs)
        if "normals" in attrs:
            attrs["normals"] = t.apply_vector(attrs["normals"])
        return TriangleMesh(t.apply(self.vertices), self.faces, self.vertex_mask,
                            self.face_mask, attrs)

    def bounding_box(self):
        return padding.bounding_box(self.vertices, self.vertex_mask)

    def center(self) -> torch.Tensor:
        mn, mx = self.bounding_box()
        return (mn + mx) * 0.5

    # -- host interop -----------------------------------------------------
    def to_numpy(self):
        """(vertices, faces) host arrays with padding removed and faces
        reindexed."""
        vm = self.vertex_mask.cpu().numpy()
        fm = self.face_mask.cpu().numpy()
        v = self.vertices.cpu().numpy()[vm]
        remap = np.cumsum(vm) - 1  # old index -> new index
        f = remap[self.faces.cpu().numpy()[fm]].astype(np.int32)
        return v, f

    def attr_to_numpy(self, key: str) -> np.ndarray:
        return self.attrs[key][self.vertex_mask].cpu().numpy()

    def as_point_cloud(self):
        from .point_cloud import PointCloud
        return PointCloud(self.vertices, self.vertex_mask, dict(self.attrs))
