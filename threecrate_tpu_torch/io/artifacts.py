"""Artifact checkpointing: save/load framework objects losslessly.

Counterpart of ``threecrate_tpu.io.artifacts``, in the same ``.npz``
layout, so an artifact that either package saves loads into the other's
objects. The reference's checkpoint story is serde on every core type
(SURVEY §5: point_cloud.rs:122, mesh.rs:269 derive Serialize, bincode
ProgressiveMesh). Here every container round-trips through one
compressed ``.npz`` (masks, attrs and metadata included) — the resume
format for long pipelines (e.g. TSDF volumes mid-fusion). Loading puts
the tensors on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from ..ops.tsdf import TsdfVolume

_KIND_KEY = "__tc_kind__"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_artifact(path, obj) -> None:
    """Save a PointCloud / TriangleMesh / TsdfVolume to .npz."""
    if isinstance(obj, PointCloud):
        arrays = {"points": _host(obj.points),
                  "mask": _host(obj.mask)}
        for k, v in obj.attrs.items():
            arrays[f"attr_{k}"] = _host(v)
        kind = "point_cloud"
    elif isinstance(obj, TriangleMesh):
        arrays = {"vertices": _host(obj.vertices),
                  "faces": _host(obj.faces),
                  "vertex_mask": _host(obj.vertex_mask),
                  "face_mask": _host(obj.face_mask)}
        for k, v in obj.attrs.items():
            arrays[f"attr_{k}"] = _host(v)
        kind = "triangle_mesh"
    elif isinstance(obj, TsdfVolume):
        arrays = {"tsdf": _host(obj.tsdf),
                  "weight": _host(obj.weight),
                  "origin": _host(obj.origin),
                  "voxel_size": _host(obj.voxel_size),
                  "truncation": _host(obj.truncation)}
        if obj.color is not None:
            arrays["color"] = _host(obj.color)
        kind = "tsdf_volume"
    else:
        raise InvalidDataError(f"cannot checkpoint {type(obj).__name__}")
    arrays[_KIND_KEY] = np.asarray(kind)
    np.savez_compressed(path, **arrays)


def load_artifact(path, device="cuda"
                  ) -> Union[PointCloud, TriangleMesh, TsdfVolume]:
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    with np.load(path, allow_pickle=False) as z:
        if _KIND_KEY not in z:
            raise InvalidDataError("not a threecrate-tpu artifact")
        kind = str(z[_KIND_KEY])
        if kind == "point_cloud":
            attrs = {k[len("attr_"):]: put(z[k])
                     for k in z.files if k.startswith("attr_")}
            return PointCloud(put(z["points"]), put(z["mask"]), attrs)
        if kind == "triangle_mesh":
            attrs = {k[len("attr_"):]: put(z[k])
                     for k in z.files if k.startswith("attr_")}
            return TriangleMesh(put(z["vertices"]), put(z["faces"]),
                                put(z["vertex_mask"]), put(z["face_mask"]),
                                attrs)
        if kind == "tsdf_volume":
            return TsdfVolume(
                put(z["tsdf"]), put(z["weight"]),
                put(z["color"]) if "color" in z.files else None,
                put(z["origin"]), put(z["voxel_size"]),
                put(z["truncation"]))
        raise InvalidDataError(f"unknown artifact kind {kind!r}")
