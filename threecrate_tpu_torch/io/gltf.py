"""glTF 2.0 / GLB mesh export (engine interop).

Counterpart of ``threecrate_tpu.io.gltf``, the same host NumPy code;
the reader returns a mesh on ``device`` (the card unless the caller
asks for the CPU).
Plays the role of the reference's bevy_interop feature
(threecrate-core/src/bevy_interop.rs:32,102 — attribute conversion into
a game-engine mesh): a self-contained binary-glTF writer emitting
POSITION / NORMAL / COLOR_0 attributes + indices, loadable by Bevy,
three.js, Blender, and every other glTF consumer.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh

_COMP_F32 = 5126
_COMP_U32 = 5125


def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def write_mesh_glb(path, mesh: TriangleMesh) -> None:
    """Write a single-mesh .glb (binary glTF)."""
    v, f = mesh.to_numpy()
    if len(f) == 0:
        raise InvalidDataError("cannot export an empty mesh to glTF")
    blobs = []
    views = []
    accessors = []
    attributes = {}
    offset = 0

    def add_blob(data: bytes, target: Optional[int]) -> int:
        nonlocal offset
        data = _align4(data)
        views.append({"buffer": 0, "byteOffset": offset,
                      "byteLength": len(data),
                      **({"target": target} if target else {})})
        blobs.append(data)
        offset += len(data)
        return len(views) - 1

    pos = v.astype("<f4")
    vi = add_blob(pos.tobytes(), 34962)
    accessors.append({"bufferView": vi, "componentType": _COMP_F32,
                      "count": len(v), "type": "VEC3",
                      "min": pos.min(0).tolist(),
                      "max": pos.max(0).tolist()})
    attributes["POSITION"] = len(accessors) - 1

    if mesh.normals is not None:
        nrm = mesh.attr_to_numpy("normals").astype("<f4")
        ni = add_blob(nrm.tobytes(), 34962)
        accessors.append({"bufferView": ni, "componentType": _COMP_F32,
                          "count": len(v), "type": "VEC3"})
        attributes["NORMAL"] = len(accessors) - 1
    if mesh.colors is not None:
        col = mesh.attr_to_numpy("colors").astype("<f4")
        ci = add_blob(col.tobytes(), 34962)
        accessors.append({"bufferView": ci, "componentType": _COMP_F32,
                          "count": len(v), "type": "VEC3"})
        attributes["COLOR_0"] = len(accessors) - 1

    idx = f.astype("<u4").ravel()
    ii = add_blob(idx.tobytes(), 34963)
    accessors.append({"bufferView": ii, "componentType": _COMP_U32,
                      "count": int(idx.size), "type": "SCALAR"})

    gltf = {
        "asset": {"version": "2.0", "generator": "threecrate-tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": attributes,
            "indices": len(accessors) - 1,
            "mode": 4}]}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": offset}],
    }
    json_chunk = _align4(json.dumps(gltf).encode("utf-8"), b" ")
    bin_chunk = b"".join(blobs)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sII", b"glTF", 2, total))
        fh.write(struct.pack("<I4s", len(json_chunk), b"JSON"))
        fh.write(json_chunk)
        fh.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        fh.write(bin_chunk)


def read_mesh_glb(path, device="cuda") -> TriangleMesh:
    """Read a .glb containing one triangle primitive (round-trip of our
    writer; partial support for foreign files)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"glTF":
        raise InvalidDataError("not a GLB file")
    json_len, = struct.unpack_from("<I", data, 12)
    gltf = json.loads(data[20:20 + json_len])
    bin_off = 20 + json_len + 8
    bin_chunk = data[bin_off:]

    def read_accessor(ai):
        acc = gltf["accessors"][ai]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        comp = {"VEC3": 3, "SCALAR": 1}[acc["type"]]
        dt = {_COMP_F32: "<f4", _COMP_U32: "<u4",
              5123: "<u2"}[acc["componentType"]]
        arr = np.frombuffer(bin_chunk, dt, acc["count"] * comp, start)
        return arr.reshape(acc["count"], comp) if comp > 1 else arr

    prim = gltf["meshes"][0]["primitives"][0]
    v = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
    f = read_accessor(prim["indices"]).astype(np.int32).reshape(-1, 3)
    normals = None
    colors = None
    if "NORMAL" in prim["attributes"]:
        normals = read_accessor(prim["attributes"]["NORMAL"]
                                ).astype(np.float32)
    if "COLOR_0" in prim["attributes"]:
        colors = read_accessor(prim["attributes"]["COLOR_0"]
                               ).astype(np.float32)
    return TriangleMesh.from_numpy(v, f, normals=normals, colors=colors,
                                   device=device)
