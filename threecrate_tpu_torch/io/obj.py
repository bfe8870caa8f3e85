"""Wavefront OBJ (+MTL) reader/writer.

Counterpart of ``threecrate_tpu.io.obj``, the same host NumPy code;
readers return meshes and clouds on ``device`` (the card unless the
caller asks for the CPU).
Covers the reference's OBJ surface (threecrate-io/src/obj.rs:20-93):
v/vn/vt records, faces with v / v/vt / v//vn / v/vt/vn forms, polygon →
triangle-fan conversion, group + material bookkeeping, MTL parsing, and
write options. Parsing is line-class batched: all ``v`` lines decode in
one NumPy pass instead of per-line scanf.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud


@dataclasses.dataclass
class Material:
    """MTL material subset (obj.rs Material)."""

    name: str
    ambient: Optional[np.ndarray] = None    # Ka
    diffuse: Optional[np.ndarray] = None    # Kd
    specular: Optional[np.ndarray] = None   # Ks
    shininess: Optional[float] = None       # Ns
    diffuse_map: Optional[str] = None       # map_Kd


@dataclasses.dataclass
class ObjData:
    vertices: np.ndarray                     # (V, 3) f32
    faces: np.ndarray                        # (F, 3) i32 (triangulated)
    normals: Optional[np.ndarray] = None     # per-vertex, if resolvable
    uvs: Optional[np.ndarray] = None
    groups: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    materials: Dict[str, Material] = dataclasses.field(default_factory=dict)
    face_materials: Optional[List[str]] = None


def parse_mtl(path) -> Dict[str, Material]:
    mats: Dict[str, Material] = {}
    cur: Optional[Material] = None
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                tok = line.split()
                if not tok:
                    continue
                key = tok[0]
                if key == "newmtl":
                    cur = Material(tok[1])
                    mats[tok[1]] = cur
                elif cur is None:
                    continue
                elif key in ("Ka", "Kd", "Ks"):
                    vec = np.array(tok[1:4], np.float32)
                    setattr(cur, {"Ka": "ambient", "Kd": "diffuse",
                                  "Ks": "specular"}[key], vec)
                elif key == "Ns":
                    cur.shininess = float(tok[1])
                elif key == "map_Kd":
                    cur.diffuse_map = tok[1]
    except OSError:
        pass
    return mats


def _parse_face_token(t: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' → (v, vt, vn) 0-based or -1."""
    parts = t.split("/")
    v = int(parts[0])
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, vt, vn


def read_obj(path) -> ObjData:
    v_lines: List[str] = []
    vn_lines: List[str] = []
    vt_lines: List[str] = []
    face_rows: List[List[str]] = []
    face_group: List[str] = []
    face_mat: List[str] = []
    materials: Dict[str, Material] = {}
    group = "default"
    mat = ""
    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            tok = line.split()
            if not tok:
                continue
            k = tok[0]
            if k == "v":
                v_lines.append(" ".join(tok[1:4]))
            elif k == "vn":
                vn_lines.append(" ".join(tok[1:4]))
            elif k == "vt":
                vt_lines.append(" ".join(tok[1:3]))
            elif k == "f":
                face_rows.append(tok[1:])
                face_group.append(group)
                face_mat.append(mat)
            elif k in ("g", "o"):
                group = tok[1] if len(tok) > 1 else "default"
            elif k == "usemtl":
                mat = tok[1] if len(tok) > 1 else ""
            elif k == "mtllib" and len(tok) > 1:
                mtl_path = os.path.join(os.path.dirname(str(path)), tok[1])
                materials.update(parse_mtl(mtl_path))

    if not v_lines:
        raise InvalidDataError("OBJ file has no vertices")
    verts = np.array(" ".join(v_lines).split(), np.float32).reshape(-1, 3)
    vns = (np.array(" ".join(vn_lines).split(), np.float32).reshape(-1, 3)
           if vn_lines else None)
    vts = (np.array(" ".join(vt_lines).split(), np.float32).reshape(-1, 2)
           if vt_lines else None)

    tris: List[List[int]] = []
    tri_vns: List[List[int]] = []
    tri_group: List[str] = []
    tri_mat: List[str] = []
    nv = verts.shape[0]

    def resolve(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i  # negative = relative indexing

    for row, grp, m in zip(face_rows, face_group, face_mat):
        idx = [_parse_face_token(t) for t in row]
        vs = [resolve(i[0], nv) for i in idx]
        ns = [resolve(i[2], len(vns) if vns is not None else 0)
              if i[2] != 0 else -1 for i in idx]
        for i in range(1, len(vs) - 1):  # fan triangulation (obj.rs polygon fan)
            tris.append([vs[0], vs[i], vs[i + 1]])
            tri_vns.append([ns[0], ns[i], ns[i + 1]])
            tri_group.append(grp)
            tri_mat.append(m)

    faces = np.array(tris or np.zeros((0, 3)), np.int32)
    if faces.size and (faces.min() < 0 or faces.max() >= nv):
        raise InvalidDataError("OBJ face index out of range")

    # resolve per-vertex normals when the mapping is unambiguous
    normals = None
    if vns is not None and tris:
        normals = np.zeros((nv, 3), np.float32)
        counted = np.zeros(nv, np.int32)
        tv = faces.ravel()
        tn = np.array(tri_vns, np.int32).ravel()
        ok = tn >= 0
        np.add.at(normals, tv[ok], vns[tn[ok]])
        np.add.at(counted, tv[ok], 1)
        nz = counted > 0
        normals[nz] /= np.linalg.norm(normals[nz], axis=1, keepdims=True).clip(1e-30)
        if not nz.any():
            normals = None

    groups: Dict[str, np.ndarray] = {}
    tg = np.array(tri_group)
    for g in set(tri_group):
        groups[g] = np.nonzero(tg == g)[0].astype(np.int32)

    return ObjData(verts, faces, normals, vts, groups, materials,
                   tri_mat if any(tri_mat) else None)


def read_mesh(path, device="cuda", **_) -> TriangleMesh:
    data = read_obj(path)
    return TriangleMesh.from_numpy(data.vertices, data.faces,
                                   normals=data.normals, device=device)


def read_point_cloud(path, device="cuda", **_) -> PointCloud:
    data = read_obj(path)
    attrs = {}
    if data.normals is not None:
        attrs["normals"] = data.normals
    return PointCloud.from_numpy(data.vertices, device=device, **attrs)


@dataclasses.dataclass
class ObjWriteOptions:
    write_normals: bool = True
    precision: int = 6
    comment: str = "written by threecrate-tpu"


def write_mesh(path, mesh: TriangleMesh,
               options: Optional[ObjWriteOptions] = None, **_) -> None:
    opts = options or ObjWriteOptions()
    v, f = mesh.to_numpy()
    out = [f"# {opts.comment}"]
    p = opts.precision
    out += [f"v {x:.{p}g} {y:.{p}g} {z:.{p}g}" for x, y, z in v]
    n = mesh.attrs.get("normals")
    has_n = opts.write_normals and n is not None
    if has_n:
        nn = mesh.attr_to_numpy("normals")
        out += [f"vn {x:.{p}g} {y:.{p}g} {z:.{p}g}" for x, y, z in nn]
        out += [f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}" for a, b, c in f]
    else:
        out += [f"f {a+1} {b+1} {c+1}" for a, b, c in f]
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def write_point_cloud(path, cloud: PointCloud, **_) -> None:
    pts = cloud.to_numpy()
    with open(path, "w") as fh:
        fh.write("# written by threecrate-tpu\n")
        fh.write("\n".join(f"v {x:.6g} {y:.6g} {z:.6g}" for x, y, z in pts))
        fh.write("\n")


def read_mesh_stream(path, chunk_size: int = 65536, **_):
    """Chunked streaming OBJ mesh read (ObjMeshStreamingReader,
    threecrate-io/src/lib.rs:302): line-by-line single pass, yielding
    MeshChunk vertex/face host arrays as buffers fill — the whole mesh
    is never materialised. Polygon faces fan-triangulate inline;
    negative (relative) indices resolve against the running vertex
    count, so they work even before the full vertex list is known.
    """
    from .registry import MeshChunk

    v_buf: List[float] = []
    f_buf: List[int] = []
    nv = 0
    saw_vertex = False
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] in "#\n":
                continue
            tok = line.split()
            if not tok:
                continue
            k = tok[0]
            if k == "v":
                saw_vertex = True
                v_buf.extend(float(t) for t in tok[1:4])
                nv += 1
                if len(v_buf) >= 3 * chunk_size:
                    yield MeshChunk(vertices=np.array(
                        v_buf, np.float32).reshape(-1, 3))
                    v_buf = []
            elif k == "f":
                if v_buf:
                    yield MeshChunk(vertices=np.array(
                        v_buf, np.float32).reshape(-1, 3))
                    v_buf = []
                vs = [int(t.split("/")[0]) for t in tok[1:]]
                vs = [i - 1 if i > 0 else nv + i for i in vs]
                for i in range(1, len(vs) - 1):
                    f_buf.extend((vs[0], vs[i], vs[i + 1]))
                if len(f_buf) >= 3 * chunk_size:
                    yield MeshChunk(faces=np.array(
                        f_buf, np.int32).reshape(-1, 3))
                    f_buf = []
    if not saw_vertex:
        raise InvalidDataError("OBJ file has no vertices")
    if v_buf:
        yield MeshChunk(vertices=np.array(v_buf, np.float32).reshape(-1, 3))
    if f_buf:
        yield MeshChunk(faces=np.array(f_buf, np.int32).reshape(-1, 3))
