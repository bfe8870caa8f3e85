"""PLY reader/writer: ASCII + binary LE/BE, arbitrary property schemas.

Counterpart of ``threecrate_tpu.io.ply``, the same host NumPy code;
readers return clouds and meshes on ``device`` (the card unless the
caller asks for the CPU), writers read through ``to_numpy()``.
Covers the reference's PLY surface (threecrate-io/src/ply.rs): header
parsing with arbitrary element/property schemas including lists,
ASCII and both binary byte orders, cloud + mesh read/write, write
options (comments, extra properties), and chunked streaming reads
(ply.rs:1563-1597). Implementation is vectorised NumPy — binary
elements with fixed-size properties decode as one ``np.frombuffer``
with a structured dtype (the moral equivalent of the reference's mmap
fast path, ply.rs:11-12), and uniform-length face lists decode as a
single strided view rather than a per-face loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.errors import InvalidDataError, IoError
from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PlyProperty:
    name: str
    dtype: str                       # numpy typecode, e.g. "f4"
    is_list: bool = False
    count_dtype: str = "u1"          # list-count typecode


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    properties: List[PlyProperty] = dataclasses.field(default_factory=list)

    @property
    def has_lists(self) -> bool:
        return any(p.is_list for p in self.properties)


@dataclasses.dataclass
class PlyHeader:
    fmt: str                         # "ascii" | "binary_little_endian" | "binary_big_endian"
    elements: List[PlyElement]
    comments: List[str]
    header_len: int                  # bytes up to and including end_header newline

    @property
    def byte_order(self) -> str:
        return ">" if self.fmt == "binary_big_endian" else "<"


def parse_header(data: bytes) -> PlyHeader:
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise InvalidDataError("not a PLY file (missing ply/end_header)")
    nl = data.find(b"\n", end)
    header_len = nl + 1
    text = data[:end].decode("ascii", errors="replace")
    fmt = None
    elements: List[PlyElement] = []
    comments: List[str] = []
    for line in text.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment":
            comments.append(line.strip()[8:])
        elif tok[0] == "element":
            elements.append(PlyElement(tok[1], int(tok[2])))
        elif tok[0] == "property":
            if not elements:
                raise InvalidDataError("property before element in PLY header")
            if tok[1] == "list":
                if tok[2] not in _TYPES or tok[3] not in _TYPES:
                    raise InvalidDataError(f"unknown PLY list types in {line!r}")
                elements[-1].properties.append(
                    PlyProperty(tok[4], _TYPES[tok[3]], True, _TYPES[tok[2]]))
            else:
                if tok[1] not in _TYPES:
                    raise InvalidDataError(f"unknown PLY type {tok[1]!r}")
                elements[-1].properties.append(PlyProperty(tok[2], _TYPES[tok[1]]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise InvalidDataError(f"unsupported PLY format {fmt!r}")
    return PlyHeader(fmt, elements, comments, header_len)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _fixed_dtype(elem: PlyElement, order: str) -> np.dtype:
    return np.dtype([(p.name, order + p.dtype) for p in elem.properties])


def _decode_binary(data: bytes, offset: int, header: PlyHeader
                   ) -> Tuple[Dict[str, Dict[str, np.ndarray]], int]:
    """Decode all elements; returns {element: {property: array}} and end offset.

    List properties come back as ``(count_array, flat_values, row_starts)``
    folded into "<name>__counts"/"<name>__flat" keys when ragged, or a
    (n, L) 2-D array when every row has the same length (the triangle
    fast path).
    """
    order = header.byte_order
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for elem in header.elements:
        res: Dict[str, np.ndarray] = {}
        if not elem.has_lists:
            dt = _fixed_dtype(elem, order)
            end = offset + dt.itemsize * elem.count
            if end > len(data):
                raise InvalidDataError(
                    f"PLY element {elem.name}: file truncated")
            rec = np.frombuffer(data, dtype=dt, count=elem.count, offset=offset)
            for p in elem.properties:
                res[p.name] = rec[p.name]
            offset = end
        elif len(elem.properties) == 1 and elem.properties[0].is_list:
            # single list property (the face element): try uniform-count
            # fast path — peek first count, verify via strided view
            p = elem.properties[0]
            cdt = np.dtype(order + p.count_dtype)
            vdt = np.dtype(order + p.dtype)
            if elem.count == 0:
                res[p.name] = np.zeros((0, 3), np.int32)
            else:
                first = int(np.frombuffer(data, cdt, 1, offset)[0])
                row_bytes = cdt.itemsize + first * vdt.itemsize
                end = offset + row_bytes * elem.count
                uniform = False
                if end <= len(data):
                    counts = np.frombuffer(
                        data[offset:end], np.uint8).reshape(elem.count, row_bytes)
                    cview = counts[:, :cdt.itemsize].copy().view(cdt).ravel()
                    uniform = bool((cview == first).all())
                if uniform:
                    rows = np.frombuffer(
                        data[offset:end], np.uint8).reshape(elem.count, row_bytes)
                    vals = rows[:, cdt.itemsize:].copy().view(vdt)
                    res[p.name] = vals.reshape(elem.count, first)
                    offset = end
                else:  # ragged: per-row scan (rare)
                    lists = []
                    pos = offset
                    for _ in range(elem.count):
                        c = int(np.frombuffer(data, cdt, 1, pos)[0])
                        pos += cdt.itemsize
                        lists.append(np.frombuffer(data, vdt, c, pos))
                        pos += c * vdt.itemsize
                    res[p.name + "__ragged"] = lists
                    offset = pos
        else:
            # mixed scalar+list rows: per-row scan (rare schema)
            pos = offset
            cols: Dict[str, list] = {p.name: [] for p in elem.properties}
            for _ in range(elem.count):
                for p in elem.properties:
                    if p.is_list:
                        cdt = np.dtype(order + p.count_dtype)
                        c = int(np.frombuffer(data, cdt, 1, pos)[0])
                        pos += cdt.itemsize
                        vdt = np.dtype(order + p.dtype)
                        cols[p.name].append(np.frombuffer(data, vdt, c, pos))
                        pos += c * vdt.itemsize
                    else:
                        vdt = np.dtype(order + p.dtype)
                        cols[p.name].append(np.frombuffer(data, vdt, 1, pos)[0])
                        pos += vdt.itemsize
            for p in elem.properties:
                res[p.name + ("__ragged" if p.is_list else "")] = (
                    cols[p.name] if p.is_list else np.array(cols[p.name]))
            offset = pos
        out[elem.name] = res
    return out, offset


def _decode_ascii(data: bytes, header: PlyHeader
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    text = data[header.header_len:].decode("ascii", errors="replace")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    out: Dict[str, Dict[str, np.ndarray]] = {}
    pos = 0
    for elem in header.elements:
        chunk = lines[pos:pos + elem.count]
        if len(chunk) < elem.count:
            raise InvalidDataError(f"PLY element {elem.name}: file truncated")
        pos += elem.count
        res: Dict[str, np.ndarray] = {}
        if not elem.has_lists:
            from ..native import parse_floats
            flat = parse_floats("\n".join(chunk))
            ncol = len(elem.properties)
            if flat.size != elem.count * ncol:
                raise InvalidDataError(
                    f"PLY ascii element {elem.name}: token count mismatch")
            table = flat.reshape(elem.count, ncol)
            for j, p in enumerate(elem.properties):
                res[p.name] = table[:, j].astype(np.dtype(p.dtype))
        elif len(elem.properties) == 1 and elem.properties[0].is_list:
            p = elem.properties[0]
            rows = [np.array(ln.split(), dtype=np.float64) for ln in chunk]
            counts = np.array([int(r[0]) for r in rows])
            if elem.count and (counts == counts[0]).all():
                vals = np.stack([r[1:] for r in rows]).astype(np.dtype(p.dtype))
                res[p.name] = vals
            else:
                res[p.name + "__ragged"] = [
                    r[1:].astype(np.dtype(p.dtype)) for r in rows]
        else:
            colvals: Dict[str, list] = {p.name: [] for p in elem.properties}
            for ln in chunk:
                toks = ln.split()
                i = 0
                for p in elem.properties:
                    if p.is_list:
                        c = int(float(toks[i])); i += 1
                        colvals[p.name].append(
                            np.array(toks[i:i + c], np.float64
                                     ).astype(np.dtype(p.dtype)))
                        i += c
                    else:
                        colvals[p.name].append(
                            np.dtype(p.dtype).type(float(toks[i]))); i += 1
            for p in elem.properties:
                res[p.name + ("__ragged" if p.is_list else "")] = (
                    colvals[p.name] if p.is_list
                    else np.array(colvals[p.name]))
        out[elem.name] = res
    return out


def read_ply_raw(path) -> Dict[str, Dict[str, np.ndarray]]:
    """Full-schema read: {element: {property: array}}.

    Binary files above 64 KiB decode through a memory map (the
    reference's io-mmap fast path, mmap.rs:14-60): structured
    ``frombuffer`` views over the mapping avoid the read() copy.
    """
    from .mmap import MMAP_THRESHOLD, MmapReader
    import os
    if os.path.getsize(path) >= MMAP_THRESHOLD:
        with MmapReader(path) as mm:
            data = bytes(mm.data()[:65536])
            header = parse_header(data)
            if header.fmt != "ascii":
                decoded, _ = _decode_binary(mm.data(), header.header_len,
                                            header)
                # materialise copies before the mapping closes (ragged
                # list properties are python lists of views)
                out = {}
                for elem, props in decoded.items():
                    out[elem] = {
                        k: (np.array(v) if isinstance(v, np.ndarray)
                            else [np.array(x) for x in v])
                        for k, v in props.items()}
                return out
    with open(path, "rb") as f:
        data = f.read()
    header = parse_header(data)
    if header.fmt == "ascii":
        return _decode_ascii(data, header)
    decoded, _ = _decode_binary(data, header.header_len, header)
    return decoded


def _vertex_attrs(vert: Dict[str, np.ndarray]):
    """Extract (points, attrs) from a decoded vertex element."""
    for c in ("x", "y", "z"):
        if c not in vert:
            raise InvalidDataError(f"PLY vertex element missing {c!r}")
    pts = np.stack([vert["x"], vert["y"], vert["z"]], -1).astype(np.float32)
    attrs = {}
    if all(c in vert for c in ("nx", "ny", "nz")):
        attrs["normals"] = np.stack(
            [vert["nx"], vert["ny"], vert["nz"]], -1).astype(np.float32)
    if all(c in vert for c in ("red", "green", "blue")):
        cols = np.stack([vert["red"], vert["green"], vert["blue"]], -1)
        if cols.dtype.kind in "ui":
            cols = cols.astype(np.float32) / 255.0
        attrs["colors"] = cols.astype(np.float32)
    if "intensity" in vert:
        attrs["intensity"] = vert["intensity"].astype(np.float32)
    return pts, attrs


def read_point_cloud(path, device="cuda", **_) -> PointCloud:
    decoded = read_ply_raw(path)
    if "vertex" not in decoded:
        raise InvalidDataError("PLY file has no vertex element")
    pts, attrs = _vertex_attrs(decoded["vertex"])
    return PointCloud.from_numpy(pts, device=device, **attrs)


def _face_array(decoded) -> np.ndarray:
    for name in ("face", "faces"):
        if name in decoded:
            fe = decoded[name]
            for key in ("vertex_indices", "vertex_index"):
                if key in fe:
                    f = fe[key]
                    if f.shape[1] != 3:
                        # fan-triangulate uniform polygons
                        tris = [f[:, [0, i, i + 1]] for i in range(1, f.shape[1] - 1)]
                        f = np.concatenate(tris, 0)
                    return f.astype(np.int32)
                if key + "__ragged" in fe:
                    tris = []
                    for poly in fe[key + "__ragged"]:
                        poly = poly.astype(np.int64)
                        for i in range(1, len(poly) - 1):
                            tris.append([poly[0], poly[i], poly[i + 1]])
                    return np.array(tris or np.zeros((0, 3)), np.int32)
    return np.zeros((0, 3), np.int32)


def read_mesh(path, device="cuda", **_) -> TriangleMesh:
    decoded = read_ply_raw(path)
    if "vertex" not in decoded:
        raise InvalidDataError("PLY file has no vertex element")
    pts, attrs = _vertex_attrs(decoded["vertex"])
    faces = _face_array(decoded)
    return TriangleMesh.from_numpy(pts, faces,
                                   normals=attrs.get("normals"),
                                   colors=attrs.get("colors"), device=device)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlyWriteOptions:
    """Mirrors PlyWriteOptions (ply.rs:94-193)."""

    binary: bool = True
    comments: Sequence[str] = ()
    extra_properties: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


def _build_vertex_block(pts, attrs, extra):
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    names = ["x", "y", "z"]
    if "normals" in attrs:
        n = attrs["normals"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        cols += [n[:, 0], n[:, 1], n[:, 2]]
        names += ["nx", "ny", "nz"]
    if "colors" in attrs:
        c = np.clip(attrs["colors"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [c[:, 0], c[:, 1], c[:, 2]]
        names += ["red", "green", "blue"]
    if "intensity" in attrs:
        fields += [("intensity", "<f4")]
        cols += [attrs["intensity"]]
        names += ["intensity"]
    for k, v in extra.items():
        v = np.asarray(v)
        fields += [(k, "<" + v.dtype.str[1:])]
        cols += [v]
        names += [k]
    rec = np.zeros(pts.shape[0], dtype=np.dtype(fields))
    for (name, _), col in zip(fields, cols):
        rec[name] = col
    type_names = {"f4": "float", "f8": "double", "u1": "uchar", "u2": "ushort",
                  "u4": "uint", "i1": "char", "i2": "short", "i4": "int"}
    props = [f"property {type_names[np.dtype(t).str[1:]]} {n}"
             for n, t in fields]
    return rec, props


def _write_ply(path, pts, attrs, faces, opts: PlyWriteOptions):
    rec, props = _build_vertex_block(pts, attrs, dict(opts.extra_properties))
    fmt = "binary_little_endian" if opts.binary else "ascii"
    lines = ["ply", f"format {fmt} 1.0",
             "comment written by threecrate-tpu"]
    lines += [f"comment {c}" for c in opts.comments]
    lines += [f"element vertex {pts.shape[0]}"] + props
    if faces is not None:
        lines += [f"element face {faces.shape[0]}",
                  "property list uchar int vertex_indices"]
    lines += ["end_header", ""]
    header = "\n".join(lines).encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        if opts.binary:
            f.write(rec.tobytes())
            if faces is not None:
                fr = np.zeros(faces.shape[0],
                              dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
                fr["n"] = 3
                fr["v"] = faces
                f.write(fr.tobytes())
        else:
            cols = [rec[name] for name in rec.dtype.names]
            mat = np.stack([c.astype(np.float64) for c in cols], -1)
            out = []
            int_col = [rec.dtype[name].kind in "ui" for name in rec.dtype.names]
            for row in mat:
                out.append(" ".join(
                    str(int(v)) if is_int else f"{v:.8g}"
                    for v, is_int in zip(row, int_col)))
            f.write(("\n".join(out) + "\n").encode("ascii"))
            if faces is not None and faces.shape[0]:
                f.write(("\n".join(
                    f"3 {a} {b} {c}" for a, b, c in faces) + "\n").encode())


def write_point_cloud(path, cloud: PointCloud,
                      options: Optional[PlyWriteOptions] = None, **kw) -> None:
    opts = options or PlyWriteOptions(**kw) if (options or kw) else PlyWriteOptions()
    pts = cloud.to_numpy()
    attrs = {k: cloud.attr_to_numpy(k) for k in cloud.attrs}
    _write_ply(path, pts, attrs, None, opts)


def write_mesh(path, mesh: TriangleMesh,
               options: Optional[PlyWriteOptions] = None, **kw) -> None:
    opts = options or PlyWriteOptions(**kw) if (options or kw) else PlyWriteOptions()
    v, f = mesh.to_numpy()
    attrs = {k: mesh.attr_to_numpy(k) for k in mesh.attrs}
    _write_ply(path, v, attrs, f, opts)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def read_point_cloud_stream(path, chunk_size: int = 65536, **_
                            ) -> Iterator[np.ndarray]:
    """Chunked vertex streaming (PlyStreamingReader, ply.rs:1563-1597).

    Binary fixed-schema files stream straight off disk; ascii falls back
    to a full parse sliced into chunks.
    """
    with open(path, "rb") as f:
        head = f.read(65536)
        header = parse_header(head)
        vertex = next((e for e in header.elements if e.name == "vertex"), None)
        if vertex is None:
            raise InvalidDataError("PLY file has no vertex element")
        if header.fmt == "ascii" or vertex.has_lists \
                or header.elements[0].name != "vertex":
            cloud = read_point_cloud(path, device="cpu")
            pts = cloud.to_numpy()
            for i in range(0, len(pts), chunk_size):
                yield pts[i:i + chunk_size]
            return
        dt = _fixed_dtype(vertex, header.byte_order)
        f.seek(header.header_len)
        remaining = vertex.count
        while remaining > 0:
            n = min(chunk_size, remaining)
            buf = f.read(n * dt.itemsize)
            if len(buf) < n * dt.itemsize:
                raise IoError("PLY stream truncated")
            rec = np.frombuffer(buf, dtype=dt)
            yield np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
            remaining -= n


def read_mesh_stream(path, chunk_size: int = 65536, **_):
    """Chunked streaming mesh read (PlyMeshStreamingReader,
    ply.rs:1751-1900, improved: the reference streams ASCII faces one
    at a time and buffers every vertex; this yields host chunks of
    BOTH vertices and faces straight off disk for binary files).

    Yields ``MeshChunk(vertices=(n,3) f32)`` chunks for the vertex
    element, then ``MeshChunk(faces=(m,3) i32)`` chunks for the face
    element. Binary fixed-schema vertex blocks and constant-arity
    (triangle) face lists stream without materialising the file;
    ascii or exotic layouts fall back to a full parse sliced into
    chunks. Non-triangular faces in the streaming path raise (the
    reference errors likewise); use ``read_mesh`` for polygon fans.
    """
    from .registry import MeshChunk

    with open(path, "rb") as f:
        head = f.read(65536)
        header = parse_header(head)
        names = [e.name for e in header.elements]
        vertex = next((e for e in header.elements if e.name == "vertex"),
                      None)
        face = next((e for e in header.elements
                     if e.name in ("face", "faces")), None)
        if vertex is None:
            raise InvalidDataError("PLY file has no vertex element")
        streamable = (
            header.fmt != "ascii" and not vertex.has_lists
            and names[:1] == ["vertex"]
            and (face is None or (
                names[1:2] == [face.name]
                and len(face.properties) == 1
                and face.properties[0].is_list
                and face.properties[0].name in ("vertex_indices",
                                                "vertex_index"))))
        if not streamable:
            mesh = read_mesh(path, device="cpu")
            v, fc = mesh.to_numpy()
            for i in range(0, len(v), chunk_size):
                yield MeshChunk(vertices=v[i:i + chunk_size])
            for i in range(0, len(fc), chunk_size):
                yield MeshChunk(faces=fc[i:i + chunk_size])
            return

        order = header.byte_order
        dt = _fixed_dtype(vertex, order)
        f.seek(header.header_len)
        remaining = vertex.count
        while remaining > 0:
            n = min(chunk_size, remaining)
            buf = f.read(n * dt.itemsize)
            if len(buf) < n * dt.itemsize:
                raise IoError("PLY stream truncated (vertices)")
            rec = np.frombuffer(buf, dtype=dt)
            yield MeshChunk(vertices=np.stack(
                [rec["x"], rec["y"], rec["z"]], -1).astype(np.float32))
            remaining -= n

        if face is None:
            return
        prop = face.properties[0]
        cnt_dt = np.dtype(order + prop.count_dtype)
        idx_dt = np.dtype(order + prop.dtype)
        # constant-arity fast path: a triangle record is count + 3
        # indices; verified per chunk (mixed-arity files raise)
        rec_dt = np.dtype([("n", cnt_dt), ("idx", idx_dt, (3,))])
        remaining = face.count
        while remaining > 0:
            n = min(chunk_size, remaining)
            buf = f.read(n * rec_dt.itemsize)
            if len(buf) < n * rec_dt.itemsize:
                raise IoError("PLY stream truncated (faces)")
            rec = np.frombuffer(buf, dtype=rec_dt)
            if not (rec["n"] == 3).all():
                raise InvalidDataError(
                    "streaming mesh read supports triangular faces "
                    "only; use read_mesh() for polygon files")
            yield MeshChunk(faces=rec["idx"].astype(np.int32))
            remaining -= n
