"""PCD v0.7 reader/writer (ASCII, binary, and binary_compressed via the native LZF codec).

Counterpart of ``threecrate_tpu.io.pcd``, the same host NumPy code;
the reader returns a cloud on ``device`` (the card unless the caller
asks for the CPU).
Covers the reference's PCD surface (threecrate-io/src/pcd.rs:20-95):
header parse (FIELDS/SIZE/TYPE/COUNT/WIDTH/HEIGHT/VIEWPOINT/POINTS/DATA),
ASCII + binary decode, rgb packed-float handling, writer in both modes.
Binary decode is one structured ``np.frombuffer``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.point_cloud import PointCloud

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


@dataclasses.dataclass
class PcdHeader:
    fields: List[str]
    sizes: List[int]
    types: List[str]
    counts: List[int]
    width: int
    height: int
    points: int
    data: str            # "ascii" | "binary" | "binary_compressed"
    viewpoint: List[float]
    header_len: int


def parse_header(data: bytes) -> PcdHeader:
    lines = []
    pos = 0
    fields = sizes = types = counts = None
    width = height = points = None
    mode = None
    viewpoint = [0, 0, 0, 1, 0, 0, 0]
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            break
        line = data[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if line.startswith("#") or not line:
            continue
        tok = line.split()
        key = tok[0].upper()
        if key == "FIELDS":
            fields = tok[1:]
        elif key == "SIZE":
            sizes = [int(t) for t in tok[1:]]
        elif key == "TYPE":
            types = tok[1:]
        elif key == "COUNT":
            counts = [int(t) for t in tok[1:]]
        elif key == "WIDTH":
            width = int(tok[1])
        elif key == "HEIGHT":
            height = int(tok[1])
        elif key == "VIEWPOINT":
            viewpoint = [float(t) for t in tok[1:]]
        elif key == "POINTS":
            points = int(tok[1])
        elif key == "DATA":
            mode = tok[1].lower()
            break
    if fields is None or sizes is None or types is None or mode is None:
        raise InvalidDataError("malformed PCD header")
    if counts is None:
        counts = [1] * len(fields)
    if points is None:
        points = (width or 0) * (height or 1)
    return PcdHeader(fields, sizes, types, counts, width or points,
                     height or 1, points, mode, viewpoint, pos)


def read_point_cloud(path, device="cuda", **_) -> PointCloud:
    with open(path, "rb") as f:
        data = f.read()
    h = parse_header(data)
    cols: Dict[str, np.ndarray] = {}
    if h.data == "binary_compressed":
        # LZF-compressed field-major payload (PCL pcd_io): u32
        # compressed size, u32 uncompressed size, LZF stream; the
        # uncompressed bytes hold ALL x values, then all y, ... —
        # structure-of-arrays, unlike row-major plain binary.
        # (The reference rejects this mode, pcd.rs:426 — here the
        # native LZF codec in native/tc_native.cpp reads it.)
        from ..native import lzf_decompress
        hdr = data[h.header_len:h.header_len + 8]
        if len(hdr) < 8:
            raise InvalidDataError("PCD binary_compressed truncated")
        comp_size, uncomp_size = np.frombuffer(hdr, "<u4", 2)
        payload = data[h.header_len + 8:h.header_len + 8 + int(comp_size)]
        if len(payload) < int(comp_size):
            raise InvalidDataError("PCD binary_compressed truncated")
        try:
            raw = lzf_decompress(bytes(payload), int(uncomp_size))
        except ValueError as e:
            raise InvalidDataError(f"PCD LZF payload: {e}") from None
        if len(raw) != int(uncomp_size):
            raise InvalidDataError("PCD LZF payload: size mismatch")
        off = 0
        for name, size, typ, cnt in zip(h.fields, h.sizes, h.types,
                                        h.counts):
            code = _TYPE_MAP.get((typ.upper(), size))
            if code is None:
                raise InvalidDataError(f"PCD: unsupported field {typ}{size}")
            nbytes = size * cnt * h.points
            block = np.frombuffer(raw, "<" + code,
                                  h.points * cnt, off)
            cols[name] = block if cnt == 1 else block.reshape(
                h.points, cnt)
            off += nbytes
    elif h.data == "binary":
        dt_fields = []
        for name, size, typ, cnt in zip(h.fields, h.sizes, h.types, h.counts):
            code = _TYPE_MAP.get((typ.upper(), size))
            if code is None:
                raise InvalidDataError(f"PCD: unsupported field {typ}{size}")
            dt_fields.append((name, "<" + code, (cnt,)) if cnt > 1
                             else (name, "<" + code))
        dt = np.dtype(dt_fields)
        rec = np.frombuffer(data, dt, h.points, h.header_len)
        for name in h.fields:
            cols[name] = rec[name]
    else:  # ascii
        text = data[h.header_len:].decode("ascii", errors="replace")
        flat = np.array(text.split(), np.float64)
        ncol = sum(h.counts)
        if flat.size < h.points * ncol:
            raise InvalidDataError("PCD ascii truncated")
        table = flat[:h.points * ncol].reshape(h.points, ncol)
        j = 0
        for name, cnt in zip(h.fields, h.counts):
            cols[name] = table[:, j] if cnt == 1 else table[:, j:j + cnt]
            j += cnt

    for c in ("x", "y", "z"):
        if c not in cols:
            raise InvalidDataError(f"PCD missing field {c!r}")
    pts = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    attrs = {}
    if all(c in cols for c in ("normal_x", "normal_y", "normal_z")):
        attrs["normals"] = np.stack(
            [cols["normal_x"], cols["normal_y"], cols["normal_z"]],
            -1).astype(np.float32)
    if "rgb" in cols:
        rgb = cols["rgb"]
        packed = (rgb.view(np.uint32) if rgb.dtype == np.float32
                  else rgb.astype(np.float32).view(np.uint32))
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        attrs["colors"] = np.stack([r, g, b], -1).astype(np.float32) / 255.0
    if "intensity" in cols:
        attrs["intensity"] = cols["intensity"].astype(np.float32)
    finite = np.isfinite(pts).all(1)
    if not finite.all():  # PCD NaN rows = invalid (organized clouds)
        pts = pts[finite]
        attrs = {k: v[finite] for k, v in attrs.items()}
    return PointCloud.from_numpy(pts, device=device, **attrs)


def write_point_cloud(path, cloud: PointCloud, binary: bool = True,
                      compressed: bool = False, **_) -> None:
    """Write PCD v0.7. ``compressed=True`` emits DATA binary_compressed
    (LZF over the field-major payload, PCL-compatible) — a mode the
    reference cannot write at all (pcd.rs:426)."""
    pts = cloud.to_numpy()
    fields, sizes, types, counts = ["x", "y", "z"], [4, 4, 4], ["F"] * 3, [1] * 3
    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if "normals" in cloud.attrs:
        n = cloud.attr_to_numpy("normals")
        fields += ["normal_x", "normal_y", "normal_z"]
        sizes += [4, 4, 4]; types += ["F"] * 3; counts += [1] * 3
        cols += [n[:, 0], n[:, 1], n[:, 2]]
    if "colors" in cloud.attrs:
        c = np.clip(cloud.attr_to_numpy("colors") * 255 + 0.5, 0, 255
                    ).astype(np.uint32)
        packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        fields += ["rgb"]; sizes += [4]; types += ["F"]; counts += [1]
        cols += [packed.view(np.float32)]
    if "intensity" in cloud.attrs:
        fields += ["intensity"]; sizes += [4]; types += ["F"]; counts += [1]
        cols += [cloud.attr_to_numpy("intensity")]
    n_pts = pts.shape[0]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(map(str, sizes)),
        "TYPE " + " ".join(types),
        "COUNT " + " ".join(map(str, counts)),
        f"WIDTH {n_pts}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n_pts}",
        "DATA " + ("binary_compressed" if compressed
                   else "binary" if binary else "ascii"),
        ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            from ..native import lzf_compress
            soa = b"".join(
                (col.astype(np.float32) if col.dtype != np.float32
                 else col).tobytes() for col in cols)
            comp = lzf_compress(soa)
            f.write(np.asarray([len(comp), len(soa)],
                               "<u4").tobytes())
            f.write(comp)
        elif binary:
            rec = np.zeros(n_pts, np.dtype([(nm, "<f4") for nm in fields]))
            for nm, col in zip(fields, cols):
                rec[nm] = col.astype(np.float32) if col.dtype != np.float32 else col
            f.write(rec.tobytes())
        else:
            mat = np.stack([c.astype(np.float64) for c in cols], -1)
            body = "\n".join(" ".join(f"{v:.8g}" for v in row) for row in mat)
            f.write((body + "\n").encode("ascii"))
