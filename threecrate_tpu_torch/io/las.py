"""LAS/LAZ LiDAR file reader/writer (LAS 1.2-1.4, point formats 0-3, 6-10).

Counterpart of ``threecrate_tpu.io.las``, the same host NumPy code; the
reader returns a cloud on ``device`` (the card unless the caller asks
for the CPU).
Covers the reference's ``las_laz`` feature (threecrate-io Cargo
feature, backed there by pasture/laz-rs; threecrate-io/Cargo.toml:14).
Uncompressed LAS decodes as one structured ``np.frombuffer`` with the
header's scale/offset applied. LAZ (compressed LAS) is handled by the
native LASzip codec in ``threecrate_tpu_torch.native`` (tc_laz.cpp):
compressor 2 ("pointwise chunked"), point formats 0-3, decoded with
one thread per chunk. Compressed point formats 6+ use the layered
LASzip 3 codec, which is not implemented — those raise a clear
UnsupportedError, as does running without a C++ toolchain.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..core.errors import InvalidDataError, UnsupportedError
from ..core.point_cloud import PointCloud

_POINT_FORMATS = {
    0: 20, 1: 28, 2: 26, 3: 34, 6: 30, 7: 36, 8: 38, 9: 59, 10: 67,
}
_RGB_OFFSET = {2: 20, 3: 28, 7: 30, 8: 30, 10: 30}  # RGB triple offset
_GPS_OFFSET = {1: 20, 3: 20, 6: 22, 7: 22, 8: 22, 9: 22, 10: 22}
_NIR_OFFSET = {8: 36, 10: 36}
_INTENSITY_OFFSET = 12

_LASZIP_USER_ID = b"laszip encoded\x00\x00"
_LASZIP_RECORD_ID = 22204
_LAZ_ITEM = {"POINT10": 6, "GPSTIME11": 7, "RGB12": 8}
_DEFAULT_CHUNK = 50000


def _find_laszip_vlr(data: bytes, header_size: int, n_vlrs: int):
    """Walk the VLRs; return the laszip VLR payload (or None)."""
    off = header_size
    for _ in range(n_vlrs):
        if off + 54 > len(data):
            break
        user_id = data[off + 2:off + 18]
        record_id, rec_len = struct.unpack_from("<HH", data, off + 18)
        payload = data[off + 54:off + 54 + rec_len]
        off += 54 + rec_len
        if user_id.rstrip(b"\x00") == _LASZIP_USER_ID.rstrip(b"\x00") \
                and record_id == _LASZIP_RECORD_ID:
            return payload
    return None


def _parse_laszip_vlr(payload: bytes):
    """→ (compressor, chunk_size, [(item_type, size, version), ...])."""
    if len(payload) < 34:
        raise InvalidDataError("laszip VLR payload truncated")
    compressor, _coder = struct.unpack_from("<HH", payload, 0)
    chunk_size = struct.unpack_from("<I", payload, 12)[0]
    num_items = struct.unpack_from("<H", payload, 32)[0]
    items = []
    for i in range(num_items):
        items.append(struct.unpack_from("<HHH", payload, 34 + 6 * i))
    return compressor, chunk_size, items


def read_point_cloud(path, device="cuda", **_) -> PointCloud:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"LASF":
        raise InvalidDataError("not a LAS file (missing LASF magic)")
    ver_major, ver_minor = data[24], data[25]
    header_size = struct.unpack_from("<H", data, 94)[0]
    offset_to_points = struct.unpack_from("<I", data, 96)[0]
    n_vlrs = struct.unpack_from("<I", data, 100)[0]
    fmt = data[104]
    compressed = bool(fmt & 0x80)
    fmt = fmt & 0x3F
    rec_len = struct.unpack_from("<H", data, 105)[0]
    n_legacy = struct.unpack_from("<I", data, 107)[0]
    sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", data, 131)
    n = n_legacy
    if ver_minor >= 4 and header_size >= 247:
        n64 = struct.unpack_from("<Q", data, 247)[0]
        if n64:
            n = n64
    if fmt not in _POINT_FORMATS:
        raise UnsupportedError(f"LAS point format {fmt} not supported "
                               f"(have {sorted(_POINT_FORMATS)})")
    if rec_len < _POINT_FORMATS[fmt]:
        raise InvalidDataError(
            f"LAS record length {rec_len} < format {fmt} minimum")

    if compressed:
        raw = _decompress_laz(data, header_size, n_vlrs, offset_to_points,
                              fmt, rec_len, n)
    else:
        raw = np.frombuffer(data, np.uint8, n * rec_len, offset_to_points
                            ).reshape(n, rec_len)
    xyz_i = raw[:, :12].copy().view("<i4")
    pts = np.stack([
        xyz_i[:, 0] * sx + ox,
        xyz_i[:, 1] * sy + oy,
        xyz_i[:, 2] * sz + oz], -1).astype(np.float32)
    attrs = {}
    inten = raw[:, _INTENSITY_OFFSET:_INTENSITY_OFFSET + 2].copy(
        ).view("<u2").ravel()
    if inten.any():
        attrs["intensity"] = inten.astype(np.float32) / 65535.0
    if fmt in _RGB_OFFSET:
        o = _RGB_OFFSET[fmt]
        rgb = raw[:, o:o + 6].copy().view("<u2").reshape(n, 3)
        attrs["colors"] = rgb.astype(np.float32) / 65535.0
    if fmt in _GPS_OFFSET:
        o = _GPS_OFFSET[fmt]
        gps = raw[:, o:o + 8].copy().view("<f8").ravel()
        if gps.any():
            attrs["gps_time"] = gps.astype(np.float64)
    if fmt in _NIR_OFFSET:
        o = _NIR_OFFSET[fmt]
        nir = raw[:, o:o + 2].copy().view("<u2").ravel()
        if nir.any():
            attrs["nir"] = nir.astype(np.float32) / 65535.0
    return PointCloud.from_numpy(pts, device=device, **attrs)


def _decompress_laz(data, header_size, n_vlrs, offset_to_points,
                    fmt, rec_len, n):
    from .. import native

    vlr = _find_laszip_vlr(data, header_size, n_vlrs)
    if vlr is None:
        raise InvalidDataError("LAZ file without a laszip VLR")
    compressor, chunk_size, items = _parse_laszip_vlr(vlr)
    if compressor not in (1, 2):
        raise UnsupportedError(
            f"LASzip compressor {compressor} (layered LASzip 3, point "
            "formats 6+) not supported; formats 0-3 are. The layered "
            "POINT14 bitstream is deliberately not guessed at: no "
            "LASzip-3 reference implementation, spec or sample corpus "
            "is reachable from this build environment, and a "
            "non-bit-exact decoder would silently corrupt real files "
            "— convert with `laszip -i in.laz -o out.las` or write "
            "point formats 0-3. Uncompressed LAS 1.4 formats 6/7 read "
            "fine.")
    if fmt not in (0, 1, 2, 3):
        raise UnsupportedError(
            f"compressed LAS point format {fmt} needs the layered "
            "LASzip 3 codec; only formats 0-3 are supported (see "
            "compressor-3 note: convert with laszip, or use "
            "uncompressed LAS for formats 6/7)")
    if rec_len != _POINT_FORMATS[fmt]:
        raise UnsupportedError(
            f"LAZ record has {rec_len - _POINT_FORMATS[fmt]} extra "
            "bytes (BYTE items not supported)")
    for (item_type, _size, version) in items:
        if item_type not in _LAZ_ITEM.values() or version != 2:
            raise UnsupportedError(
                f"LASzip item type {item_type} v{version} not supported "
                "(POINT10/GPSTIME11/RGB12 v2 are)")
    if compressor == 1:
        # pointwise without chunking == one chunk spanning the file
        chunk_size = max(int(n), 1)
    raw = native.laz_decompress(data, offset_to_points, int(n),
                                int(chunk_size), fmt, rec_len)
    if raw is None:
        raise UnsupportedError(
            "LAZ decode needs the native codec (g++ unavailable); "
            "convert with 'laszip -i in.laz -o out.las'")
    return raw


def write_point_cloud(path, cloud: PointCloud, scale: float = 1e-3,
                      compress: Optional[bool] = None,
                      point_format: Optional[int] = None, **_) -> None:
    """Write LAS (default: LAS 1.2 point format 2 — xyz + intensity +
    rgb — or format 3 with a ``gps_time`` attribute).
    ``point_format=6/7`` writes a LAS 1.4 file (375-byte header, u64
    counts, the modern extended record layout). ``compress=True`` — or
    a ``.laz`` path — writes LASzip-compressed chunks via the native
    codec (point formats 0-3 only: formats 6+ need the layered
    LASzip 3 bitstream — see _decompress_laz)."""
    if compress is None:
        compress = str(path).lower().endswith(".laz")
    if point_format is not None and point_format >= 6:
        if compress:
            raise UnsupportedError(
                "LAZ compression of point formats 6+ needs the layered "
                "LASzip 3 codec (not implemented); write uncompressed "
                ".las for formats 6/7")
        _write_las14(path, cloud, scale, point_format)
        return
    pts = cloud.to_numpy().astype(np.float64)
    n = len(pts)
    offset = pts.min(0) if n else np.zeros(3)
    has_gps = "gps_time" in cloud.attrs
    fmt = point_format if point_format is not None else (
        3 if has_gps else 2)
    if fmt not in (2, 3):
        raise UnsupportedError(
            f"LAS write supports point formats 2, 3 (LAS 1.2) and "
            f"6, 7 (LAS 1.4); got {fmt}")
    has_gps = fmt == 3
    rec_len = _POINT_FORMATS[fmt]
    header_size = 227

    fields = [("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
              ("intensity", "<u2"), ("flags", "u1"), ("class", "u1"),
              ("scan_angle", "i1"), ("user", "u1"), ("src", "<u2")]
    if has_gps:
        fields.append(("gps", "<f8"))
    fields += [("r", "<u2"), ("g", "<u2"), ("b", "<u2")]
    rec = np.zeros(n, np.dtype(fields))
    q = np.round((pts - offset) / scale).astype(np.int64)
    if q.size and (q.min() < np.iinfo(np.int32).min
                   or q.max() > np.iinfo(np.int32).max):
        raise InvalidDataError(
            "LAS quantized coordinates exceed the int32 record range "
            f"(extent {pts.min(0)}..{pts.max(0)} at scale {scale}); "
            "pass a coarser `scale` or recenter the cloud")
    rec["x"], rec["y"], rec["z"] = q[:, 0], q[:, 1], q[:, 2]
    rec["flags"] = 0x09                      # return 1 of 1
    if "intensity" in cloud.attrs:
        rec["intensity"] = np.clip(
            cloud.attr_to_numpy("intensity") * 65535, 0, 65535
        ).astype(np.uint16)
    if has_gps:
        rec["gps"] = cloud.attr_to_numpy("gps_time").astype(np.float64)
    if "colors" in cloud.attrs:
        c = np.clip(cloud.attr_to_numpy("colors") * 65535, 0, 65535
                    ).astype(np.uint16)
        rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]

    vlr_bytes = b""
    point_bytes: bytes
    if compress:
        from .. import native
        items = [(_LAZ_ITEM["POINT10"], 20, 2)]
        if has_gps:
            items.append((_LAZ_ITEM["GPSTIME11"], 8, 2))
        items.append((_LAZ_ITEM["RGB12"], 6, 2))
        payload = struct.pack("<HHBBHII", 2, 0, 2, 2, 0, 0,
                              _DEFAULT_CHUNK)
        payload += struct.pack("<qq", -1, -1)
        payload += struct.pack("<H", len(items))
        for it in items:
            payload += struct.pack("<HHH", *it)
        vlr_bytes = struct.pack("<H16sHH32s", 0, _LASZIP_USER_ID,
                                _LASZIP_RECORD_ID, len(payload),
                                b"threecrate-tpu laszip")
        vlr_bytes += payload
        offset_to_points = header_size + len(vlr_bytes)
        records = np.frombuffer(rec.tobytes(), np.uint8).reshape(n, rec_len)
        blk = native.laz_compress(records, fmt, _DEFAULT_CHUNK,
                                  offset_to_points)
        if blk is None:
            raise UnsupportedError(
                "LAZ write needs the native codec (g++ unavailable); "
                "write .las instead")
        point_bytes = blk
    else:
        offset_to_points = header_size
        point_bytes = rec.tobytes()

    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24] = 1
    hdr[25] = 2
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, offset_to_points)
    struct.pack_into("<I", hdr, 100, 1 if compress else 0)
    hdr[104] = fmt | (0x80 if compress else 0)
    struct.pack_into("<H", hdr, 105, rec_len)
    struct.pack_into("<I", hdr, 107, n)
    struct.pack_into("<6d", hdr, 131, scale, scale, scale, *offset)
    mx = pts.max(0) if n else np.zeros(3)
    mn = pts.min(0) if n else np.zeros(3)
    struct.pack_into("<6d", hdr, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(vlr_bytes)
        f.write(point_bytes)


def _write_las14(path, cloud: PointCloud, scale: float,
                 fmt: int) -> None:
    """LAS 1.4 writer: 375-byte header, u64 point counts, extended
    point records (format 6: xyz/intensity/returns/class/angle/gps;
    format 7: + 16-bit RGB). Round-trip partner of the format-6/7
    read path."""
    if fmt not in (6, 7):
        raise UnsupportedError(
            f"LAS 1.4 write supports point formats 6 and 7; got {fmt}")
    pts = cloud.to_numpy().astype(np.float64)
    n = len(pts)
    offset = pts.min(0) if n else np.zeros(3)
    rec_len = _POINT_FORMATS[fmt]
    header_size = 375

    fields = [("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
              ("intensity", "<u2"), ("returns", "u1"), ("flags", "u1"),
              ("class", "u1"), ("user", "u1"), ("scan_angle", "<i2"),
              ("src", "<u2"), ("gps", "<f8")]
    if fmt == 7:
        fields += [("r", "<u2"), ("g", "<u2"), ("b", "<u2")]
    rec = np.zeros(n, np.dtype(fields))
    q = np.round((pts - offset) / scale).astype(np.int64)
    if q.size and (q.min() < np.iinfo(np.int32).min
                   or q.max() > np.iinfo(np.int32).max):
        raise InvalidDataError(
            "LAS quantized coordinates exceed the int32 record range "
            f"(extent {pts.min(0)}..{pts.max(0)} at scale {scale}); "
            "pass a coarser `scale` or recenter the cloud")
    rec["x"], rec["y"], rec["z"] = q[:, 0], q[:, 1], q[:, 2]
    rec["returns"] = 0x11                    # return 1 of 1
    if "intensity" in cloud.attrs:
        rec["intensity"] = np.clip(
            cloud.attr_to_numpy("intensity") * 65535, 0, 65535
        ).astype(np.uint16)
    if "gps_time" in cloud.attrs:
        rec["gps"] = cloud.attr_to_numpy("gps_time").astype(np.float64)
    if fmt == 7 and "colors" in cloud.attrs:
        c = np.clip(cloud.attr_to_numpy("colors") * 65535, 0, 65535
                    ).astype(np.uint16)
        rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]

    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24] = 1
    hdr[25] = 4
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, header_size)   # offset to points
    struct.pack_into("<I", hdr, 100, 0)            # no VLRs
    hdr[104] = fmt
    struct.pack_into("<H", hdr, 105, rec_len)
    # legacy counts MUST be zero for point formats >= 6 (LAS 1.4 spec)
    struct.pack_into("<I", hdr, 107, 0)
    struct.pack_into("<6d", hdr, 131, scale, scale, scale, *offset)
    mx = pts.max(0) if n else np.zeros(3)
    mn = pts.min(0) if n else np.zeros(3)
    struct.pack_into("<6d", hdr, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])
    # 227: waveform start, 235: extended-VLR start, 243: extended-VLR
    # count, 247: u64 point count, 255: 15x u64 by-return counts
    struct.pack_into("<Q", hdr, 227, 0)
    struct.pack_into("<Q", hdr, 235, 0)
    struct.pack_into("<I", hdr, 243, 0)
    struct.pack_into("<Q", hdr, 247, n)
    struct.pack_into("<Q", hdr, 255, n)

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(rec.tobytes())
