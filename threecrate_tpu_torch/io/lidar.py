"""Raw LiDAR sensor formats: KITTI .bin, Velodyne/Ouster PCAP, Livox LVX.

Counterpart of ``threecrate_tpu.io.lidar``, the same host NumPy code;
readers return clouds on ``device`` (the card unless the caller asks for
the CPU). Covers threecrate-io/src/lidar.rs: the KITTI float32 x,y,z,intensity
dump (lidar.rs:315), Velodyne data-packet PCAP decoding with per-model
ring tables (lidar.rs:197-313), Ouster PCAP profiles (lidar.rs:382-422)
and Livox LVX v1.x (lidar.rs:582,777). All decoding is vectorised
NumPy over packet arrays — no per-point loops.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.errors import InvalidDataError, UnsupportedError
from ..core.point_cloud import PointCloud


# ---------------------------------------------------------------------------
# KITTI velodyne .bin  (x, y, z, intensity float32 quadruples)
# ---------------------------------------------------------------------------

def read_kitti_bin_raw(path) -> np.ndarray:
    """Host parse of a KITTI .bin: the (N, 4) float32 table.

    Split out from :func:`read_kitti_bin` so the host I/O layer can be
    timed without the upload to the device."""
    data = np.fromfile(path, dtype="<f4")
    if data.size % 4:
        raise InvalidDataError(f"KITTI .bin length {data.size} not /4")
    return data.reshape(-1, 4)


def read_kitti_bin(path, device="cuda", **_) -> PointCloud:
    """VelodyneKittiBinReader (lidar.rs:315)."""
    table = read_kitti_bin_raw(path)
    return PointCloud.from_numpy(table[:, :3], intensity=table[:, 3], device=device)


def write_kitti_bin(path, cloud: PointCloud, **_) -> None:
    pts = cloud.to_numpy()
    inten = (cloud.attr_to_numpy("intensity") if "intensity" in cloud.attrs
             else np.zeros(len(pts), np.float32))
    np.concatenate([pts, inten[:, None]], 1).astype("<f4").tofile(path)


# ---------------------------------------------------------------------------
# PCAP container
# ---------------------------------------------------------------------------

def iter_pcap_udp_payloads(path) -> Iterator[bytes]:
    """Yield UDP payloads from a classic pcap file (EN10MB link type)."""
    with open(path, "rb") as f:
        gh = f.read(24)
        if len(gh) < 24:
            raise InvalidDataError("pcap: truncated global header")
        magic = struct.unpack("<I", gh[:4])[0]
        if magic == 0xA1B2C3D4:
            endian = "<"
        elif magic == 0xD4C3B2A1:
            endian = ">"
        else:
            raise InvalidDataError(f"pcap: bad magic {magic:#x}")
        while True:
            ph = f.read(16)
            if len(ph) < 16:
                return
            _, _, incl, _ = struct.unpack(endian + "IIII", ph)
            pkt = f.read(incl)
            if len(pkt) < incl:
                return
            # ethernet(14) + min IPv4(20) + udp(8)
            if len(pkt) < 42:
                continue
            ethertype = struct.unpack(">H", pkt[12:14])[0]
            off = 14
            if ethertype == 0x8100:  # VLAN tag
                ethertype = struct.unpack(">H", pkt[16:18])[0]
                off = 18
            if ethertype != 0x0800:
                continue
            ihl = (pkt[off] & 0x0F) * 4
            proto = pkt[off + 9]
            if proto != 17:  # UDP
                continue
            udp_off = off + ihl
            yield pkt[udp_off + 8:]


# ---------------------------------------------------------------------------
# Velodyne
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VelodyneModel:
    """Ring geometry table (lidar.rs:197-313 VelodyneModel)."""

    name: str
    elevations_deg: Tuple[float, ...]
    distance_resolution: float = 0.002  # meters per tick

    @property
    def n_lasers(self) -> int:
        return len(self.elevations_deg)


VLP_16 = VelodyneModel("VLP-16", (
    -15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15))
HDL_32E = VelodyneModel("HDL-32E", tuple(
    -30.67 + 1.33 * i for i in range(32)))
VELODYNE_MODELS = {"VLP-16": VLP_16, "HDL-32E": HDL_32E}


def decode_velodyne_packet(payload: bytes, model: VelodyneModel):
    """One 1206-byte data packet → (points (n,3), intensity, ring)."""
    if len(payload) < 1206:
        return None
    raw = np.frombuffer(payload[:1200], dtype=np.uint8).reshape(12, 100)
    flags = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
    block_ok = flags == 0xEEFF
    azimuth = (raw[:, 2].astype(np.float32)
               + raw[:, 3].astype(np.float32) * 256.0) * 0.01  # degrees
    body = raw[:, 4:].reshape(12, 32, 3)
    dist = (body[:, :, 0].astype(np.float32)
            + body[:, :, 1].astype(np.float32) * 256.0) * model.distance_resolution
    inten = body[:, :, 2].astype(np.float32)

    n = model.n_lasers
    ring = np.tile(np.arange(32) % n, (12, 1))
    elev = np.deg2rad(np.asarray(model.elevations_deg, np.float32))[ring]
    az = np.deg2rad(azimuth)[:, None] * np.ones((12, 32), np.float32)
    # second firing group of a VLP-16 block shares the block azimuth
    # (fine interpolation omitted; matches the reference's decode)
    valid = block_ok[:, None] & (dist > 0.001)
    x = dist * np.cos(elev) * np.sin(az)
    y = dist * np.cos(elev) * np.cos(az)
    z = dist * np.sin(elev)
    pts = np.stack([x[valid], y[valid], z[valid]], -1)
    return pts, inten[valid], ring[valid]


def read_velodyne_pcap(path, model: str = "VLP-16",
                       max_packets: Optional[int] = None, device="cuda", **_
                       ) -> PointCloud:
    """VelodynePcapReader (lidar.rs:197-313): merge all packets.

    Uses the native C++ batch decoder when available (all packets in
    one call), falling back to the vectorised NumPy per-packet path.
    """
    m = VELODYNE_MODELS.get(model)
    if m is None:
        raise UnsupportedError(
            f"unknown Velodyne model {model!r}; have {list(VELODYNE_MODELS)}")

    payloads = []
    for i, payload in enumerate(iter_pcap_udp_payloads(path)):
        if max_packets is not None and i >= max_packets:
            break
        if len(payload) >= 1206:
            payloads.append(payload[:1206])
    if not payloads:
        raise InvalidDataError("no Velodyne packets decoded from pcap")

    from ..native import decode_velodyne_batch
    packets = np.frombuffer(b"".join(payloads), np.uint8
                            ).reshape(len(payloads), 1206)
    native_out = decode_velodyne_batch(packets, m.distance_resolution)
    if native_out is not None:
        dist, az, inten = native_out
        n_l = m.n_lasers
        ring = np.tile(np.arange(32) % n_l, len(payloads) * 12)
        elev = np.deg2rad(np.asarray(m.elevations_deg, np.float32))[ring]
        valid = dist > 0.001
        x = dist * np.cos(elev) * np.sin(az)
        y = dist * np.cos(elev) * np.cos(az)
        z = dist * np.sin(elev)
        pts = np.stack([x[valid], y[valid], z[valid]], -1)
        return PointCloud.from_numpy(pts.astype(np.float32),
                                     intensity=inten[valid], device=device)

    pts_l, int_l = [], []
    for payload in payloads:
        out = decode_velodyne_packet(payload, m)
        if out is None:
            continue
        p, it, _ = out
        pts_l.append(p)
        int_l.append(it)
    return PointCloud.from_numpy(np.concatenate(pts_l).astype(np.float32),
                                 intensity=np.concatenate(int_l), device=device)


# ---------------------------------------------------------------------------
# Ouster
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OusterProfile:
    """Sensor profile (lidar.rs:382-422): beam layout for LEGACY packets."""

    name: str
    n_channels: int
    columns_per_packet: int = 16
    beam_altitude_deg: Tuple[float, ...] = ()

    def altitudes(self) -> np.ndarray:
        if self.beam_altitude_deg:
            return np.asarray(self.beam_altitude_deg, np.float32)
        return np.linspace(16.6, -16.6, self.n_channels).astype(np.float32)


OS1_64 = OusterProfile("OS1-64", 64)
OS_128 = OusterProfile("OS-128", 128)
OUSTER_PROFILES = {"OS1-64": OS1_64, "OS-128": OS_128}


def read_ouster_pcap(path, profile: str = "OS1-64",
                     max_packets: Optional[int] = None, device="cuda", **_
                     ) -> PointCloud:
    """OusterPcapReader: LEGACY profile UDP format (col blocks of
    16+12·n_channels bytes: ts u64, mid u16, fid u16, enc u32, then per
    channel range u32(mm,20bit) + reflectivity...)."""
    p = OUSTER_PROFILES.get(profile)
    if p is None:
        raise UnsupportedError(
            f"unknown Ouster profile {profile!r}; have {list(OUSTER_PROFILES)}")
    col_bytes = 16 + 12 * p.n_channels + 4
    alts = np.deg2rad(p.altitudes())
    pts_l, int_l = [], []
    for i, payload in enumerate(iter_pcap_udp_payloads(path)):
        if max_packets is not None and i >= max_packets:
            break
        ncols = len(payload) // col_bytes
        if ncols == 0:
            continue
        raw = np.frombuffer(payload[:ncols * col_bytes], np.uint8
                            ).reshape(ncols, col_bytes)
        enc = raw[:, 12:16].copy().view("<u4").ravel().astype(np.float32)
        theta = 2 * np.pi * (1.0 - enc / 90112.0)
        ch = raw[:, 16:16 + 12 * p.n_channels].reshape(ncols, p.n_channels, 12)
        rng = (ch[:, :, 0:4].copy().view("<u4")[..., 0] & 0x000FFFFF
               ).astype(np.float32) / 1000.0
        refl = ch[:, :, 4:6].copy().view("<u2")[..., 0].astype(np.float32)
        valid = rng > 0.001
        th = theta[:, None] * np.ones_like(rng)
        al = alts[None, :] * np.ones_like(rng)
        x = rng * np.cos(th) * np.cos(al)
        y = rng * np.sin(th) * np.cos(al)
        z = rng * np.sin(al)
        pts_l.append(np.stack([x[valid], y[valid], z[valid]], -1))
        int_l.append(refl[valid])
    if not pts_l:
        raise InvalidDataError("no Ouster columns decoded from pcap")
    return PointCloud.from_numpy(np.concatenate(pts_l).astype(np.float32),
                                 intensity=np.concatenate(int_l), device=device)


# ---------------------------------------------------------------------------
# Livox LVX
# ---------------------------------------------------------------------------

def read_livox_lvx(path, max_frames: Optional[int] = None, device="cuda", **_
                   ) -> PointCloud:
    """LivoxLvxReader (lidar.rs:582,777): LVX v1.1 frames, cartesian
    point data types 0 (raw mm) and 2 (extended mm + reflectivity)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"livox_tech"):
        raise InvalidDataError("not an LVX file (missing livox_tech magic)")
    # public header 24 bytes, private header 5 bytes (frame_duration u32 + device_count u8)
    if len(data) < 29:
        raise InvalidDataError("LVX truncated header")
    dev_count = data[28]
    pos = 29 + dev_count * 59  # device info blocks are 59 bytes each
    pts_l, int_l = [], []
    n_frames = 0
    while pos + 24 <= len(data):
        cur, nxt, frame_idx = struct.unpack("<QQQ", data[pos:pos + 24])
        if nxt <= pos or nxt > len(data):
            break
        ppos = pos + 24
        while ppos + 19 <= min(nxt, len(data)):
            # package header: dev u8, version u8, slot u8, lidar_id u8,
            # rsvd u8, err u32, timestamp_type u8, data_type u8, timestamp u64
            data_type = data[ppos + 10]
            ppos_hdr = ppos + 19
            if data_type == 0:      # 100 pts × (i32 x,y,z mm + u8 refl)
                n, sz = 100, 13
            elif data_type == 2:    # 96 pts × (i32 x,y,z mm + u8 refl + u8 tag)
                n, sz = 96, 14
            else:
                break  # unsupported package type: skip rest of frame
            end = ppos_hdr + n * sz
            if end > len(data):
                break
            raw = np.frombuffer(data[ppos_hdr:end], np.uint8).reshape(n, sz)
            xyz = raw[:, :12].copy().view("<i4").astype(np.float32) / 1000.0
            refl = raw[:, 12].astype(np.float32)
            ok = np.abs(xyz).sum(1) > 1e-6
            pts_l.append(xyz[ok])
            int_l.append(refl[ok])
            ppos = end
        pos = nxt
        n_frames += 1
        if max_frames is not None and n_frames >= max_frames:
            break
    if not pts_l:
        raise InvalidDataError("no points decoded from LVX")
    return PointCloud.from_numpy(np.concatenate(pts_l),
                                 intensity=np.concatenate(int_l), device=device)


# ---------------------------------------------------------------------------
# Livox LVX2 (Avia / HAP / Mid-360 recordings)
# ---------------------------------------------------------------------------

LVX2_MAGIC = 0x20200903
_LVX2_DEVICE_INFO_SIZE = 41   # sn(16) + extrinsic_enable(1) + 6×f32
_LVX2_FRAME_HEADER_SIZE = 24  # cur u64 + next u64 + frame_index u64
_LVX2_PKT_HEADER_SIZE = 11    # dev u8, lidar_type u8, point_num u32, data_type u8, data_length u32
# point layouts per data_type (LivoxLvx2Reader, lidar.rs:722-770)
_LVX2_POINT_SIZE = {0: 8, 1: 14, 2: 10}


def _lvx2_decode_points(dtype: int, body: bytes
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz meters (n,3) f32, reflectivity (n,) f32) of one packet body."""
    sz = _LVX2_POINT_SIZE[dtype]
    n = len(body) // sz
    raw = np.frombuffer(body[:n * sz], np.uint8).reshape(n, sz)
    if dtype == 0:      # i16 x,y,z in 10 mm units + refl + tag
        xyz = raw[:, :6].copy().view("<i2").astype(np.float32) * 0.01
        refl = raw[:, 6].astype(np.float32)
    elif dtype == 1:    # i32 x,y,z in mm + refl + tag
        xyz = raw[:, :12].copy().view("<i4").astype(np.float32) / 1000.0
        refl = raw[:, 12].astype(np.float32)
    else:               # spherical: depth u32 mm, theta/phi u16 cdeg, refl, tag
        depth = raw[:, 0:4].copy().view("<u4")[:, 0].astype(np.float32) / 1000.0
        theta = np.deg2rad(
            raw[:, 4:6].copy().view("<u2")[:, 0].astype(np.float32) * 0.01)
        phi = np.deg2rad(
            raw[:, 6:8].copy().view("<u2")[:, 0].astype(np.float32) * 0.01)
        sin_t = np.sin(theta)
        xyz = np.stack([depth * sin_t * np.cos(phi),
                        depth * sin_t * np.sin(phi),
                        depth * np.cos(theta)], -1).astype(np.float32)
        refl = raw[:, 8].astype(np.float32)
    return xyz, refl


def read_livox_lvx2(path, max_frames: Optional[int] = None, device="cuda", **_
                    ) -> PointCloud:
    """LivoxLvx2Reader (lidar.rs:772-880): the updated Livox recording
    container (Avia/HAP/Mid-360). Public header (magic 0x20200903,
    header_size at byte 8, device_count at byte 24) → 41-byte device
    infos → frames of 11-byte-headed packets, point data types
    0 (cartesian i16, cm), 1 (cartesian i32, mm) and 2 (spherical)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 28:
        raise InvalidDataError("LVX2 file is too small")
    magic, = struct.unpack_from("<I", data, 0)
    if magic != LVX2_MAGIC:
        raise InvalidDataError(f"not a valid LVX2 file (magic={magic:#010x})")
    header_size, = struct.unpack_from("<I", data, 8)
    device_count = data[24]
    data_block_start = header_size + device_count * _LVX2_DEVICE_INFO_SIZE
    if data_block_start > len(data):
        raise InvalidDataError("LVX2 device info section past end of file")

    pts_l: List[np.ndarray] = []
    int_l: List[np.ndarray] = []
    pos = data_block_start
    n_frames = 0
    while pos + _LVX2_FRAME_HEADER_SIZE <= len(data):
        next_offset, = struct.unpack_from("<Q", data, pos + 8)
        frame_end = (len(data) if next_offset == 0
                     else min(data_block_start + next_offset, len(data)))
        pkg = pos + _LVX2_FRAME_HEADER_SIZE
        while pkg + _LVX2_PKT_HEADER_SIZE <= frame_end:
            dtype = data[pkg + 6]
            data_length, = struct.unpack_from("<I", data, pkg + 7)
            body_start = pkg + _LVX2_PKT_HEADER_SIZE
            body_end = body_start + data_length
            if body_end > len(data):
                break
            if dtype in _LVX2_POINT_SIZE and \
                    data_length >= _LVX2_POINT_SIZE[dtype]:
                xyz, refl = _lvx2_decode_points(
                    dtype, data[body_start:body_end])
                pts_l.append(xyz)
                int_l.append(refl)
            pkg = body_end
        n_frames += 1
        if max_frames is not None and n_frames >= max_frames:
            break
        if next_offset == 0 or data_block_start + next_offset <= pos:
            break
        pos = data_block_start + next_offset
    if not pts_l:
        raise InvalidDataError("no points decoded from LVX2")
    return PointCloud.from_numpy(np.concatenate(pts_l),
                                 intensity=np.concatenate(int_l), device=device)
