"""rosbag2 (.db3) PointCloud2 extraction.

Counterpart of ``threecrate_tpu.io.rosbag``, the same host code; the
readers return clouds on ``device`` (the card unless the caller asks
for the CPU).
Covers threecrate-io/src/rosbag.rs:318 (Rosbag2Reader over sqlite3
.db3 bags). The sqlite layer uses the stdlib; message payloads are
CDR-decoded with a purpose-built decoder for the well-known
sensor_msgs/msg/PointCloud2 layout (rosbag.rs delegates the same job to
the mcap/ros crates), and the MCAP container (rosbag.rs:219) is
parsed natively below over the same CDR decoder.
"""

from __future__ import annotations

import sqlite3
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.errors import InvalidDataError, UnsupportedError
from ..core.point_cloud import PointCloud
from . import ros2


class _Cdr:
    """Minimal XCDR1 little-endian reader (ROS2 default encoding)."""

    def __init__(self, buf: bytes):
        # 4-byte encapsulation header: {0x00, 0x01} = CDR_LE
        if len(buf) < 4:
            raise InvalidDataError("CDR payload too short")
        if buf[1] not in (0x00, 0x01):
            raise UnsupportedError(f"CDR encapsulation {buf[:2]!r}")
        self.little = buf[1] == 0x01
        self.buf = buf
        self.pos = 4

    def _align(self, n: int) -> None:
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def bool_(self) -> bool:
        return bool(self.u8())

    def u32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<I" if self.little else ">I",
                                  self.buf, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        self._align(4)
        (v,) = struct.unpack_from("<i" if self.little else ">i",
                                  self.buf, self.pos)
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.pos:self.pos + n - 1].decode("utf-8",
                                                       errors="replace")
        self.pos += n
        return s

    def bytes_(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


def decode_pointcloud2_cdr(payload: bytes) -> Dict:
    """CDR bytes → PointCloud2 message dict (ros2.from_pointcloud2
    input)."""
    c = _Cdr(payload)
    # std_msgs/Header: stamp{sec int32, nanosec uint32}, frame_id string
    sec = c.i32()
    nanosec = c.u32()
    frame_id = c.string()
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = []
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields.append({"name": name, "offset": offset,
                       "datatype": datatype, "count": count})
    is_bigendian = c.bool_()
    point_step = c.u32()
    row_step = c.u32()
    data = c.bytes_()
    is_dense = c.bool_()
    return {
        "header": {"frame_id": frame_id, "stamp": (sec, nanosec)},
        "height": height, "width": width, "fields": fields,
        "is_bigendian": is_bigendian, "point_step": point_step,
        "row_step": row_step, "data": data, "is_dense": is_dense,
    }


class Rosbag2Reader:
    """Iterate PointCloud2 messages out of a rosbag2 .db3 file
    (rosbag.rs:318)."""

    def __init__(self, path):
        self.path = str(path)
        self._conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)

    def topics(self) -> List[Tuple[str, str]]:
        cur = self._conn.execute("SELECT name, type FROM topics")
        return list(cur.fetchall())

    def pointcloud_topics(self) -> List[str]:
        return [name for name, typ in self.topics()
                if typ.endswith("PointCloud2")]

    def messages(self, topic: Optional[str] = None
                 ) -> Iterator[Tuple[int, Dict]]:
        """Yield (timestamp_ns, PointCloud2 dict)."""
        topics = [topic] if topic else self.pointcloud_topics()
        if not topics:
            raise InvalidDataError("bag has no PointCloud2 topics")
        q = ("SELECT m.timestamp, m.data FROM messages m "
             "JOIN topics t ON m.topic_id = t.id WHERE t.name = ? "
             "ORDER BY m.timestamp")
        for t in topics:
            for ts, blob in self._conn.execute(q, (t,)):
                yield ts, decode_pointcloud2_cdr(blob)

    def read_clouds(self, topic: Optional[str] = None,
                    max_messages: Optional[int] = None,
                    device="cuda") -> List[PointCloud]:
        out = []
        for i, (_, msg) in enumerate(self.messages(topic)):
            if max_messages is not None and i >= max_messages:
                break
            out.append(ros2.from_pointcloud2(msg, device))
        return out

    def close(self) -> None:
        self._conn.close()


def read_point_cloud(path, topic: Optional[str] = None, device="cuda",
                     **_) -> PointCloud:
    """Merge all PointCloud2 messages in a bag into one cloud."""
    reader = Rosbag2Reader(path)
    try:
        clouds = reader.read_clouds(topic, device="cpu")
    finally:
        reader.close()
    if not clouds:
        raise InvalidDataError("no PointCloud2 messages in bag")
    pts = np.concatenate([c.to_numpy() for c in clouds])
    return PointCloud.from_numpy(pts, device=device)


class McapReader:
    """MCAP container reader (rosbag.rs:219): parses the record stream
    (schema/channel/message/chunk records) and CDR-decodes PointCloud2
    messages with the decoder above. Supports uncompressed and
    zstd/lz4-free chunks (compressed chunks raise a clear error)."""

    # record opcodes (mcap spec)
    _SCHEMA, _CHANNEL, _MESSAGE, _CHUNK = 0x03, 0x04, 0x05, 0x06

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            self._data = f.read()
        if not self._data.startswith(b"\x89MCAP"):
            raise InvalidDataError("not an MCAP file (bad magic)")
        self.schemas: Dict[int, str] = {}
        self.channels: Dict[int, Dict] = {}
        self._messages: List[Tuple[int, int, bytes]] = []
        self._parse(self._data[8:])  # skip magic + version byte + \n

    @staticmethod
    def _read_str(buf, off):
        (n,) = struct.unpack_from("<I", buf, off)
        s = buf[off + 4:off + 4 + n].decode("utf-8", errors="replace")
        return s, off + 4 + n

    def _parse(self, buf) -> None:
        off = 0
        while off + 9 <= len(buf):
            op = buf[off]
            (length,) = struct.unpack_from("<Q", buf, off + 1)
            body = buf[off + 9:off + 9 + length]
            off += 9 + length
            if op == 0x89 or op == 0x02:  # footer/end magics
                break
            if op == self._SCHEMA:
                (sid,) = struct.unpack_from("<H", body, 0)
                name, _ = self._read_str(body, 2)
                self.schemas[sid] = name
            elif op == self._CHANNEL:
                cid, sid = struct.unpack_from("<HH", body, 0)
                topic, _ = self._read_str(body, 4)
                self.channels[cid] = {"schema_id": sid, "topic": topic}
            elif op == self._MESSAGE:
                cid, = struct.unpack_from("<H", body, 0)
                # sequence u32, log_time u64, publish_time u64
                (log_time,) = struct.unpack_from("<Q", body, 6)
                payload = body[22:]
                self._messages.append((cid, log_time, payload))
            elif op == self._CHUNK:
                # chunk: start u64, end u64, uncompressed_size u64,
                # crc u32, compression string, records_size u64, records
                (n_comp,) = struct.unpack_from("<I", body, 28)
                comp = body[32:32 + n_comp].decode()
                pos = 32 + n_comp
                (rec_size,) = struct.unpack_from("<Q", body, pos)
                records = body[pos + 8:pos + 8 + rec_size]
                if comp in ("", "none"):
                    self._parse(records)
                else:
                    raise UnsupportedError(
                        f"MCAP chunk compression {comp!r} not supported; "
                        "rewrite with 'mcap convert --compression none'")

    def pointcloud_topics(self) -> List[str]:
        return sorted({
            ch["topic"] for ch in self.channels.values()
            if self.schemas.get(ch["schema_id"], "").endswith("PointCloud2")})

    def messages(self, topic: Optional[str] = None):
        """Yield (timestamp_ns, PointCloud2 dict)."""
        wanted = {cid for cid, ch in self.channels.items()
                  if self.schemas.get(ch["schema_id"], ""
                                      ).endswith("PointCloud2")
                  and (topic is None or ch["topic"] == topic)}
        if not wanted:
            raise InvalidDataError("mcap has no PointCloud2 channels")
        for cid, ts, payload in self._messages:
            if cid in wanted:
                yield ts, decode_pointcloud2_cdr(payload)

    def read_clouds(self, topic: Optional[str] = None,
                    max_messages: Optional[int] = None,
                    device="cuda") -> List[PointCloud]:
        out = []
        for i, (_, msg) in enumerate(self.messages(topic)):
            if max_messages is not None and i >= max_messages:
                break
            out.append(ros2.from_pointcloud2(msg, device))
        return out


def read_point_cloud_mcap(path, topic: Optional[str] = None, device="cuda",
                          **_) -> PointCloud:
    reader = McapReader(path)
    clouds = reader.read_clouds(topic, device="cpu")
    if not clouds:
        raise InvalidDataError("no PointCloud2 messages in mcap")
    pts = np.concatenate([c.to_numpy() for c in clouds])
    return PointCloud.from_numpy(pts, device=device)
