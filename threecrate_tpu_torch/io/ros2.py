"""sensor_msgs/PointCloud2 codec (both directions).

Counterpart of ``threecrate_tpu.io.ros2``, the same host NumPy code;
the decoders return clouds on ``device`` (the card unless the caller
asks for the CPU).
Covers threecrate-io/src/ros2.rs:214-595: PointField/PointCloud2
message structs (:38-91) and converters for xyz / colored / normals /
colored-normals / organized clouds. Messages are plain dicts shaped
like the ROS2 message (no ROS dependency); decode is one structured
``np.frombuffer``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.errors import InvalidDataError
from ..core.organized import OrganizedPointCloud
from ..core.point_cloud import PointCloud
from ..core.typed_clouds import (ColoredNormalPointCloud, ColoredPointCloud,
                                 NormalPointCloud, unwrap)

# PointField datatype constants (sensor_msgs/PointField)
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)
_DT = {INT8: "i1", UINT8: "u1", INT16: "i2", UINT16: "u2",
       INT32: "i4", UINT32: "u4", FLOAT32: "f4", FLOAT64: "f8"}
_DT_INV = {v: k for k, v in _DT.items()}


@dataclasses.dataclass
class PointField:
    """ros2.rs:38-52."""

    name: str
    offset: int
    datatype: int
    count: int = 1


class PointCloud2Data:
    """Serialized PointCloud2 container matching the reference's
    ``PointCloud2Data`` class (threecrate-python/src/lib.rs:1991-2049):
    ``data()`` / ``fields()`` methods plus ``point_step`` / ``row_step``
    / ``width`` / ``height`` / ``is_bigendian`` / ``is_dense`` getters.

    Wraps the plain message dict this module uses internally and stays
    dict-compatible (``msg["fields"]`` etc.), so it interoperates with
    ``from_pointcloud2`` and rosbag/MCAP encoders unchanged.
    """

    __slots__ = ("message",)

    def __init__(self, message: Dict):
        self.message = message

    # -- reference surface ---------------------------------------------------
    def data(self) -> bytes:
        """Raw bytes of the point data."""
        return bytes(self.message["data"])

    def fields(self) -> List[tuple]:
        """Field descriptors as ``(name, offset, datatype, count)``."""
        return [(f["name"], f["offset"], f["datatype"], f.get("count", 1))
                for f in self.message["fields"]]

    @property
    def point_step(self) -> int:
        return self.message["point_step"]

    @property
    def row_step(self) -> int:
        return self.message.get(
            "row_step", self.message["point_step"] * self.message["width"])

    @property
    def width(self) -> int:
        return self.message["width"]

    @property
    def height(self) -> int:
        return self.message["height"]

    @property
    def is_bigendian(self) -> bool:
        return bool(self.message.get("is_bigendian", False))

    @property
    def is_dense(self) -> bool:
        return bool(self.message.get("is_dense", True))

    def __repr__(self) -> str:
        return (f"PointCloud2Data({self.width}×{self.height} points, "
                f"point_step={self.point_step})")

    # -- dict compatibility (native message form) ------------------------------
    def __getitem__(self, key):
        return self.message[key]

    def get(self, key, default=None):
        return self.message.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self.message

    def keys(self):
        return self.message.keys()


def _as_message(msg) -> Dict:
    """Accept a message dict or a PointCloud2Data wrapper."""
    if isinstance(msg, PointCloud2Data):
        return msg.message
    return msg


def make_pointcloud2(cloud: PointCloud, frame_id: str = "map",
                     organized_shape: Optional[tuple] = None) -> Dict:
    """PointCloud → PointCloud2 message dict (ros2.rs to_* converters)."""
    pts = cloud.to_numpy()
    cols: List[tuple] = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    arrays = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if "normals" in cloud.attrs:
        n = cloud.attr_to_numpy("normals")
        cols += [("normal_x", "<f4"), ("normal_y", "<f4"),
                 ("normal_z", "<f4")]
        arrays += [n[:, 0], n[:, 1], n[:, 2]]
    if "colors" in cloud.attrs:
        c = np.clip(cloud.attr_to_numpy("colors") * 255 + 0.5, 0, 255
                    ).astype(np.uint32)
        packed = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]).view(
            np.float32)
        cols += [("rgb", "<f4")]
        arrays += [packed]
    if "intensity" in cloud.attrs:
        cols += [("intensity", "<f4")]
        arrays += [cloud.attr_to_numpy("intensity")]
    rec = np.zeros(len(pts), np.dtype(cols))
    for (name, _), arr in zip(cols, arrays):
        rec[name] = arr
    fields = [PointField(name, rec.dtype.fields[name][1],
                         _DT_INV[rec.dtype.fields[name][0].str[1:]])
              for name, _ in cols]
    if organized_shape is not None:
        height, width = organized_shape
        if height * width != len(pts):
            raise InvalidDataError("organized shape != point count")
    else:
        height, width = 1, len(pts)
    return {
        "header": {"frame_id": frame_id},
        "height": height,
        "width": width,
        "fields": [dataclasses.asdict(f) for f in fields],
        "is_bigendian": False,
        "point_step": rec.dtype.itemsize,
        "row_step": rec.dtype.itemsize * width,
        "data": rec.tobytes(),
        "is_dense": True,
    }


def from_pointcloud2(msg: Dict, device="cuda") -> PointCloud:
    """PointCloud2 message dict → PointCloud (ros2.rs from_* converters).

    Honors arbitrary field offsets/strides via a structured dtype with
    itemsize = point_step. Accepts either the plain message dict or a
    :class:`PointCloud2Data` wrapper.
    """
    msg = _as_message(msg)
    fields = msg["fields"]
    names, formats, offsets = [], [], []
    for f in fields:
        dt = _DT.get(f["datatype"])
        if dt is None:
            raise InvalidDataError(f"PointCloud2: bad datatype in {f}")
        names.append(f["name"])
        prefix = ">" if msg.get("is_bigendian") else "<"
        formats.append(f"{prefix}{dt}" if f.get("count", 1) == 1
                       else (prefix + dt, (f["count"],)))
        offsets.append(f["offset"])
    dtype = np.dtype({"names": names, "formats": formats,
                      "offsets": offsets, "itemsize": msg["point_step"]})
    n = msg["height"] * msg["width"]
    need = msg["height"] * msg.get("row_step", msg["point_step"]
                                   * msg["width"])
    if len(msg["data"]) < need:
        raise InvalidDataError(
            f"PointCloud2 data too short: need {need} bytes, "
            f"got {len(msg['data'])}")
    rec = np.frombuffer(msg["data"], dtype=dtype, count=n)
    for c in ("x", "y", "z"):
        if c not in names:
            raise InvalidDataError(f"PointCloud2 missing field {c!r}")
    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    attrs = {}
    if all(c in names for c in ("normal_x", "normal_y", "normal_z")):
        attrs["normals"] = np.stack(
            [rec["normal_x"], rec["normal_y"], rec["normal_z"]],
            -1).astype(np.float32)
    rgb_name = "rgb" if "rgb" in names else (
        "rgba" if "rgba" in names else None)
    if rgb_name is not None:
        col = rec[rgb_name]
        packed = col.view(np.uint32) if col.dtype == np.float32 \
            else col.astype(np.uint32)
        # 0x00RRGGBB (alpha, if any, discarded — ros2.rs:158-193)
        attrs["colors"] = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF],
            -1).astype(np.float32) / 255.0
    if "intensity" in names:
        attrs["intensity"] = rec["intensity"].astype(np.float32)
    finite = np.isfinite(pts).all(1)
    if not finite.all() and not msg.get("is_dense", True):
        pts = pts[finite]
        attrs = {k: v[finite] for k, v in attrs.items()}
    return PointCloud.from_numpy(pts, device=device, **attrs)


# ---------------------------------------------------------------------------
# Named typed converters — the 8 entry points the reference's python
# module registers (threecrate-python/src/lib.rs:2580-2588, bodies
# ros2.rs:214-595). They take the RAW message pieces (data bytes +
# (name, offset, datatype, count) field tuples) like the PyO3 layer,
# build the generic message dict, and apply the per-type requirements:
# *_to_normals demands normal_x/y/z, *_to_colored demands rgb/rgba
# (alpha discarded), and the serializers emit the reference's exact
# little-endian layouts (point_step 12/16/24/28, rgb = f32 whose bits
# encode 0x00RRGGBB).
# ---------------------------------------------------------------------------

def _msg_from_raw(data: bytes, fields, point_step: int, width: int,
                  height: int, is_bigendian: bool = False,
                  is_dense: bool = True) -> Dict:
    fl = []
    for f in fields:
        if isinstance(f, PointField):
            fl.append(dataclasses.asdict(f))
        elif isinstance(f, dict):
            fl.append({"count": 1, **f})
        else:
            name, offset, datatype, count = f
            fl.append({"name": name, "offset": int(offset),
                       "datatype": int(datatype), "count": int(count)})
    return {"header": {"frame_id": ""}, "height": int(height),
            "width": int(width), "fields": fl,
            "is_bigendian": bool(is_bigendian),
            "point_step": int(point_step),
            "row_step": int(point_step) * int(width),
            "data": data, "is_dense": bool(is_dense)}


def pointcloud2_to_xyz(data: bytes, fields, point_step: int, width: int,
                       height: int, is_bigendian: bool = False,
                       is_dense: bool = True, device="cuda") -> PointCloud:
    """Raw PointCloud2 → positions-only cloud (ros2.rs:214-243)."""
    c = from_pointcloud2(_msg_from_raw(data, fields, point_step, width,
                                       height, is_bigendian, is_dense),
                         device)
    return PointCloud(c.points, c.mask, {})


def pointcloud2_to_normals(data: bytes, fields, point_step: int,
                           width: int, height: int,
                           is_bigendian: bool = False,
                           is_dense: bool = True,
                           device="cuda") -> NormalPointCloud:
    """Raw PointCloud2 → cloud with normals; requires normal_x/y/z
    (ros2.rs:292-345)."""
    c = from_pointcloud2(_msg_from_raw(data, fields, point_step, width,
                                       height, is_bigendian, is_dense),
                         device)
    if "normals" not in c.attrs:
        raise InvalidDataError(
            "PointCloud2 missing field 'normal_x'/'normal_y'/'normal_z'")
    return NormalPointCloud(
        PointCloud(c.points, c.mask, {"normals": c.attrs["normals"]}))


def pointcloud2_to_colored(data: bytes, fields, point_step: int,
                           width: int, height: int,
                           is_bigendian: bool = False,
                           is_dense: bool = True,
                           device="cuda") -> ColoredPointCloud:
    """Raw PointCloud2 → cloud with colors; requires rgb or rgba
    (alpha discarded; ros2.rs:245-290)."""
    c = from_pointcloud2(_msg_from_raw(data, fields, point_step, width,
                                       height, is_bigendian, is_dense),
                         device)
    if "colors" not in c.attrs:
        raise InvalidDataError(
            "PointCloud2 missing 'rgb' or 'rgba' field")
    return ColoredPointCloud(
        PointCloud(c.points, c.mask, {"colors": c.attrs["colors"]}))


def pointcloud2_to_colored_normals(data: bytes, fields, point_step: int,
                                   width: int, height: int,
                                   is_bigendian: bool = False,
                                   is_dense: bool = True, device="cuda"
                                   ) -> ColoredNormalPointCloud:
    """Raw PointCloud2 → cloud with colors AND normals
    (ros2.rs:347-420)."""
    c = from_pointcloud2(_msg_from_raw(data, fields, point_step, width,
                                       height, is_bigendian, is_dense),
                         device)
    if "normals" not in c.attrs:
        raise InvalidDataError(
            "PointCloud2 missing field 'normal_x'/'normal_y'/'normal_z'")
    if "colors" not in c.attrs:
        raise InvalidDataError(
            "PointCloud2 missing 'rgb' or 'rgba' field")
    return ColoredNormalPointCloud(
        PointCloud(c.points, c.mask,
                   {"normals": c.attrs["normals"],
                    "colors": c.attrs["colors"]}))


def _require_attr(cloud: PointCloud, key: str, fn: str) -> None:
    if key not in cloud.attrs:
        raise InvalidDataError(f"{fn} requires the {key!r} attribute")


def xyz_to_pointcloud2(cloud: PointCloud,
                       frame_id: str = "map") -> PointCloud2Data:
    """Serialize positions only: x/y/z f32, point_step 12
    (ros2.rs:506-523; returns PointCloud2Data per lib.rs:2160)."""
    cloud = unwrap(cloud)
    return PointCloud2Data(make_pointcloud2(
        PointCloud(cloud.points, cloud.mask, {}), frame_id))


def normals_to_pointcloud2(cloud: PointCloud,
                           frame_id: str = "map") -> Dict:
    """x/y/z + normal_x/y/z, point_step 24 (ros2.rs:562-593)."""
    cloud = unwrap(cloud)
    _require_attr(cloud, "normals", "normals_to_pointcloud2")
    return PointCloud2Data(make_pointcloud2(
        PointCloud(cloud.points, cloud.mask,
                   {"normals": cloud.attrs["normals"]}), frame_id))


def colored_to_pointcloud2(cloud: PointCloud,
                           frame_id: str = "map") -> Dict:
    """x/y/z + packed rgb f32, point_step 16 (ros2.rs:529-560)."""
    cloud = unwrap(cloud)
    _require_attr(cloud, "colors", "colored_to_pointcloud2")
    return PointCloud2Data(make_pointcloud2(
        PointCloud(cloud.points, cloud.mask,
                   {"colors": cloud.attrs["colors"]}), frame_id))


def colored_normals_to_pointcloud2(cloud: PointCloud,
                                   frame_id: str = "map") -> Dict:
    """x/y/z + normals + rgb, point_step 28 (ros2.rs:595-637)."""
    cloud = unwrap(cloud)
    _require_attr(cloud, "normals", "colored_normals_to_pointcloud2")
    _require_attr(cloud, "colors", "colored_normals_to_pointcloud2")
    return PointCloud2Data(make_pointcloud2(
        PointCloud(cloud.points, cloud.mask,
                   {"normals": cloud.attrs["normals"],
                    "colors": cloud.attrs["colors"]}), frame_id))


def from_pointcloud2_organized(msg: Dict,
                               device="cuda") -> OrganizedPointCloud:
    """Keep the H×W structure (ros2.rs organized converter)."""
    cloud = _raw_grid(_as_message(msg), device)
    return cloud


def _raw_grid(msg: Dict, device) -> OrganizedPointCloud:
    h, w = msg["height"], msg["width"]
    if h <= 1:
        raise InvalidDataError("message is not organized (height <= 1)")
    flat = from_pointcloud2({**msg, "is_dense": True}, device="cpu")
    pts = flat.points.numpy()[:h * w].reshape(h, w, 3)
    valid = np.isfinite(pts).all(-1)
    pts = np.where(valid[..., None], pts, 0.0)
    return OrganizedPointCloud.from_numpy(pts, valid, device=device)


def make_pointcloud2_organized(opc: OrganizedPointCloud,
                               frame_id: str = "map") -> Dict:
    pts = opc.points.cpu().numpy().reshape(-1, 3).copy()
    invalid = ~opc.mask.cpu().numpy().reshape(-1)
    pts[invalid] = np.nan
    msg = make_pointcloud2(PointCloud.from_numpy(
        np.nan_to_num(pts), device="cpu"), frame_id,
        organized_shape=(opc.height, opc.width))
    # rewrite data with NaNs for invalid cells + is_dense flag
    rec = np.frombuffer(bytearray(msg["data"]), np.dtype(
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4")])).copy()
    rec["x"][invalid] = np.nan
    rec["y"][invalid] = np.nan
    rec["z"][invalid] = np.nan
    msg["data"] = rec.tobytes()
    msg["is_dense"] = bool((~invalid).all())
    return msg
