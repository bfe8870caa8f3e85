"""Typed point-cloud wrappers matching the reference python classes.

Counterpart of ``threecrate_tpu.core.typed_clouds``: host-side views
over the port's ``PointCloud``, whose ``from_numpy`` constructors put
the cloud on the card unless the caller asks for the CPU.

The reference extension module registers dedicated classes for each
point variant — ``NormalPointCloud``, ``ColoredPointCloud``,
``ColoredNormalPointCloud`` (threecrate-python/src/lib.rs:358-433,
:1779-1976) — with NumPy accessor *methods* (``positions()``,
``normals()``, ``colors()``). The TPU-native container is the single
SoA :class:`~threecrate_tpu.core.point_cloud.PointCloud` with attribute
arrays, so these classes are thin host-side views over it: they hold a
``PointCloud`` and expose the reference surface, while delegating every
other attribute to the wrapped cloud so they remain usable with the
native ops.

Colors follow the reference contract: ``uint8`` in ``[0, 255]`` at this
surface (lib.rs:1787-1822), ``float32`` in ``[0, 1]`` on the underlying
``PointCloud`` attribute (the device-friendly layout).
"""

from __future__ import annotations

import numpy as np

from .errors import InvalidDataError
from .point_cloud import COLORS, NORMALS, PointCloud


def _as_nx3_f32(arr, name: str) -> np.ndarray:
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise InvalidDataError(f"{name} must be (N, 3), got {a.shape}")
    return a


def _colors_to_float(colors) -> np.ndarray:
    """uint8 [0,255] (reference surface) → float32 [0,1] (native attr).

    Float input is accepted too and assumed already normalised.
    """
    c = np.asarray(colors)
    if c.ndim != 2 or c.shape[1] != 3:
        raise InvalidDataError(f"colors must be (N, 3), got {c.shape}")
    if np.issubdtype(c.dtype, np.integer):
        return c.astype(np.float32) / 255.0
    return c.astype(np.float32)


def _colors_to_u8(colors_f: np.ndarray) -> np.ndarray:
    return np.clip(colors_f * 255.0 + 0.5, 0, 255).astype(np.uint8)


class _TypedCloud:
    """Base wrapper: validates required attributes, delegates the rest."""

    _required: tuple = ()

    def __init__(self, cloud: PointCloud):
        if not isinstance(cloud, PointCloud):
            raise InvalidDataError(
                f"{type(self).__name__} wraps a PointCloud, got "
                f"{type(cloud).__name__}")
        for key in self._required:
            if key not in cloud.attrs:
                raise InvalidDataError(
                    f"{type(self).__name__} requires a cloud with "
                    f"{key!r}; call estimate_normals()/colorize first")
        object.__setattr__(self, "_cloud", cloud)

    # -- native interop ----------------------------------------------------
    @property
    def cloud(self) -> PointCloud:
        """The wrapped native PointCloud (its tensors)."""
        return self._cloud

    def to_point_cloud(self) -> PointCloud:
        return self._cloud

    # -- reference surface ---------------------------------------------------
    def positions(self) -> np.ndarray:
        """Valid positions as a host ``(n, 3)`` float32 array."""
        return self._cloud.to_numpy()

    @property
    def is_empty(self) -> bool:
        return bool(self._cloud.is_empty())

    def __len__(self) -> int:
        return len(self._cloud)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({len(self)} points)"

    def __getattr__(self, name):
        # delegate everything else (to_numpy, attrs, transform, ...) to
        # the wrapped cloud so native ops keep working on these views
        return getattr(self._cloud, name)


class NormalPointCloud(_TypedCloud):
    """XYZ + unit normals (lib.rs:358-433)."""

    _required = (NORMALS,)

    @staticmethod
    def from_numpy(positions, normals, device="cuda") -> "NormalPointCloud":
        pos = _as_nx3_f32(positions, "positions")
        nrm = _as_nx3_f32(normals, "normals")
        if len(pos) != len(nrm):
            raise InvalidDataError(
                f"positions ({len(pos)}) and normals ({len(nrm)}) "
                "must have the same length")
        return NormalPointCloud(PointCloud.from_numpy(pos, normals=nrm, device=device))

    def normals(self) -> np.ndarray:
        return self._cloud.attr_to_numpy(NORMALS)


class ColoredPointCloud(_TypedCloud):
    """XYZ + RGB (lib.rs:1779-1866). Colors are uint8 at this surface."""

    _required = (COLORS,)

    @staticmethod
    def from_numpy(positions, colors, device="cuda") -> "ColoredPointCloud":
        pos = _as_nx3_f32(positions, "positions")
        col = _colors_to_float(colors)
        if len(pos) != len(col):
            raise InvalidDataError(
                f"positions ({len(pos)}) and colors ({len(col)}) "
                "must have the same length")
        return ColoredPointCloud(PointCloud.from_numpy(pos, colors=col, device=device))

    def colors(self) -> np.ndarray:
        return _colors_to_u8(self._cloud.attr_to_numpy(COLORS))


class ColoredNormalPointCloud(_TypedCloud):
    """XYZ + RGB + normals (lib.rs:1871-1976)."""

    _required = (NORMALS, COLORS)

    @staticmethod
    def from_numpy(positions, normals, colors,
                   device="cuda") -> "ColoredNormalPointCloud":
        pos = _as_nx3_f32(positions, "positions")
        nrm = _as_nx3_f32(normals, "normals")
        col = _colors_to_float(colors)
        if not (len(pos) == len(nrm) == len(col)):
            raise InvalidDataError(
                "positions, normals and colors must have the same length")
        return ColoredNormalPointCloud(
            PointCloud.from_numpy(pos, normals=nrm, colors=col, device=device))

    def normals(self) -> np.ndarray:
        return self._cloud.attr_to_numpy(NORMALS)

    def colors(self) -> np.ndarray:
        return _colors_to_u8(self._cloud.attr_to_numpy(COLORS))


def wrap_typed(cloud: PointCloud):
    """Wrap a PointCloud in the most specific typed view its attributes
    support (used by the typed PointCloud2 converters)."""
    has_n = NORMALS in cloud.attrs
    has_c = COLORS in cloud.attrs
    if has_n and has_c:
        return ColoredNormalPointCloud(cloud)
    if has_n:
        return NormalPointCloud(cloud)
    if has_c:
        return ColoredPointCloud(cloud)
    return cloud


def unwrap(cloud) -> PointCloud:
    """Accept a PointCloud or any typed view and return the PointCloud."""
    if isinstance(cloud, _TypedCloud):
        return cloud.cloud
    return cloud
