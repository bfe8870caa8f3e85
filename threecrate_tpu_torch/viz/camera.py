"""Orbit camera for the viewer (threecrate-visualization/src/camera.rs:8).

Counterpart of ``threecrate_tpu.viz.camera``, the same NumPy code:
look-at + perspective projection with orbit/pan/zoom controls, on the
host; the renderers upload its matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class OrbitCamera:
    """Orbit/pan/zoom camera state (camera.rs:8)."""

    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    distance: float = 3.0
    yaw: float = 0.6
    pitch: float = 0.4
    fov_deg: float = 50.0
    near: float = 0.01
    far: float = 1000.0

    # -- controls -------------------------------------------------------
    def orbit(self, d_yaw: float, d_pitch: float) -> None:
        self.yaw += d_yaw
        self.pitch = float(np.clip(self.pitch + d_pitch,
                                   -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3))

    def zoom(self, factor: float) -> None:
        self.distance = float(np.clip(self.distance * factor, 1e-3, 1e6))

    def pan(self, dx: float, dy: float) -> None:
        right, up, _ = self._basis()
        self.target = self.target + right * dx + up * dy

    # -- matrices ---------------------------------------------------------
    def eye(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        d = np.array([cp * np.cos(self.yaw), cp * np.sin(self.yaw),
                      np.sin(self.pitch)], np.float32)
        return self.target + d * self.distance

    def _basis(self):
        fwd = self.target - self.eye()
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        world_up = np.array([0, 0, 1.0], np.float32)
        right = np.cross(fwd, world_up)
        if np.linalg.norm(right) < 1e-6:
            right = np.array([1.0, 0, 0], np.float32)
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        return right, up, fwd

    def view_matrix(self) -> np.ndarray:
        right, up, fwd = self._basis()
        eye = self.eye()
        m = np.eye(4, dtype=np.float32)
        m[0, :3] = right
        m[1, :3] = up
        m[2, :3] = -fwd
        m[:3, 3] = -(m[:3, :3] @ eye)
        return m

    def intrinsics(self, width: int, height: int):
        """(fx, fy, cx, cy) pinhole equivalent of the perspective fov."""
        f = 0.5 * height / np.tan(np.deg2rad(self.fov_deg) / 2)
        return f, f, width / 2.0, height / 2.0

    @classmethod
    def fit(cls, points: np.ndarray, fov_deg: float = 50.0) -> "OrbitCamera":
        """Frame a cloud/mesh: target = center, distance from extent."""
        mn, mx = points.min(0), points.max(0)
        center = (mn + mx) / 2
        radius = max(float(np.linalg.norm(mx - mn)) / 2, 1e-3)
        dist = radius / np.tan(np.deg2rad(fov_deg) / 2) * 1.4
        return cls(target=center.astype(np.float32), distance=float(dist),
                   fov_deg=fov_deg)
