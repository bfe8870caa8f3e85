"""Viewer API: one-line show_* helpers + an interactive viewer shell.

Counterpart of ``threecrate_tpu.viz.viewer``. Covers
threecrate-visualization: ``show_point_cloud``/``show_mesh``
one-liners (visualization/src/lib.rs:21-32) and the ``InteractiveViewer``
(interactive_viewer.rs:116) with its ViewData variants (:27-32),
runtime-tunable ICP/RANSAC parameter blocks (:51-83) and pipeline
toggle (:43-47). The reference drives a winit window; this environment
is headless, so frames render through viz.renderer (on the content's device) and
are written to PNG / returned as arrays. The control surface (orbit/
pan/zoom, parameter structs, re-run pipeline) is identical in spirit.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np

from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from .camera import OrbitCamera
from .renderer import render_mesh, render_point_cloud, save_image


class ViewData(enum.Enum):
    """interactive_viewer.rs:27-32."""

    EMPTY = "empty"
    POINT_CLOUD = "point_cloud"
    COLORED_POINT_CLOUD = "colored_point_cloud"
    MESH = "mesh"


class PipelineType(enum.Enum):
    """CPU/GPU toggle (interactive_viewer.rs:43-47) → here it picks the
    exact vs windowed neighbor search for the live pipelines."""

    EXACT = "exact"
    WINDOWED = "windowed"


@dataclasses.dataclass
class ICPParams:
    """Runtime-tunable ICP knobs (interactive_viewer.rs:51-66)."""

    max_iterations: int = 30
    convergence_threshold: float = 1e-6
    max_correspondence_distance: Optional[float] = None


@dataclasses.dataclass
class RANSACParams:
    """Runtime-tunable RANSAC knobs (interactive_viewer.rs:67-83)."""

    distance_threshold: float = 0.01
    max_iterations: int = 512


class InteractiveViewer:
    """Headless interactive viewer: holds content + camera, renders
    frames on demand (the winit event loop becomes explicit method
    calls; notebook/video loops drive it)."""

    def __init__(self, width: int = 960, height: int = 720):
        self.width = width
        self.height = height
        self.camera: Optional[OrbitCamera] = None
        self.data_kind = ViewData.EMPTY
        self._content: Optional[Union[PointCloud, TriangleMesh]] = None
        self.icp_params = ICPParams()
        self.ransac_params = RANSACParams()
        self.pipeline = PipelineType.EXACT
        self.point_size = 2

    # -- content ---------------------------------------------------------
    def set_point_cloud(self, cloud: PointCloud) -> None:
        self._content = cloud
        self.data_kind = (ViewData.COLORED_POINT_CLOUD
                          if cloud.colors is not None
                          else ViewData.POINT_CLOUD)
        self.camera = OrbitCamera.fit(cloud.to_numpy())

    def set_mesh(self, mesh: TriangleMesh) -> None:
        self._content = mesh
        self.data_kind = ViewData.MESH
        v, _ = mesh.to_numpy()
        self.camera = OrbitCamera.fit(v)

    # -- camera controls ---------------------------------------------------
    def orbit(self, d_yaw: float, d_pitch: float) -> None:
        if self.camera:
            self.camera.orbit(d_yaw, d_pitch)

    def zoom(self, factor: float) -> None:
        if self.camera:
            self.camera.zoom(factor)

    def pan(self, dx: float, dy: float) -> None:
        if self.camera:
            self.camera.pan(dx, dy)

    # -- live pipelines (the viewer's "run ICP/RANSAC" hotkeys) -----------
    def run_plane_segmentation(self):
        from ..ops.segmentation import segment_plane
        if not isinstance(self._content, PointCloud):
            raise ValueError("plane segmentation needs a point cloud")
        return segment_plane(self._content,
                             self.ransac_params.distance_threshold,
                             self.ransac_params.max_iterations)

    def run_icp(self, target: PointCloud):
        from ..ops.registration import icp_point_to_point
        if not isinstance(self._content, PointCloud):
            raise ValueError("ICP needs a point cloud loaded")
        return icp_point_to_point(
            self._content, target,
            self.icp_params.max_iterations,
            self.icp_params.convergence_threshold,
            self.icp_params.max_correspondence_distance)

    # -- rendering ---------------------------------------------------------
    def render(self) -> np.ndarray:
        if self._content is None:
            return np.zeros((self.height, self.width, 3), np.float32)
        if self.data_kind == ViewData.MESH:
            return render_mesh(self._content, self.camera,
                               self.width, self.height)
        return render_point_cloud(self._content, self.camera,
                                  self.width, self.height,
                                  self.point_size)

    def screenshot(self, path) -> None:
        save_image(path, self.render())

    # -- terminal event loop ----------------------------------------------
    # The reference's winit ApplicationHandler (interactive_viewer.rs:
    # 116, 256) becomes a terminal loop: frames render device-side,
    # downsample to character cells and draw with 24-bit ANSI ▀
    # half-blocks (two pixels per character cell); keys drive the same
    # orbit/pan/zoom/pipeline controls the winit window bound.

    KEYMAP = {
        "a": ("orbit", (-0.15, 0.0)), "d": ("orbit", (0.15, 0.0)),
        "w": ("orbit", (0.0, 0.12)), "s": ("orbit", (0.0, -0.12)),
        "+": ("zoom", (0.8,)), "=": ("zoom", (0.8,)),
        "-": ("zoom", (1.25,)),
        "h": ("pan", (-0.05, 0.0)), "l": ("pan", (0.05, 0.0)),
        "j": ("pan", (0.0, -0.05)), "k": ("pan", (0.0, 0.05)),
    }

    def handle_key(self, key: str) -> bool:
        """Dispatch one key press; returns False when the loop should
        exit. 'p' toggles the exact/windowed pipeline, 'c' captures
        /tmp/viewer_frame.png, 'q'/ESC quits."""
        if key in ("q", "\x1b"):
            return False
        if key == "p":
            self.pipeline = (PipelineType.WINDOWED
                             if self.pipeline == PipelineType.EXACT
                             else PipelineType.EXACT)
            return True
        if key == "c":
            self.screenshot("/tmp/viewer_frame.png")
            return True
        action = self.KEYMAP.get(key)
        if action is not None:
            name, args = action
            getattr(self, name)(*args)
        return True

    def frame_ansi(self, cols: int = 100, rows: int = 36) -> str:
        """One frame as an ANSI truecolor string (rows text lines,
        2 vertical pixels per line via the ▀ half-block)."""
        img = np.clip(self.render(), 0.0, 1.0)
        h, w = img.shape[:2]
        ys = np.linspace(0, h - 1, rows * 2).astype(int)
        xs = np.linspace(0, w - 1, cols).astype(int)
        small = (img[ys][:, xs] * 255).astype(np.uint8)
        lines = []
        for r in range(rows):
            top = small[2 * r]
            bot = small[2 * r + 1]
            cells = [
                f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                for t, b in zip(top, bot)
            ]
            lines.append("".join(cells) + "\x1b[0m")
        return "\n".join(lines)

    def run_terminal(self, cols: int = 100, rows: int = 36,
                     keys=None, max_frames: Optional[int] = None) -> int:
        """Interactive terminal loop. Reads single keys from stdin (raw
        mode) and redraws after each event; WASD orbit, hjkl pan, +/-
        zoom, p pipeline toggle, c capture, q quit.

        ``keys``: optional iterable of key characters to consume
        instead of stdin (scripted/CI use — no tty needed). Returns the
        number of frames drawn.
        """
        import sys

        frames = 0

        def draw():
            nonlocal frames
            sys.stdout.write("\x1b[H\x1b[2J" + self.frame_ansi(cols, rows)
                             + "\n[wasd] orbit  [hjkl] pan  [+/-] zoom  "
                               "[p] pipeline  [c] capture  [q] quit\n")
            sys.stdout.flush()
            frames += 1

        if keys is not None:
            draw()
            for key in keys:
                if not self.handle_key(key):
                    break
                draw()
                if max_frames is not None and frames >= max_frames:
                    break
            return frames

        if not sys.stdin.isatty():
            raise RuntimeError(
                "run_terminal needs a tty (or pass keys=... for a "
                "scripted session)")
        import termios
        import tty
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            draw()
            while max_frames is None or frames < max_frames:
                key = sys.stdin.read(1)
                if not self.handle_key(key):
                    break
                draw()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return frames


def show_point_cloud(cloud: PointCloud, path=None, **kw) -> np.ndarray:
    """One-liner (visualization/src/lib.rs:21): render (and optionally
    save) a cloud; returns the image array."""
    img = render_point_cloud(cloud, **kw)
    if path is not None:
        save_image(path, img)
    return img


def show_mesh(mesh: TriangleMesh, path=None, **kw) -> np.ndarray:
    """One-liner (visualization/src/lib.rs:32)."""
    img = render_mesh(mesh, **kw)
    if path is not None:
        save_image(path, img)
    return img
