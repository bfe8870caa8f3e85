"""Frame-to-model depth tracking: projective point-to-plane ICP against
raycast TSDF maps (the KinectFusion loop).

Counterpart of ``threecrate_tpu.ops.frame_to_model``. The model is
raycast into the previous camera (``ops.tsdf_raycast``); each frame
pixel's correspondence is found by projecting it into the model view
and interpolating the model maps bilinearly, with no neighbour search.
A Gauss-Newton iteration is elementwise work over the frame plus one
6×6 normal-equation reduction; the loop runs on the host, as the ICP
loops do: each iteration sends the pose to the card from pinned memory
and reads the 6×6 system, its right-hand side and the count back in one
copy (its one host sync), then solves, exponentiates and composes in fp32 on the
host. ``counts["iterations"]`` counts iterations since
``reset_counts()``.

``FrameToModelOdometry.register_frame``: raycast the model at the
constant-velocity seed → track → ``sparse_integrate`` at the new pose.
The volume and the pose live on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.transform import Transform, se3_exp
from . import linalg
from .registration import _pose_to
from .tsdf import _pixel, _to_device
from .tsdf_raycast import RaycastResult, sparse_raycast
from .tsdf_sparse import SparseTsdfVolume, create_sparse_volume, sparse_integrate

# Gauss-Newton iterations of track() since the last reset_counts()
counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


@dataclasses.dataclass(frozen=True)
class FrameToModelConfig:
    """Tracking + fusion knobs, the JAX package's fields and defaults.
    ``model_render_scale`` renders the tracking model at 1/s resolution;
    ``track_stride`` subsamples the frame for tracking (fusion always
    uses the full frame); ``update_fraction`` as in
    ``tsdf_sparse.sparse_integrate``."""

    max_iterations: int = 10
    dist_gate: float = 0.10          # reject |plane residual| above (m)
    normal_gate: float = 0.5         # reject cos(frame n, model n) below
    near: float = 0.1
    far: float = 6.0
    max_steps: int = 96              # raycast march budget
    depth_scale: float = 1.0
    min_valid_pixels: int = 100      # below → tracking lost, keep pose
    model_render_scale: int = 1
    track_stride: int = 1
    update_fraction: float = 0.5

    def __post_init__(self):
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.model_render_scale < 1:
            raise ValueError("model_render_scale must be >= 1")
        if self.track_stride < 1:
            raise ValueError("track_stride must be >= 1")
        if self.dist_gate <= 0:
            raise ValueError("dist_gate must be positive")
        if not 0.0 < self.update_fraction <= 1.0:
            raise ValueError("update_fraction must be in (0, 1]")


class TrackResult(NamedTuple):
    cam_to_world: torch.Tensor   # (4, 4) refined pose, on the frame's device
    rmse: torch.Tensor           # () plane-residual RMSE (gated set)
    n_valid: torch.Tensor        # () int32 gated correspondences
    converged: torch.Tensor      # () bool: enough correspondences at exit


def _backproject(depth: torch.Tensor, intr: torch.Tensor, depth_scale: float):
    """Depth image → camera-frame vertex map + central-difference normal
    map (normals toward the camera, −z halfspace) and their validity."""
    h, w = depth.shape
    fx, fy, cx, cy = intr
    dev = depth.device
    d = depth.to(torch.float32) / depth_scale
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    pts = torch.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], -1)
    valid = d > 1e-6

    dx = torch.roll(pts, -1, 1) - torch.roll(pts, 1, 1)
    dy = torch.roll(pts, -1, 0) - torch.roll(pts, 1, 0)
    n = torch.linalg.cross(dy, dx)          # n·z < 0 for a wall
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(nn, 1e-12)
    vx = torch.roll(valid, -1, 1) & torch.roll(valid, 1, 1)
    vy = torch.roll(valid, -1, 0) & torch.roll(valid, 1, 0)
    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[1:-1, 1:-1] = True
    return pts, n, valid & vx & vy & border & (nn[..., 0] > 1e-12)


def track(model: RaycastResult, model_cam_to_world, depth, intr, init_cam_to_world,
          max_iterations: int = 10, dist_gate: float = 0.1, normal_gate: float = 0.5,
          depth_scale: float = 1.0, min_valid_pixels: int = 100,
          model_intr=None) -> TrackResult:
    """Align one depth frame to raycast model maps.

    ``model``: raycast of the TSDF from ``model_cam_to_world`` (world-
    space vertices/normals). ``init_cam_to_world``: pose seed for the
    new frame. The model maps may have another resolution than the frame
    (pyramid tracking); pass the intrinsics they were raycast with as
    ``model_intr`` (defaults to ``intr``). Iterates until
    ``max_iterations`` or a step ‖ξ‖ ≤ 1e-6. The pose comes back on the
    model's device; on a track that is lost (fewer than
    ``min_valid_pixels`` correspondences at exit) it is the seed.
    """
    return _track(model, model_cam_to_world, depth, intr, init_cam_to_world, max_iterations,
                  dist_gate, normal_gate, depth_scale, min_valid_pixels, model_intr)[0]


def _track(model, model_cam_to_world, depth, intr, init_cam_to_world, max_iterations,
           dist_gate, normal_gate, depth_scale, min_valid_pixels, model_intr):
    """``track`` and its final pose on the host."""
    dev = model.depth.device
    depth = _to_device(depth, dev)
    intr = _to_device(intr, dev, torch.float32)
    mintr = intr if model_intr is None else _to_device(model_intr, dev, torch.float32)
    mh, mw = model.mask.shape
    fx, fy, cx, cy = mintr
    pts_c, nrm_c, fvalid = _backproject(depth, intr, depth_scale)
    p_f, n_f, okf = pts_c.reshape(-1, 3), nrm_c.reshape(-1, 3), fvalid.reshape(-1)

    # gate on the confident channel when present; vertex(3) + normal(3) +
    # ok(1) packed into one 7-wide map, one row gather a bilinear corner
    ok_src = model.mask if model.confident is None else model.confident
    m_pack = torch.cat([model.vertices.reshape(-1, 3), model.normals.reshape(-1, 3),
                        ok_src.reshape(-1, 1).to(torch.float32)], 1)
    model_pose = _to_device(model_cam_to_world, dev, torch.float32)
    r_m, t_m = model_pose[:3, :3], model_pose[:3, 3]

    def gn_step(t_dev):
        """(6x6 system, rhs, mse, count) at the pose, on the device."""
        r, t = t_dev[:3, :3], t_dev[:3, 3]
        p_w = linalg.fp32_matmul(p_f, r.T) + t
        n_w = linalg.fp32_matmul(n_f, r.T)
        p_mc = linalg.fp32_matmul(p_w - t_m, r_m)            # r_mᵀ (x − t_m)
        z = p_mc[:, 2]
        zc = torch.clamp_min(z, 1e-9)
        uf = _pixel(p_mc[:, 0] / zc, fx, cx)
        vf = _pixel(p_mc[:, 1] / zc, fy, cy)
        u0 = torch.floor(uf).to(torch.int32)
        v0 = torch.floor(vf).to(torch.int32)
        au = (uf - u0.to(torch.float32))[:, None]
        av = (vf - v0.to(torch.float32))[:, None]
        inb = (z > 1e-6) & (u0 >= 0) & (u0 + 1 < mw) & (v0 >= 0) & (v0 + 1 < mh)
        p00 = v0.clamp(0, mh - 2).long() * mw + u0.clamp(0, mw - 2).long()
        c00, c01 = m_pack[p00], m_pack[p00 + 1]
        c10, c11 = m_pack[p00 + mw], m_pack[p00 + mw + 1]
        cb = (1 - av) * ((1 - au) * c00 + au * c01) + av * ((1 - au) * c10 + au * c11)
        q = cb[:, 0:3]
        nq = cb[:, 3:6]
        nq = nq / torch.clamp_min(torch.linalg.vector_norm(nq, dim=1, keepdim=True), 1e-12)
        # ok channel: all four corners valid
        all_ok = torch.minimum(torch.minimum(c00[:, 6], c01[:, 6]),
                               torch.minimum(c10[:, 6], c11[:, 6])) > 0.5
        res = ((p_w - q) * nq).sum(1)
        ok = okf & inb & all_ok & (res.abs() < dist_gate) & ((n_w * nq).sum(1) > normal_gate)
        wgt = ok.to(torch.float32)
        a = torch.cat([torch.linalg.cross(p_w, nq), nq], 1)   # (N, 6)
        aw = a * wgt[:, None]
        hmat = linalg.fp32_matmul(aw.T, a)
        g = -linalg.fp32_matmul(aw.T, res[:, None])[:, 0]
        n_ok = wgt.sum()
        mse = torch.where(ok, res * res, 0.0).sum() / torch.clamp_min(n_ok, 1.0)
        return hmat, g, mse, n_ok

    t0 = _to_device(init_cam_to_world, "cpu", torch.float32)
    t_host = t0
    mse = torch.zeros((), device=dev)
    n_ok = torch.zeros((), device=dev)
    n_host, dxi, step = 0.0, 1.0, 0
    while step < max_iterations and dxi > 1e-6:
        hmat, g, mse, n_ok = gn_step(_pose_to(t_host, dev))
        host = torch.cat([hmat.reshape(36), g, n_ok[None]]).cpu()
        n_host = float(host[42])
        if n_host >= min_valid_pixels:
            xi = linalg.solve_psd(host[:36].reshape(6, 6), host[36:42], damping=1e-6)
        else:
            xi = torch.zeros(6)
        t_host = linalg.fp32_matmul(se3_exp(xi), t_host)
        dxi = float(torch.linalg.vector_norm(xi))
        step += 1
        counts["iterations"] += 1
    t_host = t_host if n_host >= min_valid_pixels else t0
    return TrackResult(_pose_to(t_host, dev), torch.sqrt(mse), n_ok.to(torch.int32),
                       n_ok >= min_valid_pixels), t_host


class FrameToModelOdometry:
    """KinectFusion-style odometry: a sparse TSDF on the card is the map;
    each frame is tracked against its raycast and fused in.

    Mirrors ``KissIcpOdometry``'s surface (``register_frame`` →
    ``Transform``) for depth-camera streams. The volume and the pose
    live on ``device`` (the card unless the caller asks for the CPU); a
    copy of the pose on the host seeds each frame's tracking loop, so
    only the loop's iterations and the raycast's exit tests sync.
    """

    def __init__(self, intrinsics, height: int, width: int, voxel_size: float = 0.02,
                 origin=(-2.0, -2.0, 0.0),
                 grid_blocks: Tuple[int, int, int] = (32, 32, 32),
                 block: int = 8, max_blocks: int = 16384,
                 config: FrameToModelConfig = FrameToModelConfig(),
                 with_color: bool = False, device="cuda"):
        self.config = config
        self.height, self.width = height, width
        self.grid_blocks, self.block = grid_blocks, block
        intr = ([intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy]
                if hasattr(intrinsics, "fx") else intrinsics)
        self.volume: SparseTsdfVolume = create_sparse_volume(
            voxel_size, origin=origin, grid_blocks=grid_blocks, block=block,
            max_blocks=max_blocks, with_color=with_color, device=device)
        self.device = self.volume.tsdf.device
        self._intr_host = _to_device(intr, "cpu", torch.float32)
        self.intr = _to_device(self._intr_host, self.device)
        self._pose_host = torch.eye(4)
        self._prev_delta = torch.eye(4)
        self.pose = _to_device(self._pose_host, self.device)
        self.n_frames = 0
        self.last_track: Optional[TrackResult] = None

    def register_frame(self, depth, rgb=None) -> Transform:
        """Track + fuse one depth frame; returns the world pose."""
        cfg = self.config
        depth = _to_device(depth, self.device)
        if self.n_frames > 0:
            # constant-velocity seed, then raycast the model from it
            seed = linalg.fp32_matmul(self._pose_host, self._prev_delta)
            s = cfg.model_render_scale
            ih = self._intr_host
            if s == 1:
                mintr = ih
            else:
                half = (s - 1.0) / 2.0
                mintr = torch.stack([ih[0] / s, ih[1] / s, (ih[2] - half) / s,
                                     (ih[3] - half) / s])
            model = sparse_raycast(
                self.volume, mintr, seed, self.height // s, self.width // s,
                grid_blocks=self.grid_blocks, block=self.block,
                near=cfg.near, far=cfg.far, max_steps=cfg.max_steps)
            ts = cfg.track_stride
            if ts > 1:
                # a strided slice keeps pixel j·ts as pixel j: u_orig =
                # ts·u_new ⇒ (fx, cx) divide by ts
                tdepth, tintr = depth[::ts, ::ts], ih / ts
                min_px = max(1, cfg.min_valid_pixels // (ts * ts))
            else:
                tdepth, tintr, min_px = depth, ih, cfg.min_valid_pixels
            tr, new_pose = _track(model, seed, tdepth, tintr, seed, cfg.max_iterations,
                                  cfg.dist_gate, cfg.normal_gate, cfg.depth_scale, min_px,
                                  mintr)
            self.last_track = tr
            self._prev_delta = linalg.fp32_matmul(
                Transform(self._pose_host).inverse().matrix, new_pose)
            self._pose_host = new_pose
            self.pose = tr.cam_to_world
        self.volume = sparse_integrate(
            self.volume, depth, self.intr, self.pose, grid_blocks=self.grid_blocks,
            block=self.block, rgb=rgb, depth_scale=cfg.depth_scale,
            update_fraction=cfg.update_fraction)
        self.n_frames += 1
        return Transform(self.pose)

    def render(self, cam_to_world=None) -> RaycastResult:
        """Raycast the current model (default: from the current pose)."""
        pose = self.pose if cam_to_world is None else cam_to_world
        cfg = self.config
        return sparse_raycast(self.volume, self.intr, pose, self.height, self.width,
                              grid_blocks=self.grid_blocks, block=self.block,
                              near=cfg.near, far=cfg.far, max_steps=cfg.max_steps)
