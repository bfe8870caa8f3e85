"""TSDF fusion: projective truncated-signed-distance integration.

Counterpart of ``threecrate_tpu.ops.tsdf``: a dense ``(nx, ny, nz)``
volume of truncated signed distances and weights (and optionally
colours) resident on one device; ``integrate`` fuses one depth frame
with the per-voxel projective update (voxel → camera → pixel, truncated
SDF, weighted running average) as elementwise passes over the grid;
``extract_surface`` emits the zero crossings against the +x/+y/+z
neighbours, and the banded variant does the same over only the
``block``³ regions whose window holds both signs.

Volumes are built on the card unless the caller asks for the CPU.
Projections run in full fp32 (``linalg.fp32_matmul``), as the JAX
package forces ``Precision.HIGHEST``. The valid-first compactions keep
input order among ties, the order JAX's one-key payload sorts give.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.point_cloud import PointCloud
from .linalg import fp32_matmul
from .registration import _pose_to


class TsdfVolume(NamedTuple):
    """Volume state; an update returns a new volume."""

    tsdf: torch.Tensor            # (nx, ny, nz) f32 in [-1, 1]
    weight: torch.Tensor          # (nx, ny, nz) f32
    color: Optional[torch.Tensor]  # (nx, ny, nz, 3) f32 or None
    origin: torch.Tensor          # (3,)
    voxel_size: torch.Tensor      # () f32
    truncation: torch.Tensor      # () f32

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.tsdf.shape)


def _to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or nested list) as a tensor on
    ``device``; a host tensor reaches the card from pinned memory without
    blocking (``registration._pose_to``)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    if dtype is not None:
        x = x.to(dtype)
    if x.device == torch.device(device):
        return x
    if x.device.type == "cpu":
        return _pose_to(x.contiguous(), device)
    return x.to(device)


def _pixel(x_over_z: torch.Tensor, f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pixel coordinate x/z·f + c as one fused multiply-add, so the product
    is not rounded on its own: a voxel's pixel is its rounding, and a
    tracked pixel's bilinear cell its floor, where a frame pixel seen
    from its own pose lands within an ulp of an integer. XLA contracts
    the same expression, and the card's kernel does too."""
    return torch.addcmul(c, x_over_z, f)


def create_volume(resolution: Tuple[int, int, int], voxel_size: float,
                  origin=(0.0, 0.0, 0.0), truncation: Optional[float] = None,
                  with_color: bool = False, device="cuda") -> TsdfVolume:
    """Fresh volume on ``device`` (the card unless the caller asks for
    the CPU). Truncation defaults to 4 voxels."""
    nx, ny, nz = resolution
    trunc = truncation if truncation is not None else 4.0 * voxel_size
    f32 = dict(dtype=torch.float32, device=device)
    return TsdfVolume(
        tsdf=torch.ones((nx, ny, nz), **f32),
        weight=torch.zeros((nx, ny, nz), **f32),
        color=torch.zeros((nx, ny, nz, 3), **f32) if with_color else None,
        origin=torch.tensor(origin, **f32),
        voxel_size=torch.tensor(voxel_size, **f32),
        truncation=torch.tensor(trunc, **f32))


def _centers(origin, idx, voxel_size) -> torch.Tensor:
    """World centres of integer voxel indices (..., 3); one formula for
    the dense and the banded extraction, so their points agree bit for
    bit."""
    return origin + (idx.to(torch.float32) + 0.5) * voxel_size


def _voxel_centers(vol: TsdfVolume) -> torch.Tensor:
    nx, ny, nz = vol.resolution
    dev = vol.tsdf.device
    idx = torch.stack(torch.meshgrid(torch.arange(nx, device=dev), torch.arange(ny, device=dev),
                                     torch.arange(nz, device=dev), indexing="ij"), dim=-1)
    return _centers(vol.origin, idx, vol.voxel_size)


def _project(points: torch.Tensor, intr: torch.Tensor, cam_to_world: torch.Tensor,
             h: int, w: int):
    """Each world point's pixel in an (h, w) image: (column, row) clipped
    into the image, the in-image flag (in front of the camera too) and
    the camera-frame depth z."""
    fx, fy, cx, cy = intr
    r, t = cam_to_world[:3, :3], cam_to_world[:3, 3]
    cam = fp32_matmul(points - t, r)                   # Rᵀ (x − t)
    z = cam[..., 2]
    zc = torch.clamp_min(z, 1e-9)
    ui = torch.round(_pixel(cam[..., 0] / zc, fx, cx)).to(torch.int32)
    vi = torch.round(_pixel(cam[..., 1] / zc, fy, cy)).to(torch.int32)
    in_img = (z > 1e-6) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    return ui.clamp_(0, w - 1).long(), vi.clamp_(0, h - 1).long(), in_img, z


def integrate(vol: TsdfVolume, depth, intr, cam_to_world, rgb=None,
              depth_scale: float = 1.0, max_weight: float = 64.0) -> TsdfVolume:
    """Fuse one depth frame.

    depth: (H, W) in meters·depth_scale (0 = invalid). intr: (4,)
    [fx, fy, cx, cy]. cam_to_world: (4, 4) camera pose; the world →
    camera map is its transpose applied on the device.
    """
    dev = vol.tsdf.device
    depth = _to_device(depth, dev)
    intr = _to_device(intr, dev, torch.float32)
    pose = _to_device(cam_to_world, dev, torch.float32)
    ui, vi, in_img, z = _project(_voxel_centers(vol), intr, pose, *depth.shape)

    d = depth[vi, ui].to(torch.float32) / depth_scale
    valid = in_img & (d > 1e-6)
    sdf = d - z
    update = valid & (sdf > -vol.truncation)
    tsdf_new = torch.clamp(sdf / vol.truncation, -1.0, 1.0)

    w_old = vol.weight
    w_add = update.to(torch.float32)
    w_sum = w_old + w_add
    w_new = torch.clamp_max(w_sum, max_weight)
    denom = torch.clamp_min(w_sum, 1e-9)
    fused = torch.where(update, (vol.tsdf * w_old + tsdf_new * w_add) / denom, vol.tsdf)

    color = vol.color
    if color is not None and rgb is not None:
        c = _to_device(rgb, dev)[vi, ui].to(torch.float32)
        cf = (color * w_old[..., None] + c * w_add[..., None]) / denom[..., None]
        color = torch.where(update[..., None], cf, color)

    return TsdfVolume(fused, w_new, color, vol.origin, vol.voxel_size, vol.truncation)


def integrate_sequence(vol: TsdfVolume, depths, intr, poses,
                       depth_scale: float = 1.0) -> TsdfVolume:
    """Fuse a whole (T, H, W) depth sequence, frame by frame."""
    for depth, pose in zip(depths, poses):
        vol = integrate(vol, depth, intr, pose, depth_scale=depth_scale)
    return vol


class SurfacePoints(NamedTuple):
    cloud: PointCloud
    count: torch.Tensor


def _valid_first_order(ok: torch.Tensor) -> torch.Tensor:
    """The permutation that moves the rows where ``ok`` holds to the
    front and keeps input order on each side: what a one-key payload
    sort on (0 if ok else 1) gives when it keeps ties in input order.
    A prefix sum, no sort and no host sync."""
    n = ok.shape[0]
    c = torch.cumsum(ok.to(torch.int64), 0)
    ar = torch.arange(n, device=ok.device)
    pos = torch.where(ok, c - 1, c[-1] + ar - c)
    return torch.empty_like(ar).index_copy_(0, pos, ar)


def _surface(pts: torch.Tensor, ok: torch.Tensor) -> SurfacePoints:
    """Crossing rows compacted valid-first (the row count is kept)."""
    order = _valid_first_order(ok)
    cloud = PointCloud(pts[order], ok[order], {})
    return SurfacePoints(cloud, ok.sum().to(torch.int32))


def _crossings(cur_t, sh_t, cur_w, sh_w, min_weight):
    """(crossing flag, fraction to the crossing) against the shifted
    neighbour: a sign change between two observed voxels."""
    diff = cur_t - sh_t
    big = diff.abs() > 1e-12
    cross = (torch.sign(cur_t) != torch.sign(sh_t)) & (cur_w >= min_weight) \
        & (sh_w >= min_weight) & big
    return cross, cur_t / torch.where(big, diff, 1.0)


def _axis_offset(axis: int, voxel_size: torch.Tensor) -> torch.Tensor:
    """voxel_size along ``axis``, 0 on the others."""
    unit = torch.arange(3, device=voxel_size.device) == axis   # built on the device
    return unit.to(torch.float32) * voxel_size


def extract_surface(vol: TsdfVolume, min_weight: float = 1.0) -> SurfacePoints:
    """Zero-crossing point extraction: for each voxel whose TSDF changes
    sign against its +x/+y/+z neighbour, the linearly interpolated
    crossing. Capacity 3·grid, crossings first."""
    tsdf, weight = vol.tsdf, vol.weight
    centers = _voxel_centers(vol)
    pts_list, ok_list = [], []
    for axis in range(3):
        n = tsdf.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        interior = (torch.arange(n, device=tsdf.device) < n - 1).reshape(shape)
        cross, frac = _crossings(tsdf, torch.roll(tsdf, -1, axis), weight,
                                 torch.roll(weight, -1, axis), min_weight)
        p = centers + frac[..., None] * _axis_offset(axis, vol.voxel_size)
        pts_list.append(p.reshape(-1, 3))
        ok_list.append((cross & interior).reshape(-1))
    return _surface(torch.cat(pts_list), torch.cat(ok_list))


def _pad_surface_blocks(tsdf: torch.Tensor, weight: torch.Tensor, block: int):
    """Pad so the crossing-pair grid (dims−1 pairs per axis) tiles into
    ``block``³ blocks with a +1 apron. tsdf edge-replicates (equal
    values ⇒ no fake crossings), weight zero-pads (padded voxels never
    pass the min_weight gate)."""
    nb = tuple(-(-(n - 1) // block) for n in tsdf.shape)
    sizes = [b * block + 1 for b in nb]
    ix, iy, iz = (torch.arange(s, device=tsdf.device).clamp_max(n - 1)
                  for s, n in zip(sizes, tsdf.shape))
    tp = tsdf[ix[:, None, None], iy[None, :, None], iz[None, None, :]]
    wp = torch.zeros(sizes, dtype=weight.dtype, device=weight.device)
    nx, ny, nz = weight.shape
    wp[:nx, :ny, :nz] = weight
    return tp, wp, nb


def _active_blocks(tp, wp, min_weight, block) -> torch.Tensor:
    """(nbx, nby, nbz) flags: the block's (B+1)³ window holds both signs
    among weight-observed voxels (a superset of the blocks that emit)."""
    s1 = block + 1
    obs = wp >= min_weight

    def windows(x):
        return x.unfold(0, s1, block).unfold(1, s1, block).unfold(2, s1, block)

    mn = windows(torch.where(obs, tp, torch.inf)).amin((-3, -2, -1))
    mx = windows(torch.where(obs, tp, -torch.inf)).amax((-3, -2, -1))
    return (mn <= 0.0) & (mx >= 0.0)


def _surface_active_count(vol: TsdfVolume, min_weight: float = 1.0,
                          block: int = 8) -> torch.Tensor:
    """Sizing pass: the number of crossing-capable blocks."""
    tp, wp, _ = _pad_surface_blocks(vol.tsdf, vol.weight, block)
    return _active_blocks(tp, wp, min_weight, block).sum().to(torch.int32)


def extract_surface_banded(vol: TsdfVolume, min_weight: float = 1.0,
                           block: int = 8, max_blocks: int = 4096) -> SurfacePoints:
    """Band-compacted zero-crossing extraction: the crossing-capable
    ``block``³ regions (window min/max over weight-observed tsdf) are
    compacted active-first to at most ``max_blocks`` and each emits the
    dense path's points (the same arithmetic on the same inputs, so the
    point set equals the dense one when the active count fits the cap).
    Capacity ``max_blocks · 3 · block³``."""
    tsdf, weight = vol.tsdf, vol.weight
    dev = tsdf.device
    b, s1 = block, block + 1
    tp, wp, (nbx, nby, nbz) = _pad_surface_blocks(tsdf, weight, b)
    active = _active_blocks(tp, wp, min_weight, b).reshape(-1)
    cap = min(max_blocks, nbx * nby * nbz)
    sel = _valid_first_order(active)[:cap]
    live = active[sel]
    corners = torch.stack([sel // (nby * nbz), (sel // nbz) % nby, sel % nbz], 1) * b

    ar = torch.arange(s1, device=dev)
    ix, iy, iz = (corners[:, a, None] + ar for a in range(3))            # (cap, s1)
    sel_win = (ix[:, :, None, None], iy[:, None, :, None], iz[:, None, None, :])
    t_win, w_win = tp[sel_win], wp[sel_win]                               # (cap, s1³)

    dims = tsdf.shape
    gidx = corners[:, None, None, None, :] + torch.stack(torch.meshgrid(
        ar[:b], ar[:b], ar[:b], indexing="ij"), -1)                       # (cap, b, b, b, 3)
    centers = _centers(vol.origin, gidx, vol.voxel_size)
    inb = (gidx[..., 0] < dims[0]) & (gidx[..., 1] < dims[1]) & (gidx[..., 2] < dims[2])
    cur = (slice(None), slice(0, b), slice(0, b), slice(0, b))
    pts_l, ok_l = [], []
    for axis in range(3):
        sh = list(cur)
        sh[axis + 1] = slice(1, s1)
        cross, frac = _crossings(t_win[cur], t_win[tuple(sh)], w_win[cur],
                                 w_win[tuple(sh)], min_weight)
        cross = cross & (gidx[..., axis] < dims[axis] - 1) & inb
        p = centers + frac[..., None] * _axis_offset(axis, vol.voxel_size)
        pts_l.append(p.reshape(cap, -1, 3))
        ok_l.append(cross.reshape(cap, -1))
    pts = torch.cat(pts_l, 1).reshape(-1, 3)
    ok = (torch.cat(ok_l, 1) & live[:, None]).reshape(-1)
    return _surface(pts, ok)


def extract_surface_banded_auto(vol: TsdfVolume, min_weight: float = 1.0,
                                block: int = 8,
                                dense_fraction: float = 0.5) -> SurfacePoints:
    """Banded extraction with its capacity sized on the host (the
    active-block count rounded up to a power of two, at least 256);
    the dense sweep when the surface touches more than
    ``dense_fraction`` of all blocks."""
    n_act = int(_surface_active_count(vol, min_weight, block=block))
    nx, ny, nz = vol.resolution
    nb = (-(-(nx - 1) // block)) * (-(-(ny - 1) // block)) * (-(-(nz - 1) // block))
    if n_act > dense_fraction * nb:
        return extract_surface(vol, min_weight)
    cap = 256
    while cap < n_act:
        cap *= 2
    return extract_surface_banded(vol, min_weight, block=block, max_blocks=min(cap, nb))


def integrate_cloud(vol: TsdfVolume, cloud: PointCloud,
                    sensor_origin=(0.0, 0.0, 0.0)) -> TsdfVolume:
    """Point-cloud carving variant: the nearest-point distance field on
    the grid, signed by range along the sensor ray (for LiDAR clouds
    without a depth image)."""
    from . import neighbors

    centers = _voxel_centers(vol)
    res = neighbors.knn(cloud.points, cloud.mask, centers.reshape(-1, 3), None, 1,
                        query_chunk=16384)
    d = res.distances[:, 0].reshape(vol.resolution)
    origin = torch.as_tensor(sensor_origin, dtype=torch.float32, device=centers.device)
    voxel_r = torch.linalg.vector_norm(centers - origin, dim=-1)
    nearest = cloud.points[res.indices[:, 0]].reshape(*vol.resolution, 3)
    point_r = torch.linalg.vector_norm(nearest - origin, dim=-1)
    sdf = torch.where(voxel_r <= point_r, d, -d)     # inside/outside by range
    update = torch.isfinite(d) & (sdf > -vol.truncation)
    tsdf_new = torch.clamp(sdf / vol.truncation, -1.0, 1.0)
    w_add = update.to(torch.float32)
    denom = torch.clamp_min(vol.weight + w_add, 1e-9)
    fused = torch.where(update, (vol.tsdf * vol.weight + tsdf_new * w_add) / denom, vol.tsdf)
    return TsdfVolume(fused, vol.weight + w_add, vol.color, vol.origin,
                      vol.voxel_size, vol.truncation)
