"""Block-sparse TSDF fusion: allocate only blocks near the surface.

Counterpart of ``threecrate_tpu.ops.tsdf_sparse``. The volume is a
fixed-capacity table of ``max_blocks`` blocks, each storing (B+1)³
voxels: a one-voxel apron overlapping the +x/+y/+z neighbours, updated
independently by ``sparse_integrate`` (the same projective update), so
surface extraction needs no cross-block lookups.

Allocation samples each depth ray at ±truncation, keys the covering
blocks and merges them with the existing keys by a sort and run-head
compaction; the storage follows the new key order through one
``searchsorted`` and a row gather, fresh blocks initialised inline. The
projective update then runs only over rows whose block or high-side
neighbours lie in this frame's band, compacted active-first to
``update_fraction``·max_blocks rows. Blocks beyond ``max_blocks`` are
dropped deterministically (lowest keys kept) and ``n_blocks`` is capped.
One frame runs without a host sync; tables live on the volume's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .linalg import fp32_matmul
from .tsdf import (SurfacePoints, TsdfVolume, _axis_offset, _crossings, _project, _surface,
                   _valid_first_order, _to_device)

_INVALID = 2 ** 31 - 1


class SparseTsdfVolume(NamedTuple):
    block_keys: torch.Tensor   # (max_blocks,) int32 sorted linear block keys
    n_blocks: torch.Tensor     # () int32: allocated count
    tsdf: torch.Tensor         # (max_blocks, (B+1)^3) f32, apron layout
    weight: torch.Tensor       # (max_blocks, (B+1)^3) f32
    origin: torch.Tensor       # (3,)
    voxel_size: torch.Tensor   # () f32
    truncation: torch.Tensor   # () f32
    color: Optional[torch.Tensor] = None  # (max_blocks, (B+1)^3, 3)

    @property
    def max_blocks(self) -> int:
        return self.block_keys.shape[0]


def create_sparse_volume(voxel_size: float, origin=(0.0, 0.0, 0.0),
                         grid_blocks: Tuple[int, int, int] = (64, 64, 64),
                         block: int = 8, max_blocks: int = 8192,
                         truncation: Optional[float] = None,
                         with_color: bool = False, device="cuda") -> SparseTsdfVolume:
    """Empty sparse volume spanning ``grid_blocks`` blocks of ``block``³
    voxels each, on ``device`` (the card unless the caller asks for the
    CPU). ``block`` and ``grid_blocks`` are passed again to the
    functions below."""
    trunc = truncation if truncation is not None else 4.0 * voxel_size
    s = (block + 1) ** 3
    f32 = dict(dtype=torch.float32, device=device)
    return SparseTsdfVolume(
        block_keys=torch.full((max_blocks,), _INVALID, dtype=torch.int32, device=device),
        n_blocks=torch.zeros((), dtype=torch.int32, device=device),
        tsdf=torch.ones((max_blocks, s), **f32),
        weight=torch.zeros((max_blocks, s), **f32),
        origin=torch.tensor(origin, **f32),
        voxel_size=torch.tensor(voxel_size, **f32),
        truncation=torch.tensor(trunc, **f32),
        color=torch.zeros((max_blocks, s, 3), **f32) if with_color else None)


def _decode_keys(keys, gy: int, gz: int):
    bz = keys % gz
    by = (keys // gz) % gy
    bx = keys // (gy * gz)
    return bx, by, bz


def _ray_offsets(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in fp32 as JAX forms it:
    −1·(1 − s) + 1·s at s = i/(n−1), the last point exactly 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    return torch.cat([-(1 - s) + s, torch.ones(1, device=device)])


def _local_grid(s1: int, device) -> torch.Tensor:
    """(s1³, 3) voxel centres of a block in voxel units, flat index
    (x·s1 + y)·s1 + z."""
    li = torch.arange(s1, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(li, li, li, indexing="ij"), -1).reshape(-1, 3) + 0.5


def sparse_integrate(vol: SparseTsdfVolume, depth, intr, cam_to_world,
                     grid_blocks: Tuple[int, int, int], block: int = 8,
                     rgb=None, depth_scale: float = 1.0, ray_samples: int = 3,
                     max_weight: float = 64.0, update_fraction: float = 0.5,
                     key_range: Optional[Tuple] = None) -> SparseTsdfVolume:
    """Allocate and fuse one depth frame (the sparse analog of
    ``ops.tsdf.integrate``, with the same projective update).

    The update touches only rows in THIS frame's truncation band,
    compacted active-first to ``update_fraction``·max_blocks rows; a
    frame whose band exceeds that cap updates the lowest rows and defers
    the rest (their allocation is kept); 1.0 updates every row.
    ``key_range`` ``(lo, hi)`` restricts allocation to block keys in
    ``[lo, hi)``.
    """
    gx, gy, gz = grid_blocks
    dev = vol.block_keys.device
    depth = _to_device(depth, dev, torch.float32)
    intr = _to_device(intr, dev, torch.float32)
    fx, fy, cx, cy = intr
    pose = _to_device(cam_to_world, dev, torch.float32)
    bsz = vol.voxel_size * block
    h, w = depth.shape
    r, t = pose[:3, :3], pose[:3, 3]

    # ---- 1. allocation: blocks within ±truncation of each depth ray --
    d = depth.reshape(-1) / depth_scale
    u = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    v = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    dir_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], 1)
    offs = _ray_offsets(ray_samples, dev) * vol.truncation
    new_keys = []
    for i in range(ray_samples):
        z = d + offs[i]
        p_w = fp32_matmul(dir_cam * z[:, None], r.T) + t
        b = torch.floor((p_w - vol.origin) / bsz).to(torch.int32)
        ok = (d > 1e-6) & (z > 1e-6) \
            & (b[:, 0] >= 0) & (b[:, 0] < gx) & (b[:, 1] >= 0) & (b[:, 1] < gy) \
            & (b[:, 2] >= 0) & (b[:, 2] < gz)
        key = (b[:, 0] * gy + b[:, 1]) * gz + b[:, 2]
        if key_range is not None:
            ok = ok & (key >= key_range[0]) & (key < key_range[1])
        new_keys.append(torch.where(ok, key, _INVALID))
    fkeys = torch.sort(torch.cat(new_keys)).values

    # sorted run heads, the lowest max_blocks of them kept, in key order
    skeys = torch.sort(torch.cat([vol.block_keys, fkeys])).values
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), skeys[1:] != skeys[:-1]])
    head = head & (skeys != _INVALID)
    mb = vol.max_blocks
    rank = torch.cumsum(head, 0) - 1
    keys_out = torch.full((mb + 1,), _INVALID, dtype=torch.int32, device=dev)
    keys_out[torch.where(head & (rank < mb), rank, mb)] = skeys   # row mb: the dropped
    keys_out = keys_out[:mb]
    n_new = torch.clamp_max(head.sum(), mb).to(torch.int32)

    # ---- 2. realign storage to the new key order ---------------------
    old_pos = torch.searchsorted(vol.block_keys, keys_out).clamp_(0, mb - 1)
    existed = (vol.block_keys[old_pos] == keys_out) & (keys_out != _INVALID)
    tsdf = torch.where(existed[:, None], vol.tsdf[old_pos], 1.0)
    weight = torch.where(existed[:, None], vol.weight[old_pos], 0.0)
    color = None
    if vol.color is not None:
        color = torch.where(existed[:, None, None], vol.color[old_pos], 0.0)

    # ---- 3. projective update over the frame's band blocks -----------
    # a row can change only if its interior or its apron layer (owned by
    # the 7 high-side neighbours) lies in this frame's band
    s1 = block + 1

    def in_band(k):
        pos = torch.searchsorted(fkeys, k).clamp_(0, fkeys.shape[0] - 1)
        return fkeys[pos] == k

    bx0, by0, bz0 = _decode_keys(torch.clamp_min(keys_out, 0), gy, gz)
    active = torch.zeros(mb, dtype=torch.bool, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                nx_, ny_, nz_ = bx0 + dx, by0 + dy, bz0 + dz
                okn = (nx_ < gx) & (ny_ < gy) & (nz_ < gz)
                active |= okn & in_band((nx_ * gy + ny_) * gz + nz_)
    active &= keys_out != _INVALID

    cap = max(1, min(mb, int(round(mb * update_fraction))))
    sel = _valid_first_order(active)[:cap]
    t_sel, w_sel, act_sel = tsdf[sel], weight[sel], active[sel]

    bx, by, bz = _decode_keys(torch.clamp_min(keys_out[sel], 0), gy, gz)
    corner = vol.origin + torch.stack([bx, by, bz], 1).to(torch.float32) * bsz   # (cap, 3)
    centers = corner[:, None, :] + _local_grid(s1, dev)[None] * vol.voxel_size
    ui, vi, in_img, z = _project(centers, intr, pose, h, w)
    dd = (depth / depth_scale)[vi, ui]                  # (cap, s1³)
    valid = in_img & (dd > 1e-6) & act_sel[:, None]
    sdf = dd - z
    update = valid & (sdf > -vol.truncation)
    tsdf_new = torch.clamp(sdf / vol.truncation, -1.0, 1.0)
    w_add = update.to(torch.float32)
    w_sum = w_sel + w_add
    denom = torch.clamp_min(w_sum, 1e-9)
    fused = torch.where(update, (t_sel * w_sel + tsdf_new * w_add) / denom, t_sel)
    tsdf[sel] = fused
    weight[sel] = torch.clamp_max(w_sum, max_weight)

    if color is not None and rgb is not None:
        c_sel = color[sel]
        c = _to_device(rgb, dev, torch.float32)[vi, ui]  # (cap, s1³, 3)
        cf = (c_sel * w_sel[..., None] + c * w_add[..., None]) / denom[..., None]
        color[sel] = torch.where(update[..., None], cf, c_sel)

    return SparseTsdfVolume(keys_out, n_new, tsdf, weight, vol.origin, vol.voxel_size,
                            vol.truncation, color)


def sparse_extract_surface(vol: SparseTsdfVolume, grid_blocks: Tuple[int, int, int],
                           block: int = 8, min_weight: float = 1.0) -> SurfacePoints:
    """Zero-crossing surface points (the sparse analog of
    ``ops.tsdf.extract_surface``): +x/+y/+z sign changes within each
    block's apron grid, emitted only from cubes whose low corner lies in
    the block's own region."""
    gx, gy, gz = grid_blocks
    s1 = block + 1
    mb = vol.max_blocks
    dev = vol.tsdf.device
    tsdf = vol.tsdf.reshape(mb, s1, s1, s1)
    wgt = vol.weight.reshape(mb, s1, s1, s1)
    bx, by, bz = _decode_keys(torch.clamp_min(vol.block_keys, 0), gy, gz)
    corner = vol.origin + torch.stack([bx, by, bz], 1).to(torch.float32) \
        * (vol.voxel_size * block)
    alive = vol.block_keys != _INVALID
    base = _local_grid(s1, dev).reshape(s1, s1, s1, 3)

    pts_list, ok_list = [], []
    for axis in range(3):
        lo = [slice(None)] * 3
        lo[axis] = slice(0, s1 - 1)
        hi = [slice(None)] * 3
        hi[axis] = slice(1, s1)
        a, b = tsdf[(slice(None), *lo)], tsdf[(slice(None), *hi)]
        cross, frac = _crossings(a, b, wgt[(slice(None), *lo)], wgt[(slice(None), *hi)],
                                 min_weight)
        keep = torch.zeros(a.shape[1:], dtype=torch.bool, device=dev)
        keep[:block, :block, :block] = True
        cross = cross & alive[:, None, None, None] & keep
        off = _axis_offset(axis, torch.ones((), device=dev))
        p_local = base[tuple(lo)] + frac[..., None] * off
        p = corner[:, None, None, None, :] + p_local * vol.voxel_size
        pts_list.append(p.reshape(mb, -1, 3))
        ok_list.append(cross.reshape(mb, -1))
    return _surface(torch.cat(pts_list, 1).reshape(-1, 3), torch.cat(ok_list, 1).reshape(-1))


def sparse_to_dense(vol: SparseTsdfVolume, grid_blocks: Tuple[int, int, int],
                    block: int = 8) -> TsdfVolume:
    """Materialise the dense TsdfVolume (parity/testing): each allocated
    block's own B³ region is written into its place; aprons are
    dropped. Reads ``n_blocks`` on the host."""
    gx, gy, gz = grid_blocks
    s1 = block + 1
    dev = vol.tsdf.device
    n = int(vol.n_blocks)
    keys = vol.block_keys[:n].long()

    def dense(field, fill):
        out = torch.full((gx * gy * gz, block, block, block), fill, dtype=torch.float32,
                         device=dev)
        out[keys] = field.reshape(-1, s1, s1, s1)[:n, :block, :block, :block]
        return out.reshape(gx, gy, gz, block, block, block).permute(0, 3, 1, 4, 2, 5) \
            .reshape(gx * block, gy * block, gz * block)

    return TsdfVolume(dense(vol.tsdf, 1.0), dense(vol.weight, 0.0), None, vol.origin,
                      vol.voxel_size, vol.truncation)


def sparse_marching_cubes_soup(vol: SparseTsdfVolume, grid_blocks: Tuple[int, int, int],
                               block: int = 8, iso_level: float = 0.0,
                               min_weight: float = 1.0):
    """Marching cubes over allocated blocks only: the cube extractor of
    ``reconstruction.marching_cubes`` runs over every row's (B+1)³ apron
    grid at once. The apron makes the cubes an exact partition (each
    block owns the B³ cubes whose low corner lies in its own region, and
    apron voxels equal the neighbour's own), so the mesh is seamless with
    no cross-block lookups. Voxels below ``min_weight`` read as far (1).
    Returns a ``TriangleSoup`` on the volume's device (weld it with
    ``reconstruction.marching_cubes.soup_to_mesh``)."""
    from ..reconstruction.marching_cubes import TriangleSoup, _cubes_soup

    gx, gy, gz = grid_blocks
    s1 = block + 1
    mb = vol.max_blocks
    tsdf = vol.tsdf.reshape(mb, s1, s1, s1)
    wgt = vol.weight.reshape(mb, s1, s1, s1)
    vals = torch.where(wgt >= min_weight, tsdf, 1.0)
    bx, by, bz = _decode_keys(torch.clamp_min(vol.block_keys, 0), gy, gz)
    # grid nodes sit at voxel centres (the dense volume's convention); the
    # block corner is one fused multiply-add, as XLA forms it
    corner = torch.addcmul(vol.origin, torch.stack([bx, by, bz], 1).to(torch.float32),
                           vol.voxel_size * block) + 0.5 * vol.voxel_size
    alive = vol.block_keys != _INVALID
    iso = torch.as_tensor(iso_level, dtype=torch.float32, device=vals.device)
    verts, masks = _cubes_soup(vals, iso, corner[:, None, :], vol.voxel_size)
    return TriangleSoup(verts.reshape(-1, 3), (masks & alive[:, None]).reshape(-1))


def sparse_integrate_sequence(vol: SparseTsdfVolume, depths, intr, poses,
                              grid_blocks: Tuple[int, int, int], block: int = 8,
                              depth_scale: float = 1.0, ray_samples: int = 3,
                              max_weight: float = 64.0) -> SparseTsdfVolume:
    """Fuse a (T, H, W) depth sequence, frame by frame."""
    for depth, pose in zip(depths, poses):
        vol = sparse_integrate(vol, depth, intr, pose, grid_blocks=grid_blocks, block=block,
                               depth_scale=depth_scale, ray_samples=ray_samples,
                               max_weight=max_weight)
    return vol
