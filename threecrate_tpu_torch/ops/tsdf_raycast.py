"""TSDF raycasting: per-pixel ray marching over dense and block-sparse
volumes.

Counterpart of ``threecrate_tpu.ops.tsdf_raycast``: all H·W rays march
together; each step costs one nearest-voxel fetch per ray, with the
step scaled by the fetched value (a voxel that reads "far" cannot hide a
surface within 0.75·truncation), and an unallocated block of a sparse
volume is crossed in one jump to its exit. The zero crossing is then
refined once per ray by a secant on trilinear samples at a bracket
centred on the nearest-sample zero, and the normal comes from the
trilinear gradient. Unobserved voxels (weight 0) read as free space
during the march but invalidate a crossing. A coarse pass at 1/f²
of the rays seeds the full pass (``coarse_factor``).

The march is a Python loop that tests its exit (no ray left active)
once every ``EXIT_TEST_EVERY`` steps, each test one host sync; the
step body leaves a finished ray unchanged, so the maps equal those of a
loop that tests every step. ``counts`` holds the steps and tests since
``reset_counts()``.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .linalg import fp32_matmul
from .tsdf import TsdfVolume, _to_device
from .tsdf_sparse import _INVALID, SparseTsdfVolume

# steps between two exit tests of the march (each test a host sync)
EXIT_TEST_EVERY = 1

# march steps and exit tests since the last reset_counts()
counts = collections.Counter()


def reset_counts() -> None:
    counts.clear()


class RaycastResult(NamedTuple):
    """Synthetic camera maps from one raycast pass."""

    depth: torch.Tensor     # (H, W) f32 ray depth (z in camera), 0 = miss
    vertices: torch.Tensor  # (H, W, 3) f32 world-space hit points
    normals: torch.Tensor   # (H, W, 3) f32 world-space unit normals
    mask: torch.Tensor      # (H, W) bool
    # mask minus grazing/border hits whose trilinear bracket had no sign
    # change (their depth comes from the nearest-sample interpolation)
    confident: Optional[torch.Tensor] = None  # (H, W) bool
    # nearest-voxel colour at the hit point when the volume carries one
    color: Optional[torch.Tensor] = None      # (H, W, 3) f32


# ---------------------------------------------------------------------------
# samplers: value at a world point + (for trilinear) gradient
# ---------------------------------------------------------------------------

_UNOBS = 2.0         # sentinel: > 1 ⇒ unobserved / out of volume
_EMPTY_BLOCK = 3.0   # sentinel: unallocated block (skippable)

# budget for materialising a block-major dense copy of the sparse table
# before marching (512^3 f32 = 512 MB fits; 1024^3 doesn't)
_MATERIALIZE_BUDGET_BYTES = 768 * 1024 * 1024

_CORNER_OFFS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _encode_observed(tsdf: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The weight > 0 flag folded into the values once: unobserved
    voxels read the sentinel 2.0, so a march step costs one gather."""
    return torch.where(weight.reshape(-1) > 0, tsdf.reshape(-1), _UNOBS)


def _grid(vol, p: torch.Tensor) -> torch.Tensor:
    """Continuous voxel coordinates of world points (voxel centres at
    integers)."""
    return (p - vol.origin) / vol.voxel_size - 0.5


def _inside(i, hi) -> torch.Tensor:
    """0 <= i[:, a] < hi[a] on every axis."""
    return (i >= 0).all(1) & (i[:, 0] < hi[0]) & (i[:, 1] < hi[1]) & (i[:, 2] < hi[2])


def _clip(i, hi) -> torch.Tensor:
    """Columns of i clipped to [0, hi[a]]."""
    return torch.stack([i[:, a].clamp(0, hi[a]) for a in range(3)], 1)


def _shifted(v0, off) -> torch.Tensor:
    return torch.stack([v0[:, a] + off[a] for a in range(3)], 1)


def _dense_nearest(enc: torch.Tensor, vol: TsdfVolume, p: torch.Tensor):
    """Nearest-voxel encoded TSDF at world points p (R, 3); out-of-volume
    and unobserved voxels read (1.0, observed=False)."""
    nx, ny, nz = vol.resolution
    i = torch.round(_grid(vol, p)).to(torch.int32)
    inb = _inside(i, vol.resolution)
    i = _clip(i, (nx - 1, ny - 1, nz - 1))
    lin = (i[:, 0] * ny + i[:, 1]) * nz + i[:, 2]
    v = torch.where(inb, enc[lin], _UNOBS)
    return torch.clamp_max(v, 1.0), v < 1.5


def _corner_weights(f: torch.Tensor):
    """Trilinear corner weights (R, 8) and the per-axis factors, corner
    order (dx, dy, dz) lexicographic."""
    wx = torch.stack([1 - f[:, 0], f[:, 0]], 1)
    wy = torch.stack([1 - f[:, 1], f[:, 1]], 1)
    wz = torch.stack([1 - f[:, 2], f[:, 2]], 1)
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1, 8)
    return w, (wx, wy, wz)


def _trilinear_from_corners(vals, obs, f, voxel):
    """Value, gradient (world units) and all-corners-observed flag from
    8 corner samples (R, 8) in (dx, dy, dz) lexicographic order. Each
    axis' finite differences are weighted by both corners observed and
    renormalised; an axis with no observed pair contributes 0."""
    w, (wx, wy, wz) = _corner_weights(f)
    val = (vals * w).sum(1)
    v = vals.reshape(-1, 2, 2, 2)
    o = obs.reshape(-1, 2, 2, 2)

    def axis_grad(dv, pair_obs, wgt):
        m = pair_obs.to(dv.dtype)
        den = (wgt * m).sum((1, 2))
        num = (dv * wgt * m).sum((1, 2))
        return torch.where(den > 1e-6, num / torch.clamp_min(den, 1e-6), 0.0)

    wyz = wy[:, :, None] * wz[:, None, :]
    wxz = wx[:, :, None] * wz[:, None, :]
    wxy = wx[:, :, None] * wy[:, None, :]
    gx = axis_grad(v[:, 1] - v[:, 0], o[:, 1] & o[:, 0], wyz)
    gy = axis_grad(v[:, :, 1] - v[:, :, 0], o[:, :, 1] & o[:, :, 0], wxz)
    gz = axis_grad(v[:, :, :, 1] - v[:, :, :, 0], o[:, :, :, 1] & o[:, :, :, 0], wxy)
    grad = torch.stack([gx, gy, gz], 1) / voxel
    return val, grad, obs.all(1)


def _floor_corner(vol, p):
    g = _grid(vol, p)
    v0 = torch.floor(g).to(torch.int32)
    return v0, g - v0.to(torch.float32)


def _dense_trilinear(enc: torch.Tensor, vol: TsdfVolume, p: torch.Tensor):
    """Trilinear TSDF value + world-space gradient at p (R, 3);
    unobserved corners read their stored 1.0 fill."""
    nx, ny, nz = vol.resolution
    i0, f = _floor_corner(vol, p)
    inb = _inside(i0 + 1, vol.resolution) & (i0 >= 0).all(1)
    i0 = _clip(i0, (nx - 2, ny - 2, nz - 2))
    vals, obs = [], []
    for dx, dy, dz in _CORNER_OFFS:
        v = enc[((i0[:, 0] + dx) * ny + i0[:, 1] + dy) * nz + i0[:, 2] + dz]
        vals.append(torch.clamp_max(v, 1.0))
        obs.append(v < 1.5)
    obs = torch.stack(obs, 1) & inb[:, None]
    return _trilinear_from_corners(torch.stack(vals, 1), obs, f, vol.voxel_size)


def _block_row_map(vol: SparseTsdfVolume, grid_blocks: Tuple[int, int, int]) -> torch.Tensor:
    """Dense block-key → table-row map (gx·gy·gz,), −1 if unallocated."""
    gx, gy, gz = grid_blocks
    keys = torch.arange(gx * gy * gz, dtype=torch.int32, device=vol.block_keys.device)
    row = torch.searchsorted(vol.block_keys, keys).to(torch.int32).clamp_(0, vol.max_blocks - 1)
    return torch.where(vol.block_keys[row] == keys, row, -1)


def _block_of(vox, grid_blocks, block):
    """(block coords (floor division), local coords, in-grid flag, key)
    of integer voxels (R, 3)."""
    gx, gy, gz = grid_blocks
    b = torch.div(vox, block, rounding_mode="floor")
    l = vox - b * block
    inb = (vox >= 0).all(1) & (b[:, 0] < gx) & (b[:, 1] < gy) & (b[:, 2] < gz)
    return b, l, inb, (b[:, 0] * gy + b[:, 1]) * gz + b[:, 2]


def _table_index(row_map, vox, grid_blocks, block):
    """(linear index into the (max_blocks·s1³,) table, allocated flag,
    table row (−1: unallocated), block coordinates, in-grid flag)."""
    s1 = block + 1
    b, l, inb, key = _block_of(vox, grid_blocks, block)
    row = row_map[key.clamp(0, row_map.shape[0] - 1)]
    flat = (l[:, 0] * s1 + l[:, 1]) * s1 + l[:, 2]
    return torch.clamp_min(row, 0) * (s1 ** 3) + flat, (row >= 0) & inb, row, b, inb


def _dda_skip(vol, p, dirs, b, block, empty):
    """Jump to the exit of the sampled block where it is empty, in ray
    parameter units, plus a quarter voxel; 0 elsewhere."""
    bw = vol.voxel_size * float(block)
    lo = vol.origin + b.to(torch.float32) * bw
    bound = torch.where(dirs > 0, lo + bw, lo)
    ax = torch.where(dirs.abs() > 1e-12, (bound - p) / dirs, torch.inf)
    exit_t = torch.where(torch.isfinite(ax), ax, torch.inf).amin(1)
    return torch.where(empty, torch.clamp_min(exit_t, 0.0) + 0.25 * vol.voxel_size, 0.0)


def _sparse_nearest(enc, vol: SparseTsdfVolume, row_map, p, dirs,
                    grid_blocks: Tuple[int, int, int], block: int):
    """Encoded nearest sample + empty-block skip distance: an unallocated
    block holds no part of the surface band, so the ray jumps to its
    exit."""
    vox = torch.round(_grid(vol, p)).to(torch.int32)
    lin, alloc, row, b, inb = _table_index(row_map, vox, grid_blocks, block)
    v = torch.where(alloc, enc[lin], _UNOBS)
    skip = _dda_skip(vol, p, dirs, b, block, inb & (row < 0))
    return torch.clamp_max(v, 1.0), v < 1.5, skip


def _dense_color(vol: TsdfVolume, p: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel colour rows at hit points."""
    nx, ny, nz = vol.resolution
    i = _clip(torch.round(_grid(vol, p)).to(torch.int32), (nx - 1, ny - 1, nz - 1))
    return vol.color.reshape(-1, 3)[(i[:, 0] * ny + i[:, 1]) * nz + i[:, 2]]


def _sparse_color(vol: SparseTsdfVolume, row_map, p, grid_blocks, block) -> torch.Tensor:
    """Nearest-voxel colour rows from the block table (0 where the block
    is unallocated)."""
    vox = torch.round(_grid(vol, p)).to(torch.int32)
    lin, alloc, _, _, _ = _table_index(row_map, vox, grid_blocks, block)
    return torch.where(alloc[:, None], vol.color.reshape(-1, 3)[lin], 0.0)


def _sparse_trilinear(enc, vol: SparseTsdfVolume, row_map, p,
                      grid_blocks: Tuple[int, int, int], block: int):
    """Trilinear sample in the block table, each corner fetched from its
    own voxel's block (a low-corner-block lookup would read a corner one
    voxel into an unallocated neighbour as 1.0)."""
    v0, f = _floor_corner(vol, p)
    vals, obs = [], []
    for off in _CORNER_OFFS:
        vc = _shifted(v0, off)
        lin, alloc, _, _, _ = _table_index(row_map, vc, grid_blocks, block)
        v = torch.where(alloc, enc[lin], _UNOBS)
        vals.append(torch.clamp_max(v, 1.0))
        obs.append(v < 1.5)
    return _trilinear_from_corners(torch.stack(vals, 1), torch.stack(obs, 1), f,
                                   vol.voxel_size)


def _block_major_dense(vol: SparseTsdfVolume, grid_blocks: Tuple[int, int, int],
                       block: int) -> torch.Tensor:
    """The sparse table as a (gx·gy·gz · B³,) block-major encoded array:
    voxel v at key(v//B)·B³ + flat(v mod B), so every sample is one
    gather. Unallocated blocks read 3.0 (the skip trigger), unobserved
    voxels 2.0. Rows with an invalid key are filtered out of the copy
    (they go to a spare row that is cut off)."""
    gx, gy, gz = grid_blocks
    s1 = block + 1
    mb = vol.max_blocks
    g = gx * gy * gz
    enc = torch.where(vol.weight > 0, vol.tsdf, _UNOBS)
    interior = enc.reshape(mb, s1, s1, s1)[:, :block, :block, :block].reshape(mb, block ** 3)
    keys = vol.block_keys.long()
    dest = torch.where((keys >= 0) & (keys < g) & (keys != _INVALID), keys, g)
    dense = torch.full((g + 1, block ** 3), _EMPTY_BLOCK, dtype=torch.float32,
                       device=enc.device)
    dense[dest] = interior
    return dense[:g].reshape(-1)


def _bm_index(vol, p, grid_blocks: Tuple[int, int, int], block: int):
    """Nearest voxel → (clipped block-major index, in-grid flag, block)."""
    gx, gy, gz = grid_blocks
    vox = torch.round(_grid(vol, p)).to(torch.int32)
    b, l, inb, key = _block_of(vox, grid_blocks, block)
    lin = key * (block ** 3) + (l[:, 0] * block + l[:, 1]) * block + l[:, 2]
    return lin.clamp(0, gx * gy * gz * block ** 3 - 1), inb, b


def _bm_nearest(dense, vol: SparseTsdfVolume, p, dirs, grid_blocks, block: int):
    """Nearest sample from the block-major copy: one gather; the
    empty-block sentinel is the skip trigger."""
    lin, inb, b = _bm_index(vol, p, grid_blocks, block)
    v = torch.where(inb, dense[lin], _UNOBS)
    skip = _dda_skip(vol, p, dirs, b, block, inb & (v > 2.5))
    return torch.clamp_max(v, 1.0), v < 1.5, skip


def _bm_trilinear(dense, vol: SparseTsdfVolume, p, grid_blocks, block: int):
    """Trilinear sample from the block-major copy: 8 direct gathers."""
    gx, gy, gz = grid_blocks
    size = gx * gy * gz * block ** 3
    v0, f = _floor_corner(vol, p)
    vals, obs = [], []
    for off in _CORNER_OFFS:
        vc = _shifted(v0, off)
        b, l, inb, key = _block_of(vc, grid_blocks, block)
        lin = key * (block ** 3) + (l[:, 0] * block + l[:, 1]) * block + l[:, 2]
        v = torch.where(inb, dense[lin.clamp(0, size - 1)], _UNOBS)
        vals.append(torch.clamp_max(v, 1.0))
        obs.append(v < 1.5)
    return _trilinear_from_corners(torch.stack(vals, 1), torch.stack(obs, 1), f,
                                   vol.voxel_size)


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

def _march(nearest, trilinear, origin_w, dirs_w, near, far, trunc, voxel,
           max_steps: int, refine: bool = True):
    """Shared ray-march core. ``nearest(p) -> (val, obs, skip)`` (skip =
    an empty-space jump in t units, 0 if none), ``trilinear(p) -> (val,
    grad, obs)``. ``near`` is a float or a per-ray (R,) start vector.
    ``refine=False`` skips the trilinear refinement (depth from the
    nearest-sample bracket, no normals)."""
    r = dirs_w.shape[0]
    dev = dirs_w.device
    t = _to_device(near, dev, torch.float32).expand(r).clone()
    pt = t.clone()
    pv = torch.ones(r, device=dev)
    pobs = torch.zeros(r, dtype=torch.bool, device=dev)
    hit = torch.zeros(r, dtype=torch.bool, device=dev)
    tlo = torch.zeros(r, device=dev)
    thi = torch.zeros(r, device=dev)
    vlo = torch.ones(r, device=dev)
    vhi = -torch.ones(r, device=dev)

    coarse = 0.75 * trunc
    fine = torch.maximum(voxel, 0.1 * trunc)
    for step in range(max_steps):
        if step and step % EXIT_TEST_EVERY == 0:
            counts["exit_tests"] += 1
            if not bool((~hit & (t <= far)).any()):
                break
        counts["steps"] += 1
        p = origin_w + t[:, None] * dirs_w
        val, obs, skip = nearest(p)
        active = ~hit & (t <= far)
        # a crossing needs both bracketing samples observed
        cross = active & pobs & obs & (pv > 0) & (val < 0)
        hit = hit | cross
        tlo = torch.where(cross, pt, tlo)
        thi = torch.where(cross, t, thi)
        vlo = torch.where(cross, pv, vlo)
        vhi = torch.where(cross, val, vhi)
        # free space (val ≈ 1: the surface is ≥ 0.97·trunc away) → coarse
        # step; inside the band → fine steps; unallocated block → its exit
        dt = torch.where(skip > 0, torch.maximum(skip, fine),
                         torch.where(val > 0.97, coarse, fine))
        adv = active & ~cross
        pt = torch.where(adv, t, pt)
        t = torch.where(adv, t + dt, t)
        pv = torch.where(active, val, pv)
        pobs = torch.where(active, obs, pobs)

    # nearest-bracket zero (vlo > 0 > vhi by construction)
    t_nn = tlo + vlo / (vlo - vhi) * (thi - tlo)
    if not refine:
        ps = origin_w + t_nn[:, None] * dirs_w
        return t_nn, ps, torch.zeros_like(ps), hit, hit

    # ---- refinement: one secant on trilinear samples at a bracket
    # centred on t_nn (the trilinear zero lies within half a fine step of
    # it); the normal from the gradient at the secant point
    half = 0.75 * fine
    tlo = t_nn - half
    thi = t_nn + half
    flo, _, _ = trilinear(origin_w + tlo[:, None] * dirs_w)
    fhi, _, _ = trilinear(origin_w + thi[:, None] * dirs_w)
    # rays with no trilinear sign change (grazing/border) keep t_nn
    tri_ok = (flo > 0) & (fhi < 0)
    denom = flo - fhi
    frac = torch.where(denom.abs() > 1e-12, flo / denom, 0.5)
    ts1 = tlo + frac.clamp(0.0, 1.0) * (thi - tlo)
    fs, grad, _ = trilinear(origin_w + ts1[:, None] * dirs_w)
    # a second secant round against the end that still brackets, no eval
    move_hi = fs > 0
    t_a = torch.where(move_hi, thi, tlo)
    f_a = torch.where(move_hi, fhi, flo)
    den2 = fs - f_a
    frac2 = torch.where(den2.abs() > 1e-12, fs / den2, 0.0)
    ts2 = ts1 + frac2.clamp(-1.0, 1.0) * (t_a - ts1)
    ts = torch.where(tri_ok, ts2, t_nn)
    ps = origin_w + ts[:, None] * dirs_w
    # validity from the nearest-sample bracket (both ends observed)
    n = grad / torch.clamp_min(torch.linalg.vector_norm(grad, dim=1, keepdim=True), 1e-12)
    return ts, ps, n, hit, hit & tri_ok


def _pixel_dirs(h: int, w: int, intr: torch.Tensor, cam_to_world: torch.Tensor):
    fx, fy, cx, cy = intr
    dev = intr.device
    u = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    v = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], 1)
    return fp32_matmul(d_cam, cam_to_world[:3, :3].T), cam_to_world[:3, 3]


def _as_result(h, w, ts, ps, n, ok, conf, color=None) -> RaycastResult:
    # the camera-frame direction has z = 1, so the ray parameter is depth
    return RaycastResult(
        depth=torch.where(ok, ts, 0.0).reshape(h, w),
        vertices=ps.reshape(h, w, 3),
        normals=torch.where(ok[:, None], n, 0.0).reshape(h, w, 3),
        mask=ok.reshape(h, w),
        confident=conf.reshape(h, w),
        color=None if color is None else torch.where(ok[:, None], color, 0.0).reshape(h, w, 3))


def _coarse_intr(intr: torch.Tensor, f: int) -> torch.Tensor:
    """Intrinsics of the f×-downsampled image: coarse pixel (i, j)
    centres on full-res pixel (f·i + (f−1)/2, ...)."""
    half = (f - 1.0) / 2.0
    return torch.stack([intr[0] / f, intr[1] / f, (intr[2] - half) / f, (intr[3] - half) / f])


def _seed_from_coarse(t_c, hit_c, h4: int, w4: int, h: int, w: int, f: int,
                      near: float, far: float, margin) -> torch.Tensor:
    """Per-full-ray start depths from a coarse-pass depth map over each
    3×3 coarse neighbourhood: all hit → min depth − margin; mixed →
    the near plane; all miss → a miss (seeded past far). Image borders
    use the real neighbours only."""
    hit2 = hit_c.reshape(h4, w4)
    vhit = F.pad(torch.where(hit2, t_c.reshape(h4, w4), torch.inf), (1, 1, 1, 1),
                 value=torch.inf)
    anyh = F.pad(hit2, (1, 1, 1, 1), value=False)
    allh = F.pad(hit2, (1, 1, 1, 1), value=True)
    pmin, pany, pall = vhit[:h4, :w4], anyh[:h4, :w4], allh[:h4, :w4]
    for di in range(3):
        for dj in range(3):
            if di or dj:
                pmin = torch.minimum(pmin, vhit[di:di + h4, dj:dj + w4])
                pany = pany | anyh[di:di + h4, dj:dj + w4]
                pall = pall & allh[di:di + h4, dj:dj + w4]
    near32 = torch.tensor(near, dtype=torch.float32).item()
    seeded = torch.clamp_min(pmin - margin, near32)
    dead = torch.tensor(far, dtype=torch.float32).item() + 1.0
    start = torch.where(pany, torch.where(pall, seeded, near32), dead)
    full = start.repeat_interleave(f, 0).repeat_interleave(f, 1)[:h, :w]
    return full.reshape(-1)


def _two_level(run_level, intr, h: int, w: int, near, far, trunc, coarse_factor: int):
    """Coarse seed pass (1/f² rays, no refinement) + seeded full pass.
    ``run_level(intr, h, w, near, refine) -> (ts, ps, n, ok, conf)``."""
    if coarse_factor <= 1 or h < 4 * coarse_factor or w < 4 * coarse_factor:
        return run_level(intr, h, w, near, True)
    f = coarse_factor
    h4, w4 = -(-h // f), -(-w // f)
    tc, _, _, okc, _ = run_level(_coarse_intr(intr, f), h4, w4, near, False)
    seed = _seed_from_coarse(tc, okc, h4, w4, h, w, f, near, far, 3.0 * trunc)
    return run_level(intr, h, w, seed, True)


def _level_runner(vol, cam_to_world, far, max_steps, nearest_of, trilinear):
    def run_level(lintr, lh, lw, lnear, lrefine):
        d_w, o_w = _pixel_dirs(lh, lw, lintr, cam_to_world)
        return _march(nearest_of(d_w), trilinear, o_w, d_w, lnear, far, vol.truncation,
                      vol.voxel_size, max_steps, refine=lrefine)
    return run_level


def raycast(vol: TsdfVolume, intr, cam_to_world, height: int, width: int,
            near: float = 0.1, far: float = 10.0, max_steps: int = 96,
            coarse_factor: int = 4) -> RaycastResult:
    """Raycast a dense TSDF volume into depth/vertex/normal maps.

    ``intr`` = [fx, fy, cx, cy]; ``cam_to_world`` (4, 4). ``depth`` is
    camera-z depth (comparable to the depth images ``integrate``
    consumes). Normals point along the TSDF gradient, toward the
    observed free space. ``coarse_factor`` > 1 runs a 1/f² seed pass
    first; 1 marches every ray from the near plane.
    """
    dev = vol.tsdf.device
    intr = _to_device(intr, dev, torch.float32)
    pose = _to_device(cam_to_world, dev, torch.float32)
    enc = _encode_observed(vol.tsdf, vol.weight)

    def nearest_of(d_w):
        return lambda p: _dense_nearest(enc, vol, p) + (torch.zeros(p.shape[0], device=dev),)

    run_level = _level_runner(vol, pose, far, max_steps, nearest_of,
                              lambda p: _dense_trilinear(enc, vol, p))
    ts, ps, n, ok, conf = _two_level(run_level, intr, height, width, near, far,
                                     vol.truncation, coarse_factor)
    col = None if vol.color is None else _dense_color(vol, ps)
    return _as_result(height, width, ts, ps, n, ok, conf, col)


def sparse_raycast(vol: SparseTsdfVolume, intr, cam_to_world, height: int, width: int,
                   grid_blocks: Tuple[int, int, int], block: int = 8,
                   near: float = 0.1, far: float = 10.0, max_steps: int = 96,
                   coarse_factor: int = 4,
                   materialize: Optional[bool] = None) -> RaycastResult:
    """Raycast the block-sparse TSDF (the same maps as ``raycast``).

    ``materialize=None`` picks by a 768 MB budget (up to a 512³ virtual
    grid): the table is first copied into a block-major dense array, so
    every sample is one gather; otherwise each sample goes through the
    block-row map and the table. An unallocated block is crossed in one
    jump on both paths. ``coarse_factor`` as in ``raycast``.
    """
    gx, gy, gz = grid_blocks
    dev = vol.tsdf.device
    intr = _to_device(intr, dev, torch.float32)
    pose = _to_device(cam_to_world, dev, torch.float32)
    if materialize is None:
        materialize = gx * gy * gz * block ** 3 * 4 <= _MATERIALIZE_BUDGET_BYTES

    if materialize:
        dense = _block_major_dense(vol, grid_blocks, block)

        def nearest_of(d_w):
            return lambda p: _bm_nearest(dense, vol, p, d_w, grid_blocks, block)

        def trilinear(p):
            return _bm_trilinear(dense, vol, p, grid_blocks, block)
    else:
        row_map = _block_row_map(vol, grid_blocks)
        enc = _encode_observed(vol.tsdf, vol.weight)

        def nearest_of(d_w):
            return lambda p: _sparse_nearest(enc, vol, row_map, p, d_w, grid_blocks, block)

        def trilinear(p):
            return _sparse_trilinear(enc, vol, row_map, p, grid_blocks, block)

    run_level = _level_runner(vol, pose, far, max_steps, nearest_of, trilinear)
    ts, ps, n, ok, conf = _two_level(run_level, intr, height, width, near, far,
                                     vol.truncation, coarse_factor)
    col = None
    if vol.color is not None:
        col = _sparse_color(vol, _block_row_map(vol, grid_blocks), ps, grid_blocks, block)
    return _as_result(height, width, ts, ps, n, ok, conf, col)


def shade(res: RaycastResult, light_dir=(0.4, -0.3, 0.85), ambient: float = 0.15,
          background: float = 0.0) -> torch.Tensor:
    """Lambertian shading of a raycast result → (H, W) grayscale in
    [0, 1] (light direction in world space, pointing FROM the light;
    the default is a headlight slightly off the camera axis)."""
    l = torch.as_tensor(light_dir, dtype=torch.float32, device=res.normals.device)
    l = -l / torch.clamp_min(torch.linalg.vector_norm(l), 1e-12)
    lam = torch.clamp((res.normals * l).sum(-1), 0.0, 1.0)
    return torch.where(res.mask, ambient + (1.0 - ambient) * lam, background)


def shade_rgb(res: RaycastResult, light_dir=(0.4, -0.3, 0.85), ambient: float = 0.15,
              background=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Lambertian-lit colour render → (H, W, 3) in [0, 1]: the result's
    sampled colour when present, else white."""
    lit = shade(res, light_dir, ambient, background=0.0)
    base = torch.ones(res.mask.shape + (3,), device=lit.device) if res.color is None \
        else res.color
    img = lit[..., None] * base
    bg = torch.as_tensor(background, dtype=torch.float32, device=img.device).expand(img.shape)
    return torch.where(res.mask[..., None], img, bg)
