"""The plain reference of the two entries the benchmark drives.

Plain PyTorch, run after the measured window on the inputs the benchmark
made. It imports nothing of the program: every function here is a frozen
copy of a plain algorithm, named with the file it was copied from, so a
later change to the program cannot move the yardstick.

* ``perception_step``: the target's two-window union normals (Morton
  pass A and pass B, each query's k nearest within its 3-tile window,
  the band bound tightened by six bisection rounds; the 3x3 eigensolve
  on the merged central sums) and point-to-point ICP on the static-sort
  window correspondence.
* ``registration_model``: union normals on both clouds, the fused-window
  FPFH (stage-1 pair histograms and stage-2 weighted sums over the two
  passes), descriptor matching with the mutual check, batched RANSAC
  drawn from a ``torch.Generator`` seeded as the configuration states
  (fed the same indices, the same hypotheses are fitted and scored), and
  the coarse-then-full ICP refinement.

``Precision`` selects the arithmetic: ``fp32`` is the configuration's
(float32, TF32 off); ``tf32`` rounds the operands of every product to
TF32's 10-bit mantissa first, as a tensor-core product would. The
second is the control: it must read as not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12


class Precision:
    """``r`` rounds a product's operand, ``mm`` is a matrix product with
    both operands so rounded; fp32 leaves them as they are."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32" or x.dtype != torch.float32:
            return x
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        return self.r(a) @ self.r(b)


FP32 = Precision("fp32")

# ---------------------------------------------------------------------------
# Morton keys: threecrate_tpu_torch/ops/morton.py:31-109
GRID = 1024
INT32_MAX = 2 ** 31 - 1
PASS_SHIFTS = ((0.0, 0.0, 0.0), (0.381966, 0.618034, 0.236068),
               (0.754877, 0.324717, 0.569840), (0.177124, 0.827090, 0.429203))


def _spread_bits(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _encode(c):
    c = c.to(torch.int32)
    return _spread_bits(c[..., 0]) | (_spread_bits(c[..., 1]) << 1) | (_spread_bits(c[..., 2]) << 2)


def _scale(ext):
    den = 2.0 * ext.amax()
    return torch.full_like(den, GRID - 1) / den


def _cells(rel):
    return rel.clamp(0.0, GRID - 1).to(torch.int32)


def _min_max(points, mask):
    m = mask[:, None]
    return (torch.where(m, points, 3e38).amin(0), torch.where(m, points, -3e38).amax(0))


def _frame(points, mask):
    mn, mx = _min_max(points, mask)
    return mn, _scale(torch.clamp_min(mx - mn, 1e-6))


def _keys_in_frame(points, mask, mn, scale):
    keys = _encode(_cells((points - mn) * scale))
    return torch.where(mask, keys, torch.full_like(keys, INT32_MAX))


def _morton_keys(points, mask, pass_index=0):
    mn, mx = _min_max(points, mask)
    ext = torch.clamp_min(mx - mn, 1e-6)
    shift = torch.stack([ext[i] * s for i, s in enumerate(PASS_SHIFTS[pass_index])])
    cells = _cells((points - mn + shift) * _scale(ext))
    if pass_index:
        cells = torch.roll(cells, pass_index % 3, dims=-1)
    keys = _encode(cells)
    return torch.where(mask, keys, torch.full_like(keys, INT32_MAX))


def _sort_perm(keys):
    return torch.sort(keys, stable=True).indices


def _inverse(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device, dtype=perm.dtype)
    return inv


def _round_up(n, m):
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# Union-window normals: threecrate_tpu_torch/kernels/knn.py:69-151 (the
# plain passes) and ops/normals.py:61-157 (sorts, merge, covariance)
_CHUNK_TILES = 32


def _window(row, t0, t1, tile, fill):
    n = row.shape[-1]
    tiles = torch.arange(t0, t1, device=row.device)
    cols = (tiles[:, None] - 1) * tile + torch.arange(3 * tile, device=row.device)
    inside = (cols >= 0) & (cols < n)
    return torch.where(inside, row[..., cols.clamp(0, n - 1)], fill)


def _band_bound(d2v, k, band, tile):
    offs = torch.arange(-band, band + 1, device=d2v.device)
    cols = tile + torch.arange(tile, device=d2v.device)[:, None] + offs
    bd = torch.gather(d2v, 2, cols.expand(d2v.shape[0], tile, 2 * band + 1))
    hi = torch.kthvalue(bd, k, dim=2).values
    lo = torch.zeros_like(hi)
    for _ in range(6):
        mid = 0.5 * (lo + hi)
        ge = (d2v <= mid[..., None]).sum(2) >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    return torch.clamp_max(hi, 3.4e38)


def _union_geometry(pts_t, valid, t0, t1, tile, prec):
    ok = _window(valid[0], t0, t1, tile, 0.0) > 0.5
    q = pts_t[:, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    d = [prec.r(_window(pts_t[r], t0, t1, tile, 0.0)[:, None, :] - q[r][:, :, None])
         for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, torch.where(ok[:, None, :], d2, torch.inf)


def _central_sums(sel, d):
    dx, dy, dz = (torch.where(sel, c, 0.0) for c in d)
    return [sel.sum(2, dtype=torch.float32), dx.sum(2), dy.sum(2), dz.sum(2),
            (dx * dx).sum(2), (dy * dy).sum(2), (dz * dz).sum(2),
            (dx * dy).sum(2), (dx * dz).sum(2), (dy * dz).sum(2)]


def _union_a(pts_t, valid, k, tile, band, prec):
    n = pts_t.shape[1]
    out = torch.empty((11, n), dtype=torch.float32, device=pts_t.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2v = _union_geometry(pts_t, valid, t0, t1, tile, prec)
        hi = _band_bound(d2v, k, band, tile)
        out[:, t0 * tile:t1 * tile] = torch.stack(
            _central_sums(d2v <= hi[..., None], d) + [hi]).reshape(11, -1)
    return out


def _union_b(pts_t, valid, pos_a, hi_a, k, tile, band, prec):
    n = pts_t.shape[1]
    shift = tile.bit_length() - 1
    out = torch.empty((11, n), dtype=torch.float32, device=pts_t.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2v = _union_geometry(pts_t, valid, t0, t1, tile, prec)
        hib = _band_bound(d2v, k, band, tile)
        tile_c = _window(pos_a[0], t0, t1, tile, 0) >> shift
        tile_q = pos_a[0, t0 * tile:t1 * tile].reshape(-1, tile) >> shift
        dtile = tile_c[:, None, :] - tile_q[:, :, None]
        in_win_a = (dtile >= -1) & (dtile <= 1)
        hia = hi_a[0, t0 * tile:t1 * tile].reshape(-1, tile)
        use_b = hib < hia
        sel = torch.where(use_b[..., None], d2v <= hib[..., None],
                          (d2v <= hia[..., None]) & ~in_win_a)
        out[:, t0 * tile:t1 * tile] = torch.stack(
            _central_sums(sel, d) + [use_b.to(torch.float32)]).reshape(11, -1)
    return out


# closed-form 3x3 eigensolve: threecrate_tpu_torch/ops/linalg.py:30-131
def _scale_of(a):
    return torch.clamp_min(a.abs().amax(dim=(-2, -1)), 1e-30)


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _eigvals(a):
    scale = _scale_of(a)
    a = a / scale[..., None, None]
    q = a.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    a_sub = a - q[..., None, None] * eye
    p2 = (a_sub * a_sub).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, _EPS))
    b = a_sub / p[..., None, None]
    r = torch.clamp(_det3(b) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    iso = p2 < _EPS
    e1, e2, e3 = (torch.where(iso, q, e) for e in (e1, e2, e3))
    return torch.stack([e3, e2, e1], dim=-1) * scale[..., None]


def _eigenvector_for(a, lam):
    scale = _scale_of(a)
    a = a / scale[..., None, None]
    lam = lam / scale
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01, c02, c12 = (torch.linalg.cross(x, y) for x, y in ((r0, r1), (r0, r2), (r1, r2)))
    n01, n02, n12 = ((c * c).sum(-1) for c in (c01, c02, c12))
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    best_n = torch.maximum(torch.maximum(n01, n02), n12)
    row_n = (m * m).sum(-1)
    big_row = torch.gather(
        m, -2, row_n.argmax(-1)[..., None, None].expand(*m.shape[:-2], 1, 3))[..., 0, :]
    alt = torch.linalg.cross(big_row, eye[0].expand_as(big_row))
    alt2 = torch.linalg.cross(big_row, eye[1].expand_as(big_row))
    alt = torch.where(((alt * alt).sum(-1) >= (alt2 * alt2).sum(-1))[..., None], alt, alt2)
    v = torch.where((best_n > _EPS)[..., None], best, alt)
    v = torch.where(((v * v).sum(-1) > _EPS)[..., None], v, eye[2].expand_as(v))
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-30)


def _cov_from_sums(s):
    cnt = s[:, 0]
    inv_n = 1.0 / torch.clamp_min(cnt, 1e-12)
    e1 = s[:, 1:4] * inv_n[:, None]
    cxx = s[:, 4] * inv_n - e1[:, 0] * e1[:, 0]
    cyy = s[:, 5] * inv_n - e1[:, 1] * e1[:, 1]
    czz = s[:, 6] * inv_n - e1[:, 2] * e1[:, 2]
    cxy = s[:, 7] * inv_n - e1[:, 0] * e1[:, 1]
    cxz = s[:, 8] * inv_n - e1[:, 0] * e1[:, 2]
    cyz = s[:, 9] * inv_n - e1[:, 1] * e1[:, 2]
    cov = torch.stack([torch.stack([cxx, cxy, cxz], -1), torch.stack([cxy, cyy, cyz], -1),
                       torch.stack([cxz, cyz, czz], -1)], -2)
    return cov, cnt


def viewpoint(points, mask):
    """The default viewpoint: the bounding box centre raised by its z
    extent (ops/normals.py:258-267)."""
    mn, mx = _min_max(points, mask)
    up = torch.eye(3, device=points.device)[2]
    return (mn + mx) * 0.5 + up * torch.clamp_min(mx[2] - mn[2], 1.0)


def union_normals(points, mask, k, prec=FP32, tile=256, band=16):
    """(normals (N, 3), curvature (N,), valid (N,)) in input order, zero
    where invalid: ``_estimate_window_union`` (ops/normals.py:124-132)."""
    n = points.shape[0]
    vp = viewpoint(points, mask)
    band = max(band, k)
    n_pad = _round_up(n, tile)
    pts = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:n] = points
    mask_p = torch.zeros(n_pad, dtype=torch.bool, device=points.device)
    mask_p[:n] = mask
    perm_a = _sort_perm(_morton_keys(pts, mask_p, 0))
    pts_a, am = pts[perm_a], mask_p[perm_a].to(torch.float32)
    out_a = _union_a(pts_a.T.contiguous(), am[None], k, tile, band, prec)
    row_a = _sort_perm(_morton_keys(pts_a, am > 0.5, 1))
    out_b = _union_b(pts_a[row_a].T.contiguous(), am[row_a][None],
                     row_a.to(torch.int32)[None], out_a[10][row_a][None], k, tile, band, prec)
    sb = torch.empty_like(out_b.T)
    sb[row_a] = out_b.T
    s = sb[:, 0:10] + torch.where(sb[:, 10:11] > 0.5, 0.0, out_a[0:10].T)
    cov, cnt = _cov_from_sums(s)
    vals = _eigvals(cov)
    normal = _eigenvector_for(cov, vals[..., 0])
    curv = torch.clamp_min(vals[..., 0], 0.0) / torch.clamp_min(vals.sum(-1), 1e-12)
    flip = ((vp[None, :] - pts_a) * normal).sum(-1) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    valid_s = (am > 0.5) & (cnt >= 3)
    nrm, cv, va = torch.empty_like(normal), torch.empty_like(curv), torch.empty_like(valid_s)
    nrm[perm_a] = torch.where(valid_s[:, None], normal, 0.0)
    cv[perm_a] = torch.where(valid_s, curv, 0.0)
    va[perm_a] = valid_s
    return nrm[:n], cv[:n], va[:n] & mask


# ---------------------------------------------------------------------------
# Point-to-point ICP on the static-sort window: ops/registration.py:101-310,
# kernels/icp.py:57-90 (the nearest target of each source point in its
# window of w_tiles target tiles), ops/linalg.py:132-218 (Kabsch)
_ICP_CHUNK_TILES = 256


def _pad(x, n_pad):
    out = x.new_zeros((n_pad,) + x.shape[1:])
    out[:x.shape[0]] = x
    return out


def _percentile(x, q):
    xs = torch.sort(x).values
    pos = q / 100.0 * (x.shape[0] - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def transform_points(m, points, prec=FP32):
    return prec.mm(points, m[:3, :3].T) + m[:3, 3]


def _window_nearest(src_xyz, tgt_xyz, starts, tile, w_tiles, prec):
    """(matched (Ns, 3), found (Ns,)): each source point's nearest target
    among its tile's window (ties: the lowest column)."""
    ns, nt = src_xyz.shape[0], tgt_xyz.shape[0]
    dev = src_xyz.device
    wc = w_tiles * tile
    matched = torch.empty_like(src_xyz)
    found = torch.empty(ns, dtype=torch.bool, device=dev)
    for t0 in range(0, ns // tile, _ICP_CHUNK_TILES):
        t1 = min(t0 + _ICP_CHUNK_TILES, ns // tile)
        cols = starts[t0:t1, None].long() * tile + torch.arange(wc, device=dev)
        cols = cols.clamp(0, nt - 1)
        cand = tgt_xyz[cols]                                   # (T, wc, 3)
        q = src_xyz[t0 * tile:t1 * tile].reshape(t1 - t0, tile, 3)
        d = [prec.r(cand[:, None, :, r] - q[:, :, None, r]) for r in range(3)]
        s = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]            # (T, tile, wc)
        m, j = s.min(2)
        sl = slice(t0 * tile, t1 * tile)
        matched[sl] = torch.gather(cand, 1, j[..., None].expand(-1, -1, 3)).reshape(-1, 3)
        found[sl] = (m < torch.inf).reshape(-1)
    return matched, found


def _kabsch_moments(source, target, w, prec):
    wsum = torch.clamp_min(w.sum(), _EPS)
    mu_s = (source * w[:, None]).sum(0) / wsum
    mu_t = (target * w[:, None]).sum(0) / wsum
    h = prec.mm(((source - mu_s) * w[:, None]).T, target - mu_t)
    return torch.cat([mu_s, mu_t, h.reshape(9)])


def _kabsch_from_moments(mom, prec):
    mu_s, mu_t, h = mom[0:3], mom[3:6], mom[6:15].reshape(3, 3)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(prec.mm(vt.T, u.T)))
    diag = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = prec.mm(prec.mm(vt.T, diag), u.T)
    m = torch.eye(4, dtype=h.dtype)
    m[:3, :3] = r
    m[:3, 3] = mu_t - prec.mm(r, mu_s)
    return m


def _static_matcher(src, src_mask, tgt, tgt_mask, init, w_tiles, prec, tile=128,
                    tile_stride=1):
    """The per-iteration correspondence of ``_static_corr_setup``: both
    clouds Morton-sorted once (the source at its initial pose, in the
    target's lattice), each source tile matched against the window of
    target tiles around its moved mean's key, a 16x-median gate."""
    ns_pad = _round_up(src.shape[0], tile)
    nt_pad = max(_round_up(tgt.shape[0], tile), w_tiles * tile)
    src_p, sm_p = _pad(src, ns_pad), _pad(src_mask, ns_pad)
    tgt_p, tm_p = _pad(tgt, nt_pad), _pad(tgt_mask, nt_pad)
    mn_t, scale_t = _frame(tgt_p, tm_p)
    keys_t_sorted, order_t = torch.sort(_keys_in_frame(tgt_p, tm_p, mn_t, scale_t), stable=True)
    tvf = tm_p[order_t]
    coords = torch.where(tvf[:, None], tgt_p[order_t], 2e19)
    src_init = transform_points(init, src_p, prec)
    order_s = torch.sort(_keys_in_frame(src_init, sm_p, mn_t, scale_t), stable=True).indices
    src_sorted, svf = src_p[order_s], sm_p[order_s].to(torch.float32)
    n_src_tiles = ns_pad // tile
    if tile_stride > 1:
        tile_stride = min(tile_stride, n_src_tiles)
        src_sorted = src_sorted.reshape(n_src_tiles, tile, 3)[::tile_stride].reshape(-1, 3)
        svf = svf.reshape(n_src_tiles, tile)[::tile_stride].reshape(-1)
        n_src_tiles = src_sorted.shape[0] // tile
    n_tgt_tiles = nt_pad // tile
    extent = torch.full_like(scale_t, GRID) / scale_t
    noise_floor = (3e-6 * extent) ** 2
    svf_tiles = svf.reshape(n_src_tiles, tile)
    tile_w = torch.clamp_min(svf_tiles.sum(1), 1e-6)
    all_tiles = torch.ones(n_src_tiles, dtype=torch.bool, device=src.device)

    def match(t_mat):
        moved = transform_points(t_mat, src_sorted, prec)
        reps = (moved.reshape(n_src_tiles, tile, 3) * svf_tiles[:, :, None]).sum(1) \
            / tile_w[:, None]
        pos = torch.searchsorted(keys_t_sorted, _keys_in_frame(reps, all_tiles, mn_t, scale_t))
        blk = torch.clamp(pos // tile - (w_tiles - 1) // 2, 0, max(n_tgt_tiles - w_tiles, 0))
        matched, found = _window_nearest(moved, coords, blk, tile, w_tiles, prec)
        w_raw = found & (svf > 0.5)
        diff = prec.r(moved - matched)
        d2 = torch.where(w_raw, (diff * diff).sum(1), torch.inf)
        stride = max(d2.shape[0] // 65536, 1)
        gate = torch.maximum(16.0 * _percentile(d2[::stride], 50.0), noise_floor)
        return moved, matched, w_raw & (d2 <= gate), d2

    return match


def icp(src, src_mask, tgt, tgt_mask, init, max_iterations, conv_thresh, w_tiles=3,
        subsample=1, full_iters=2, prec=FP32):
    """Window-path point-to-point ICP (``_icp_p2p`` with ``_icp_loop``):
    ``(pose (4, 4) on the host, mse, iterations)``; with ``subsample``
    > 1 a coarse phase on every subsample-th source tile comes first."""
    t_host = init.to(torch.float32).cpu()
    full = _static_matcher(src, src_mask, tgt, tgt_mask, t_host.to(src.device), w_tiles, prec)
    coarse = (_static_matcher(src, src_mask, tgt, tgt_mask, t_host.to(src.device), w_tiles,
                              prec, tile_stride=subsample) if subsample > 1 else None)
    thresh = torch.tensor(conv_thresh, dtype=torch.float32)

    def run(t_mat, it, match, budget):
        mse = torch.tensor(torch.inf)
        conv = False
        while it < budget and not conv:
            moved, matched, ok, d2 = match(t_mat.to(src.device))
            w = ok.to(torch.float32)
            n_ok = w.sum()
            new_mse = torch.where(ok, d2, 0.0).sum() / torch.clamp_min(n_ok, 1.0)
            host = torch.cat([_kabsch_moments(moved, matched, w, prec), new_mse[None]]).cpu()
            t_mat = prec.mm(_kabsch_from_moments(host[:15], prec), t_mat)
            conv = bool(torch.abs(host[15] - mse) < thresh)
            mse = host[15]
            it += 1
        return t_mat, mse, it

    if coarse is not None and max_iterations > full_iters:
        t_host, _, it = run(t_host, 0, coarse, max_iterations - full_iters)
        return run(t_host, it, full, max_iterations)
    return run(t_host, 0, full, max_iterations)


# ---------------------------------------------------------------------------
# Fused-window FPFH: kernels/fpfh.py:78-213 (the plain passes) and
# ops/features.py:118-191 (packing, the two stages, renormalisation)
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))
_THETA_SCALE = float(np.float32(11) / np.float32(2 * np.pi))
_COS_SCALE = 11 / 2.0


def _rsqrt(x):
    x = torch.clamp_min(x, 1e-24)
    return torch.ones_like(x) / torch.sqrt(x)


def _atan2_approx(y, x):
    ax, ay = x.abs(), y.abs()
    z = torch.minimum(ax, ay) / torch.clamp_min(torch.maximum(ax, ay), 1e-30)
    z2 = z * z
    t = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (-0.0851330 + z2 * 0.0208351))))
    t = torch.where(ay > ax, _HALF_PI - t, t)
    t = torch.where(x < 0, _PI - t, t)
    return torch.where(y < 0, -t, t)


def _bins(v, scale):
    return (v * scale).to(torch.int32).clamp(0, 10).long()


def _fpfh_geometry(packed, t0, t1, tile, r2, pos_a, prec):
    ok = _window(packed[3], t0, t1, tile, 0.0) > 0.5
    q = packed[0:3, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    cand = _window(packed[0:3], t0, t1, tile, 0.0)
    d = [prec.r(cand[r][:, None, :] - q[r][:, :, None]) for r in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    sel = ok[:, None, :] & (d2 <= r2) & (d2 > 1e-12)
    if pos_a is not None:
        shift = tile.bit_length() - 1
        tile_c = _window(pos_a[0], t0, t1, tile, 0) >> shift
        tile_q = pos_a[0, t0 * tile:t1 * tile].reshape(-1, tile) >> shift
        dtile = tile_c[:, None, :] - tile_q[:, :, None]
        sel = sel & ((dtile < -1) | (dtile > 1))
    return d, d2, sel


def _pair_hist(packed, t0, t1, tile, d, d2, sel, prec):
    qn = packed[4:7, t0 * tile:t1 * tile].reshape(3, t1 - t0, tile)
    cn = _window(packed[4:7], t0, t1, tile, 0.0)
    q0, q1, q2 = (prec.r(qn[j][:, :, None]) for j in range(3))
    c0, c1, c2 = (prec.r(cn[j][:, None, :]) for j in range(3))
    inv_d = _rsqrt(d2)
    ux, uy, uz = (c * inv_d for c in d)
    a1 = q0 * ux + q1 * uy + q2 * uz
    a2 = c0 * ux + c1 * uy + c2 * uz
    swap = a1.abs() < a2.abs()
    nsx, nsy, nsz = (torch.where(swap, c, q) for c, q in ((c0, q0), (c1, q1), (c2, q2)))
    ntx, nty, ntz = (torch.where(swap, q, c) for c, q in ((c0, q0), (c1, q1), (c2, q2)))
    ux, uy, uz = (torch.where(swap, -u, u) for u in (ux, uy, uz))
    f3 = nsx * ux + nsy * uy + nsz * uz
    vx = uy * nsz - uz * nsy
    vy = uz * nsx - ux * nsz
    vz = ux * nsy - uy * nsx
    inv_v = _rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv_v, vy * inv_v, vz * inv_v
    wx = nsy * vz - nsz * vy
    wy = nsz * vx - nsx * vz
    wz = nsx * vy - nsy * vx
    f2 = vx * ntx + vy * nty + vz * ntz
    f1 = _atan2_approx(wx * ntx + wy * nty + wz * ntz, nsx * ntx + nsy * nty + nsz * ntz)
    wf = sel.to(torch.float32)
    shape = wf.shape[:-1] + (11,)
    hists = [torch.zeros(shape, device=wf.device).scatter_add_(-1, b, wf)
             for b in (_bins(f1 + _PI, _THETA_SCALE), _bins(f2 + 1.0, _COS_SCALE),
                       _bins(f3 + 1.0, _COS_SCALE))]
    return torch.cat(hists + [wf.sum(-1, keepdim=True)], -1)


def _weight_sums(packed, t0, t1, tile, d, d2, sel, prec):
    wgt = torch.where(sel, _rsqrt(d2), 0.0)
    extra = _window(packed[4:37], t0, t1, tile, 0.0)
    acc = prec.mm(wgt, extra.permute(1, 2, 0))
    return torch.cat([acc, sel.sum(2, keepdim=True, dtype=torch.float32)], 2)


def _fpfh_pass(packed, r2, tile, pos_a, body, prec):
    n = packed.shape[1]
    r2 = float(np.float32(r2))
    out = torch.empty((34, n), dtype=torch.float32, device=packed.device)
    for t0 in range(0, n // tile, _CHUNK_TILES):
        t1 = min(t0 + _CHUNK_TILES, n // tile)
        d, d2, sel = _fpfh_geometry(packed, t0, t1, tile, r2, pos_a, prec)
        out[:, t0 * tile:t1 * tile] = body(packed, t0, t1, tile, d, d2, sel, prec).reshape(-1, 34).T
    return out


def fpfh(points, mask, normals, radius, prec=FP32, tile=256):
    """(descriptors (N, 33), valid (N,)) in input order: ``_fpfh_fused``
    with ``band=None`` (every in-radius window candidate)."""
    n = points.shape[0]
    n_pad = _round_up(n, tile)
    pts = torch.zeros((n_pad, 3), dtype=torch.float32, device=points.device)
    pts[:n] = points
    nrm = torch.zeros_like(pts)
    nrm[:n] = normals
    mask_p = torch.zeros(n_pad, dtype=torch.bool, device=points.device)
    mask_p[:n] = mask
    perm_a = _sort_perm(_morton_keys(pts, mask_p, 0))
    pts_a, am = pts[perm_a], mask_p[perm_a]
    packed_a = torch.cat([pts_a.T, am.to(torch.float32)[None], nrm[perm_a].T]).contiguous()
    row_a = _sort_perm(_morton_keys(pts_a, am, 1))
    packed_b = packed_a[:, row_a].contiguous()
    pos_a = row_a.to(torch.int32)[None]
    r2 = float(radius) ** 2
    spfh_a = _fpfh_pass(packed_a, r2, tile, None, _pair_hist, prec)
    spfh_b = _fpfh_pass(packed_b, r2, tile, pos_a, _pair_hist, prec)
    inv_b = _inverse(row_a)
    spfh_raw = spfh_a.T + spfh_b.T[inv_b]
    cnt = spfh_raw[:, 33]
    spfh = spfh_raw[:, :33] / torch.clamp_min(cnt, 1.0)[:, None]
    w_a = _fpfh_pass(torch.cat([packed_a[0:4], spfh.T]).contiguous(), r2, tile, None,
                     _weight_sums, prec)
    w_b = _fpfh_pass(torch.cat([packed_b[0:4], spfh[row_a].T]).contiguous(), r2, tile, pos_a,
                     _weight_sums, prec)
    w_raw = w_a.T + w_b.T[inv_b]
    desc = spfh + w_raw[:, :33] / torch.clamp_min(w_raw[:, 33], 1.0)[:, None]
    blocks = desc.reshape(desc.shape[0], 3, -1)
    desc = (blocks / torch.clamp_min(blocks.sum(2, keepdim=True), 1e-12) * 100.0).reshape(desc.shape)
    valid_s = (packed_a[3] > 0.5) & (cnt >= 3)
    desc = torch.where(valid_s[:, None], desc, 0.0)
    inv_a = _inverse(perm_a)
    return desc[inv_a][:n], valid_s[inv_a][:n] & mask


# The program's FPFH takes its fused path above this many points
# (ops/features.py's FUSED_FPFH_THRESHOLD), and only that path is copied
# here: a cell with smaller scans brings the staged path's copy.
FUSED_FPFH_ABOVE = 262144


# ---------------------------------------------------------------------------
# Matching: ops/features.py:547-574 and ops/neighbors.py:80-135 (the
# expanded d² ‖a‖² + ‖b‖² − 2 a·bᵀ in fp32, the nearest valid row)
def nearest(db, db_valid, queries, prec=FP32, q_chunk=1024, db_tile=262144):
    """(index (Q,), d² (Q,)) of each query's nearest valid database row."""
    bn = (db * db).sum(1)
    idx = torch.empty(queries.shape[0], dtype=torch.long, device=db.device)
    best = torch.empty(queries.shape[0], dtype=torch.float32, device=db.device)
    for c0 in range(0, queries.shape[0], q_chunk):
        q = queries[c0:c0 + q_chunk]
        qn = (q * q).sum(1)
        b_val = torch.full((q.shape[0],), torch.inf, device=db.device)
        b_idx = torch.zeros(q.shape[0], dtype=torch.long, device=db.device)
        for t0 in range(0, db.shape[0], db_tile):
            t1 = min(t0 + db_tile, db.shape[0])
            d2 = torch.clamp_min(qn[:, None] + bn[None, t0:t1] - 2.0 * prec.mm(q, db[t0:t1].T), 0.0)
            d2 = torch.where(db_valid[None, t0:t1], d2, torch.inf)
            v, j = d2.min(1)
            better = v < b_val
            b_val = torch.where(better, v, b_val)
            b_idx = torch.where(better, j + t0, b_idx)
        idx[c0:c0 + q_chunk], best[c0:c0 + q_chunk] = b_idx, b_val
    return idx, best


def match(desc_a, valid_a, desc_b, valid_b, prec=FP32):
    """(j (Na,), distance (Na,), ok (Na,)): the mutual nearest neighbours."""
    j, d2 = nearest(desc_b, valid_b, desc_a, prec)
    dist = torch.sqrt(d2)
    ok = valid_a & torch.isfinite(dist)
    back, _ = nearest(desc_a, valid_a, desc_b, prec)
    ok = ok & (back[j] == torch.arange(desc_a.shape[0], device=desc_a.device))
    return j, torch.where(ok, dist, torch.inf), ok


# ---------------------------------------------------------------------------
# RANSAC: ops/global_registration.py:64-149 and ops/linalg.py:183-202
def _kabsch_batched(source, target, prec):
    mu_s, mu_t = source.mean(-2), target.mean(-2)
    h = prec.mm((source - mu_s[:, None]).transpose(-1, -2), target - mu_t[:, None])
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(_det3(prec.mm(v, ut)))
    diag = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    r = prec.mm(prec.mm(v, diag), ut)
    m = torch.eye(4, dtype=h.dtype, device=h.device).repeat(h.shape[0], 1, 1)
    m[:, :3, :3] = r
    m[:, :3, 3] = mu_t - prec.mm(r, mu_s[..., None])[..., 0]
    return m


def ransac(src_pts, tgt_pts, corr_ok, cfg, prec=FP32):
    """(best pose (4, 4), its inlier count): batches of hypotheses drawn
    with a generator seeded with ``cfg["seed"]`` on the points' device,
    stopping once a batch reaches the inlier-ratio target."""
    n_valid = int(corr_ok.sum())
    gen = torch.Generator(device=src_pts.device)
    gen.manual_seed(int(cfg["seed"]))
    batch = min(cfg["hypothesis_batch"], cfg["ransac_iterations"])
    probs = corr_ok.to(torch.float32)
    probs = probs / torch.clamp_min(probs.sum(), 1.0)
    thresh = torch.tensor(cfg["distance_threshold"], dtype=torch.float32)
    thresh2 = (thresh * thresh).item()
    best_t, best_count = torch.eye(4, device=src_pts.device), -1
    for _ in range(max(1, cfg["ransac_iterations"] // batch)):
        idx = torch.multinomial(probs, batch * 3, replacement=True, generator=gen).reshape(batch, 3)
        fit = _kabsch_batched(src_pts[idx], tgt_pts[idx], prec)
        moved = prec.mm(src_pts, fit[:, :3, :3].transpose(1, 2)) + fit[:, None, :3, 3]
        d = prec.r(moved - tgt_pts[None])
        counts = (((d * d).sum(-1) <= thresh2) & corr_ok[None]).sum(1)
        b = int(torch.argmax(counts))
        if int(counts[b]) > best_count:
            best_count, best_t = int(counts[b]), fit[b]
        if best_count >= cfg["inlier_ratio"] * max(n_valid, 1):
            break
    return best_t, best_count


# ---------------------------------------------------------------------------
# The entries
def perception_step(src, src_mask, tgt, tgt_mask, cfg, prec=FP32):
    """``PerceptionStep.__call__`` (models/perception.py:50-66) at the
    window path's sizes: normals of the target, then ICP of source onto
    target from the identity."""
    nrm, curv, valid = union_normals(tgt, tgt_mask, cfg["k"], prec)
    pose, mse, it = icp(src, src_mask, tgt, tgt_mask, torch.eye(4), cfg["max_iterations"],
                        cfg["conv_thresh"], prec=prec)
    return {"normals": nrm, "curvature": curv, "normals_valid": valid,
            "pose": pose, "mse": float(mse), "iterations": it}


def registration_model(src, src_mask, tgt, tgt_mask, cfg, prec=FP32):
    """``RegistrationModel.__call__`` (models/perception.py:113-117) with
    ``refine_with_icp`` false: normals and FPFH on both clouds, matching
    of the strided source descriptors, RANSAC, then the ICP refinement
    from the RANSAC pose."""
    out = {}
    for side, pts, mask in (("src", src, src_mask), ("tgt", tgt, tgt_mask)):
        nrm, _, nrm_ok = union_normals(pts, mask, cfg["k_normals"], prec)
        if pts.shape[0] <= FUSED_FPFH_ABOVE:
            raise ValueError(f"{pts.shape[0]} points: the program's FPFH is staged below "
                             f"{FUSED_FPFH_ABOVE + 1}, and the reference holds the fused one")
        desc, ok = fpfh(pts, mask, nrm, cfg["fpfh_radius"], prec)
        out[side + "_normals"], out[side + "_normals_valid"] = nrm, nrm_ok
        out[side + "_desc"], out[side + "_desc_valid"] = desc, ok
    src_desc, src_ok, src_pts = out["src_desc"], out["src_desc_valid"], src
    mq = cfg["max_query_descriptors"]
    if mq and src.shape[0] > mq:
        stride = -(-src.shape[0] // mq)
        src_desc, src_ok, src_pts = src_desc[::stride], src_ok[::stride], src[::stride]
    j, dist, ok = match(src_desc, src_ok, out["tgt_desc"], out["tgt_desc_valid"], prec)
    out["match_j"], out["match_ok"] = j, ok
    order = torch.argsort(torch.where(ok, dist, torch.inf), stable=True)[:cfg["max_correspondences"]]
    init, count = ransac(src_pts[order], tgt[j[order]], ok[order], cfg, prec)
    out["ransac_pose"], out["ransac_inliers"] = init.cpu(), count
    n_src = src.shape[0]
    sub = 8 if n_src >= 800_000 else 4 if n_src >= 200_000 else 2 if n_src >= 50_000 else 1
    w_tiles = max(3, min(int(math.ceil(tgt.shape[0] / max(n_src, 1))) + 2, 16))
    pose, mse, it = icp(src, src_mask, tgt, tgt_mask, init, cfg["max_iterations"], 1e-6,
                        w_tiles=w_tiles, subsample=sub, prec=prec)
    out["pose"], out["mse"], out["iterations"] = pose, float(mse), it
    return out
