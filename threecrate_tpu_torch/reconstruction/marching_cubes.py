"""Isosurface extraction from dense scalar grids.

Counterpart of ``threecrate_tpu.reconstruction.marching_cubes``: the
dense ``VolumetricGrid`` (with ``from_point_cloud`` distance fields and
the sphere and cube fixtures), marching tetrahedra (``extract_soup``),
256-case marching cubes over the derived tables of ``mc_tables``
(``extract_soup_cubes``), the band-compacted sweep
(``extract_soup_cubes_banded`` / ``_auto``: one min/max pass flags the
blocks whose value window crosses the level, a stable sort compacts
them, and the cube extractor runs over those windows only), and the two
welds of a soup into an indexed mesh: NumPy's ``np.unique`` on the host,
or a sort-based weld on the soup's device (``_weld_device``).

Every extractor runs on its grid's device, in eager PyTorch with no
kernel of its own; on the CPU each soup equals the JAX package's bit
for bit (the same fp32 operations in the same order; the table lookups
are gathers where JAX selects one-hot).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.mesh import TriangleMesh
from ..core.point_cloud import PointCloud
from . import mc_tables

# ---------------------------------------------------------------------------
# marching tetrahedra tables (derived, not copied)
#
# Tet corners are indexed 0..3; the 6 tet edges are the corner pairs:
_TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int32)
# Case index = bitmask of corners with value >= iso ("inside"). For each
# of the 16 cases, up to 2 triangles as triples of edge ids (-1 padding):
#  - 1 inside corner c: the cut triangle uses the 3 edges at c.
#  - 2 inside corners: quad on the 4 edges separating {a,b} from rest.
#  - 3 inside corners: complement of the 1-corner case, flipped.
_MT_TRIS = -np.ones((16, 2, 3), np.int32)


def _edge_id(a, b):
    for i, (x, y) in enumerate(_TET_EDGES):
        if (a, b) == (x, y) or (b, a) == (x, y):
            return i
    raise AssertionError


def _build_mt_table():
    for case in range(1, 15):
        inside = [c for c in range(4) if case & (1 << c)]
        outside = [c for c in range(4) if c not in inside]
        if len(inside) == 1:
            c = inside[0]
            e = [_edge_id(c, o) for o in outside]
            _MT_TRIS[case, 0] = (e[0], e[1], e[2])
        elif len(inside) == 3:
            c = outside[0]
            e = [_edge_id(c, i) for i in inside]
            _MT_TRIS[case, 0] = (e[0], e[2], e[1])   # flipped vs 1-corner
        else:  # two inside: quad split into two triangles
            a, b = inside
            o0, o1 = outside
            e_ao0, e_ao1 = _edge_id(a, o0), _edge_id(a, o1)
            e_bo0, e_bo1 = _edge_id(b, o0), _edge_id(b, o1)
            _MT_TRIS[case, 0] = (e_ao0, e_ao1, e_bo1)
            _MT_TRIS[case, 1] = (e_ao0, e_bo1, e_bo0)


_build_mt_table()

# 6-tetrahedra decomposition of the unit cube around the main diagonal
# (0, 7). Cube corners are indexed by (dx, dy, dz) bits: dx + 2·dy + 4·dz.
_CUBE_TETS = np.array([
    (0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
    (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7),
], np.int32)
_CORNER_OFFSET = np.array([[d & 1, (d >> 1) & 1, (d >> 2) & 1] for d in range(8)], np.int32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _index_grid(shape, device) -> torch.Tensor:
    """(nx, ny, nz, 3) float32 integer coordinates."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


@dataclasses.dataclass(frozen=True)
class VolumetricGrid:
    """Dense scalar field: ``values`` (nx, ny, nz), ``origin`` (3,) and a
    0-d ``spacing``, all float32 on one device."""

    values: torch.Tensor
    origin: torch.Tensor
    spacing: torch.Tensor

    @property
    def resolution(self):
        return tuple(self.values.shape)

    @classmethod
    def from_function(cls, fn, resolution, origin, spacing, device="cuda") -> "VolumetricGrid":
        """``fn`` evaluated at the (nx, ny, nz, 3) node positions, on
        ``device``: the card unless the caller asks for the CPU."""
        origin = _f32(origin, device)
        spacing = _f32(spacing, device)
        pts = origin + _index_grid(resolution, device) * spacing
        return cls(fn(pts), origin, spacing)

    @classmethod
    def from_point_cloud(cls, cloud: PointCloud, resolution=(64, 64, 64),
                         padding_frac: float = 0.05) -> "VolumetricGrid":
        """Unsigned nearest-point distance field over the cloud's bounding
        box, on the cloud's device (exact kNN, 16,384 queries a chunk).
        Extract at iso ≈ spacing to mesh a shell around the points."""
        from ..ops import neighbors
        mn, mx = cloud.bounding_box()
        ext = mx - mn
        pad = ext.max() * padding_frac
        origin = mn - pad
        span = ext.max() + 2 * pad
        spacing = span / (max(resolution) - 1)
        pts = origin + _index_grid(resolution, cloud.device) * spacing
        res = neighbors.knn(cloud.points, cloud.mask, pts.reshape(-1, 3), None, 1,
                            query_chunk=16384)
        return cls(res.distances[:, 0].reshape(*resolution), origin, spacing)


def create_sphere_volume(resolution: int = 32, radius: float = 1.0,
                         center=(0.0, 0.0, 0.0), device="cuda") -> VolumetricGrid:
    """Signed sphere SDF fixture."""
    span = 2.0 * radius * 1.4
    origin = np.asarray(center, np.float32) - span / 2
    spacing = span / (resolution - 1)
    c = _f32(center, device)

    def fn(p):
        return torch.linalg.vector_norm(p - c, dim=-1) - radius
    return VolumetricGrid.from_function(fn, (resolution,) * 3, origin, spacing, device)


def create_cube_volume(resolution: int = 32, half: float = 1.0,
                       center=(0.0, 0.0, 0.0), device="cuda") -> VolumetricGrid:
    """Signed axis-aligned cube SDF fixture."""
    span = 2.0 * half * 1.5
    origin = np.asarray(center, np.float32) - span / 2
    spacing = span / (resolution - 1)
    c = _f32(center, device)

    def fn(p):
        return ((p - c).abs() - half).amax(-1)
    return VolumetricGrid.from_function(fn, (resolution,) * 3, origin, spacing, device)


class TriangleSoup(NamedTuple):
    vertices: torch.Tensor  # (T*3, 3) corner rows [t0v0, t0v1, t0v2, ...]
    mask: torch.Tensor      # (T,)


def extract_soup(grid: VolumetricGrid, iso_level=0.0) -> TriangleSoup:
    """Marching tetrahedra (six tets a cube) → masked triangle soup, each
    triangle wound with its normal toward the ≥ iso side."""
    v = grid.values
    dev = v.device
    iso = _f32(iso_level, dev)
    nx, ny, nz = v.shape
    cube_vals = torch.stack([v[o[0]:o[0] + nx - 1, o[1]:o[1] + ny - 1, o[2]:o[2] + nz - 1]
                             for o in _CORNER_OFFSET], -1).reshape(-1, 8)
    base = _index_grid((nx - 1, ny - 1, nz - 1), dev).reshape(-1, 3)
    offs = torch.as_tensor(_CORNER_OFFSET, dtype=torch.float32, device=dev)
    tets = torch.as_tensor(_CUBE_TETS, dtype=torch.long, device=dev)
    e0 = torch.as_tensor(_TET_EDGES[:, 0], dtype=torch.long, device=dev)
    e1 = torch.as_tensor(_TET_EDGES[:, 1], dtype=torch.long, device=dev)
    table = torch.as_tensor(_MT_TRIS, dtype=torch.long, device=dev)

    tet_vals = cube_vals[:, tets]                          # (C, 6, 4)
    tet_pos = base[:, None, None, :] + offs[tets]          # (C, 6, 4, 3)
    inside = tet_vals >= iso
    case = (inside[..., 0] * 1 + inside[..., 1] * 2 + inside[..., 2] * 4
            + inside[..., 3] * 8)                          # (C, 6)

    va, vb = tet_vals[..., e0], tet_vals[..., e1]          # (C, 6, 6)
    pa, pb = tet_pos[:, :, e0, :], tet_pos[:, :, e1, :]
    denom = torch.where((vb - va).abs() > 1e-12, vb - va, 1.0)
    t = torch.clamp((iso - va) / denom, 0.0, 1.0)
    epts = pa + t[..., None] * (pb - pa)                   # (C, 6 tet, 6 edge, 3)

    tris_e = table[case]                                   # (C, 6, 2, 3) edge ids
    valid = tris_e[..., 0] >= 0
    safe = torch.clamp_min(tris_e, 0)
    c_dim = epts.shape[0]
    idx = safe.reshape(c_dim, 6, 6, 1).expand(c_dim, 6, 6, 3)
    tri_pts = torch.gather(epts, 2, idx).reshape(c_dim, 6, 2, 3, 3)

    # wind every triangle with its normal from the outside corners'
    # centroid toward the inside corners' (the field's gradient)
    w_in = inside.to(torch.float32)                        # (C, 6, 4)
    n_in = torch.clamp_min(w_in.sum(-1), 1.0)[..., None]
    n_out = torch.clamp_min((1 - w_in).sum(-1), 1.0)[..., None]
    cent_in = (tet_pos * w_in[..., None]).sum(2) / n_in
    cent_out = (tet_pos * (1 - w_in)[..., None]).sum(2) / n_out
    grad_dir = cent_in - cent_out                          # (C, 6, 3)
    nrm = torch.linalg.cross(tri_pts[..., 1, :] - tri_pts[..., 0, :],
                             tri_pts[..., 2, :] - tri_pts[..., 0, :], dim=-1)
    flip = (nrm * grad_dir[:, :, None, :]).sum(-1) < 0     # (C, 6, 2)
    swapped = tri_pts[..., [0, 2, 1], :]
    tri_pts = torch.where(flip[..., None, None], swapped, tri_pts)

    world = torch.addcmul(grid.origin, tri_pts.reshape(-1, 3), grid.spacing)
    return TriangleSoup(world, valid.reshape(-1))


def _cubes_soup(values: torch.Tensor, iso: torch.Tensor, origin: torch.Tensor,
                spacing: torch.Tensor, index_offset: Optional[torch.Tensor] = None):
    """256-case marching cubes over a batch of grids ``values`` (W, nx,
    ny, nz) at one origin and spacing: (vertices (W, C·15, 3), slot mask
    (W, C·5)) with C = (nx−1)(ny−1)(nz−1) cubes in x, y, z order, five
    triangle slots a cube. ``index_offset`` (W, 3) adds each grid's
    integer cube base, so a window's vertices equal the whole grid's bit
    for bit (integer-valued fp32 adds are exact below 2^24)."""
    dev = values.device
    n_w, nx, ny, nz = values.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    c_dim = cx * cy * cz
    cv = [values[:, o[0]:o[0] + cx, o[1]:o[1] + cy, o[2]:o[2] + cz].reshape(n_w, c_dim)
          for o in _CORNER_OFFSET]                                  # 8 x (W, C)
    inside = [c >= iso for c in cv]
    case = inside[0].to(torch.int32)
    for i in range(1, 8):
        case = case | (inside[i].to(torch.int32) << i)

    base = _index_grid((cx, cy, cz), dev).reshape(1, c_dim, 3)
    if index_offset is not None:
        base = base + index_offset[:, None, :]
    base = base.expand(n_w, c_dim, 3)
    bx, by, bz = base[..., 0], base[..., 1], base[..., 2]

    # the crossing on each of the 12 cube edges: (W, 12, C) rows a coordinate
    offs = _CORNER_OFFSET
    edge_pts = torch.empty((3, n_w, 12, c_dim), dtype=torch.float32, device=dev)
    for e, (a, b) in enumerate(mc_tables.EDGE_CORNERS):
        va, vb = cv[a], cv[b]
        denom = torch.where((vb - va).abs() > 1e-12, vb - va, 1.0)
        t = torch.clamp((iso - va) / denom, 0.0, 1.0)
        for r, bb in enumerate((bx, by, bz)):
            edge_pts[r, :, e] = bb + float(offs[a][r]) + t * float(offs[b][r] - offs[a][r])

    # each slot vertex's edge id from the 4-bit packed table words
    packed = torch.as_tensor(mc_tables.TRI_PACKED, dtype=torch.int32, device=dev)
    words = (packed[:, 0][case], packed[:, 1][case])                # 2 x (W, C)

    def edge_id(j):
        return (words[j // 8] >> ((j % 8) * 4)) & 15

    # the winding reference: centroid of the inside corners minus that of
    # the outside ones, Σ (corner · (w/n_in − (1 − w)/n_out)) over the 8
    # corners in XLA's order: the first product fused into the second
    # term's sum, then one fused multiply-add a corner
    w_in = [i.to(torch.float32) for i in inside]
    s_in = w_in[0]
    for w in w_in[1:]:
        s_in = s_in + w
    n_in = torch.clamp_min(s_in, 1.0)
    n_out = torch.clamp_min(8.0 - s_in, 1.0)
    wdiff = [w / n_in - (1.0 - w) / n_out for w in w_in]
    g = []
    for r, bb in enumerate((bx, by, bz)):
        corner = [bb + float(o[r]) for o in offs]
        acc = torch.addcmul(corner[1] * wdiff[1], corner[0], wdiff[0])
        for ci in range(2, 8):
            acc = torch.addcmul(acc, corner[ci], wdiff[ci])
        g.append(acc)

    out = torch.empty((n_w, c_dim, 5, 3, 3), dtype=torch.float32, device=dev)
    valid = []
    for sl in range(5):
        ids = [edge_id(3 * sl + k) for k in range(3)]
        valid.append(ids[0] != 15)
        safe = [torch.where(i == 15, 0, i).long()[:, None, :] for i in ids]
        # p[k][r]: coordinate r of the slot's vertex k, (W, C)
        p = [[torch.gather(edge_pts[r], 1, s)[:, 0] for r in range(3)] for s in safe]
        a = [p[1][r] - p[0][r] for r in range(3)]
        b = [p[2][r] - p[0][r] for r in range(3)]
        nrm = (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
               a[0] * b[1] - a[1] * b[0])
        flip = nrm[0] * g[0] + nrm[1] * g[1] + nrm[2] * g[2] < 0
        for r in range(3):
            out[:, :, sl, 0, r] = p[0][r]
            out[:, :, sl, 1, r] = torch.where(flip, p[2][r], p[1][r])
            out[:, :, sl, 2, r] = torch.where(flip, p[1][r], p[2][r])
    # world = origin + index coordinates · spacing, one fused multiply-add
    # (as XLA forms it)
    world = torch.addcmul(origin, out.reshape(n_w, c_dim * 15, 3), spacing)
    return world, torch.stack(valid, -1).reshape(n_w, c_dim * 5)


def extract_soup_cubes(grid: VolumetricGrid, iso_level=0.0,
                       index_offset=None) -> TriangleSoup:
    """256-case marching cubes over the derived tables (≤ 5 triangles a
    cube, about half the tetrahedra path's), with the same gradient
    winding rule. ``index_offset`` adds an integer cube base to every
    index coordinate (the banded extractor's windows)."""
    v = grid.values
    off = None if index_offset is None else _f32(index_offset, v.device).reshape(1, 3)
    world, mask = _cubes_soup(v[None], _f32(iso_level, v.device), grid.origin,
                              grid.spacing, off)
    return TriangleSoup(world[0], mask[0])


def _pad_to_blocks(values: torch.Tensor, block: int):
    """Edge-pad so the cube grid (dims − 1) is a multiple of ``block``.
    Replicated values make padded cubes flat in the padded axis, so
    padding never emits and never changes a real cube."""
    nx, ny, nz = values.shape
    nb = tuple(-(-(n - 1) // block) for n in (nx, ny, nz))
    px, py, pz = (b * block + 1 - n for b, n in zip(nb, (nx, ny, nz)))
    if px or py or pz:
        values = torch.nn.functional.pad(values[None, None], (0, pz, 0, py, 0, px),
                                         mode="replicate")[0, 0]
    return values, nb


def _windows(vp: torch.Tensor, block: int) -> torch.Tensor:
    """(nbx, nby, nbz, B+1, B+1, B+1) view of the overlapping block windows."""
    s1 = block + 1
    return vp.unfold(0, s1, block).unfold(1, s1, block).unfold(2, s1, block)


def _window_minmax(vp: torch.Tensor, block: int):
    win = _windows(vp, block)
    return win.amin(dim=(3, 4, 5)), win.amax(dim=(3, 4, 5))


def _block_active_count(values: torch.Tensor, iso_level, block: int = 8) -> torch.Tensor:
    """Number of ``block``³-cube blocks whose (B+1)³ value window crosses
    ``iso_level`` (the sizing pass of the banded extractor), as an int32
    tensor on the values' device."""
    vp, _ = _pad_to_blocks(values, block)
    mn, mx = _window_minmax(vp, block)
    iso = _f32(iso_level, values.device)
    return ((mn < iso) & (mx >= iso)).sum().to(torch.int32)


def extract_soup_cubes_banded(grid: VolumetricGrid, iso_level=0.0, block: int = 8,
                              max_blocks: int = 4096) -> TriangleSoup:
    """Band-compacted marching cubes: only the blocks whose value window
    crosses the level are extracted. Per-block min/max flags them, a
    stable sort of the flag compacts their ids to the front (capped at
    ``max_blocks``), and the cube extractor runs over those windows with
    their global cube base. The soup equals the dense sweep's triangles
    bit for bit when the active blocks fit the cap (size the cap with
    :func:`extract_soup_cubes_auto`)."""
    v = grid.values
    dev = v.device
    iso = _f32(iso_level, dev)
    vp, (nbx, nby, nbz) = _pad_to_blocks(v, block)
    mn, mx = _window_minmax(vp, block)
    active = ((mn < iso) & (mx >= iso)).reshape(-1)
    nb = nbx * nby * nbz
    order = torch.sort((~active).to(torch.int32), stable=True).indices
    sel = order[:min(max_blocks, nb)]                       # block ids
    live = active[sel]
    bz, by, bx = sel % nbz, (sel // nbz) % nby, sel // (nby * nbz)
    windows = _windows(vp, block)[bx, by, bz]               # (cap, B+1, B+1, B+1)
    corners = torch.stack([bx, by, bz], 1) * block          # (cap, 3)
    world, mask = _cubes_soup(windows, iso, grid.origin, grid.spacing,
                              corners.to(torch.float32))
    # padded windows hold fake cubes past dims − 1 whose other axes can
    # still emit: mask them exactly
    li = torch.arange(block, device=dev)
    lx, ly, lz = torch.meshgrid(li, li, li, indexing="ij")
    nx, ny, nz = v.shape
    okc = ((corners[:, None, 0] + lx.reshape(1, -1) < nx - 1)
           & (corners[:, None, 1] + ly.reshape(1, -1) < ny - 1)
           & (corners[:, None, 2] + lz.reshape(1, -1) < nz - 1))   # (cap, B³)
    mask = mask.reshape(-1, block ** 3, 5) & okc[..., None] & live[:, None, None]
    return TriangleSoup(world.reshape(-1, 3), mask.reshape(-1))


def extract_soup_cubes_auto(grid: VolumetricGrid, iso_level=0.0, block: int = 8,
                            dense_fraction: float = 0.5) -> TriangleSoup:
    """Banded extraction with its cap sized on the host: one counting pass
    (one sync) picks the power-of-two block cap, and fields where more
    than ``dense_fraction`` of the blocks cross fall back to the dense
    sweep (the same triangles either way)."""
    n_act = int(_block_active_count(grid.values, iso_level, block=block))
    nb = 1
    for n in grid.values.shape:
        nb *= -(-(n - 1) // block)
    if n_act > dense_fraction * nb:
        return extract_soup_cubes(grid, iso_level)
    cap = 256
    while cap < n_act:
        cap *= 2
    return extract_soup_cubes_banded(grid, iso_level, block=block, max_blocks=min(cap, nb))


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` (most significant first),
    ties in row order: successive stable sorts, least significant key
    first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order


def _weld_device(vertices: torch.Tensor, mask: torch.Tensor, weld_decimals: int = 5):
    """Sort-based weld on the soup's device, with the host weld's
    semantics (the vertices are the rounded coordinates): keys are
    round(v·10^d) as int32, grouped by a lexicographic sort on (invalid
    flag, kx, ky, kz); unique vertices and valid faces are compacted to
    the front. Returns (uniq (3F, 3) f32, n_unique, faces (F, 3) int32,
    n_faces), the counts as int32 tensors: no host sync."""
    t3 = vertices.shape[0]
    dev = vertices.device
    scalef = _f32(10.0 ** weld_decimals, dev)
    k = torch.round(vertices * scalef).to(torch.int32)       # (3F, 3)
    maj = (~mask).to(torch.int32).repeat_interleave(3)
    order = _stable_order(maj, k[:, 0], k[:, 1], k[:, 2])
    maj_s, kx, ky, kz = maj[order], k[order, 0], k[order, 1], k[order, 2]
    first = torch.ones(t3, dtype=torch.bool, device=dev)
    first[1:] = ((kx[1:] != kx[:-1]) | (ky[1:] != ky[:-1]) | (kz[1:] != kz[:-1])
                 | (maj_s[1:] != maj_s[:-1]))
    gid = (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int32)
    inv = torch.empty(t3, dtype=torch.int32, device=dev)
    inv[order] = gid                                         # back to row order
    faces = inv.reshape(-1, 3)
    fok = mask & (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    head = first & (maj_s == 0)
    n_unique = head.sum().to(torch.int32)
    # group heads to the front, in group order (stable), so row g of the
    # table holds group g's rounded coordinates: key · (1 / 10^d), the
    # product XLA makes of the division
    hsel = torch.sort((~head).to(torch.int32), stable=True).indices
    uniq = torch.stack([kx[hsel], ky[hsel], kz[hsel]], 1).to(torch.float32) \
        * torch.reciprocal(scalef)
    fsel = torch.sort((~fok).to(torch.int32), stable=True).indices
    return uniq, n_unique, faces[fsel], fok.sum().to(torch.int32)


def soup_to_mesh(soup: TriangleSoup, weld_decimals: int = 5,
                 method: str = "auto") -> TriangleMesh:
    """Weld a triangle soup into an indexed mesh on the soup's device.

    ``method``: "host" = NumPy ``np.unique`` on the rounded rows (the soup
    comes to the host, the mesh goes back); "device" = the sort-based
    weld on the soup's device (two counts come back); "auto" = the
    device weld from 750k rows on the card and from 6M rows on the CPU,
    when the coordinates fit the int32 key range (one scalar read).
    Degenerate faces are dropped either way."""
    if method not in ("auto", "host", "device"):
        raise ValueError(f"unknown weld method {method!r}")
    dev = soup.vertices.device
    use_device = method == "device"
    bar = 6_000_000 if dev.type == "cpu" else 750_000
    if method == "auto" and soup.vertices.shape[0] >= bar:
        # key range check: |coord|·10^d must fit int32
        lim = 2.0e9 / (10.0 ** weld_decimals)
        mx = float(torch.where(soup.mask.repeat_interleave(3)[:, None],
                               soup.vertices.abs(), 0.0).max())
        use_device = mx < lim
    if use_device:
        uniq, nu, faces, nf = _weld_device(soup.vertices, soup.mask, weld_decimals)
        nu, nf = torch.stack([nu, nf]).tolist()
        if nf == 0:
            return TriangleMesh.empty(device=dev)
        return TriangleMesh._from_tensors(uniq[:nu], faces[:nf])
    tri = soup.vertices.cpu().numpy().reshape(-1, 3, 3)[soup.mask.cpu().numpy()]
    if len(tri) == 0:
        return TriangleMesh.empty(device=dev)
    keys = np.round(tri.reshape(-1, 3), weld_decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return TriangleMesh.from_numpy(uniq.astype(np.float32), faces[ok], device=dev)


def marching_cubes(grid: VolumetricGrid, iso_level: float = 0.0, method: str = "cubes",
                   weld: str = "auto") -> TriangleMesh:
    """Isosurface mesh of ``grid`` on its device.

    ``method``: "cubes" = 256-case marching cubes (≤ 5 triangles a cube,
    band-compacted by :func:`extract_soup_cubes_auto`); "tetrahedra" =
    the 6-tet decomposition (about twice the triangles). ``weld``: see
    :func:`soup_to_mesh`."""
    if method == "tetrahedra":
        soup = extract_soup(grid, iso_level)
    else:
        soup = extract_soup_cubes_auto(grid, iso_level)
    return soup_to_mesh(soup, method=weld)


def reconstruct_marching_cubes(cloud: PointCloud, resolution: int = 64,
                               iso_offset: float = 1.0) -> TriangleMesh:
    """Cloud → unsigned distance field → shell mesh at ``iso_offset``
    voxels."""
    grid = VolumetricGrid.from_point_cloud(cloud, (resolution,) * 3)
    return marching_cubes(grid, float(grid.spacing) * iso_offset)
