"""Distributed screened-Poisson reconstruction over a mesh.

Counterpart of ``threecrate_tpu.parallel.poisson_mg``: the dense-grid
multigrid of ``reconstruction/multigrid.py`` solved over a 1-D mesh.

- the χ grid is split into **x-slabs** (axis 0), one a shard;
- every 7-point stencil application exchanges ONE boundary plane with
  each x-neighbour (two ``ppermute`` sends of (1, R, R) planes; the slab
  interior never moves), the stencil's terms added in the single-device
  operator's order;
- restriction (the 2×2×2 mean) is slab-local: the slabs stay even in
  thickness down to the gather level;
- trilinear prolongation resizes the halo-EXTENDED coarse slab at
  exactly ×2 and crops: at fine offset 2 the half-pixel weights are the
  unsharded ones, and at the mesh ends the halo planes repeat the slab's
  own boundary, where the unsharded resize clamps its coordinate;
- below ``gather_res`` the level is ``all_gather``ed and the rest of the
  V-cycle runs **replicated** through ``multigrid._v_cycle`` (once a
  device here: shards that share a device share the copy).

Given the same right-hand side the sharded solver equals
``multigrid.mg_solve`` bit for bit on the CPU (held by
tests/test_torch_parallel_poisson.py): Jacobi sweeps and stencils are
elementwise, restriction and prolongation fixed (at a mesh end the
halo's weights (1/4, 3/4) over two equal planes give the plane back, as
the clamped (1, 0) do), and the only dot products (the coarsest CG) run
on the gathered arrays, the single-device program. The pipeline differs
from the single-device one in the splat: per-shard partial fields
combined by ``psum`` (in rank order) against one scatter.

Bodies run once for the whole mesh over per-shard lists
(``collectives.shard_map``); the loops are Python loops of device
operations and never sync the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..reconstruction import multigrid as _mg
from .collectives import all_gather, axis_index, ppermute, psum, shard_map
from .mesh import POINTS_AXIS, Mesh, P
from .sharded import _per_copy


# ---------------------------------------------------------------------------
# halo-exchanged stencil building blocks (bodies over the shards)
# ---------------------------------------------------------------------------

def _exchange_x(x, axis_name: str, n_dev: int, *, mesh):
    """Extend each shard's x-slab with one neighbour plane each side. The
    mesh-end shards repeat their own boundary plane: the Neumann
    convention of the single-device stencil's replicate padding."""
    if n_dev == 1:
        return [torch.cat([v[:1], v, v[-1:]]) for v in x]
    me = axis_index(mesh, axis_name)
    lo = ppermute([v[-1:] for v in x], mesh, axis_name, [(d, d + 1) for d in range(n_dev - 1)])
    hi = ppermute([v[:1] for v in x], mesh, axis_name, [(d, d - 1) for d in range(1, n_dev)])
    return [torch.cat([v[:1] if d == 0 else l, v, v[-1:] if d == n_dev - 1 else h])
            for d, v, l, h in zip(me, x, lo, hi)]


def _shift_clip(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """``a`` shifted by ``d`` along ``axis``, the edge repeated."""
    n = a.shape[axis]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return a.index_select(axis, idx)


def _stencil_ext(xe: torch.Tensor) -> torch.Tensor:
    """Unscaled 7-point stencil on a halo-extended slab: the x-neighbours
    come from the halo planes, y and z keep the local replicate clip
    (those axes are whole on every shard). The terms add in
    ``multigrid._laplacian_stencil``'s order, so an interior value is the
    single-device one bit for bit."""
    x = xe[1:-1]
    out = -6.0 * x
    out = out + xe[2:] + xe[:-2]
    for axis in (1, 2):
        out = out + _shift_clip(x, 1, axis) + _shift_clip(x, -1, axis)
    return out


def _apply_a_local(x, screening, axis_name: str, n_dev: int, *, mesh):
    return [s * v - _stencil_ext(e)
            for s, v, e in zip(screening, x, _exchange_x(x, axis_name, n_dev, mesh=mesh))]


def _jacobi_local(x, b, screening, n: int, axis_name: str, n_dev: int,
                  omega: float = 2.0 / 3.0, *, mesh):
    step = _per_copy(lambda s: omega / (s + 6.0), screening)
    for _ in range(n):
        ax = _apply_a_local(x, screening, axis_name, n_dev, mesh=mesh)
        x = [v + st * (bb - a) for v, st, bb, a in zip(x, step, b, ax)]
    return x


def _prolong_local(xc, fine_shape, axis_name: str, n_dev: int, *, mesh):
    """Trilinear prolongation across slab boundaries: resize the
    halo-extended coarse slab at the same exact ×2 scale and crop the
    two halo-derived fine planes each side."""
    out = []
    for xe in _exchange_x(xc, axis_name, n_dev, mesh=mesh):
        fe = F.interpolate(xe[None, None], size=(2 * xe.shape[0], fine_shape[1], fine_shape[2]),
                           mode="trilinear", align_corners=False)[0, 0]
        out.append(fe[2:2 + fine_shape[0]])
    return out


def _v_cycle_local(b, screening, *, res: int, n_dev: int, axis_name: str,
                   nu1: int, nu2: int, gather_res: int, coarsest: int,
                   coarsest_iters: int, mesh):
    """One V(nu1, nu2) cycle on the slabs from a zero guess. Below
    ``gather_res`` (or once a slab can no longer halve) the levels left
    run replicated through ``multigrid._v_cycle`` on the gathered
    array, and each shard keeps its slab of the result."""
    m = b[0].shape[0]
    if res <= gather_res or m < 2 or m % 2:
        ef = _per_copy(lambda full, s: _mg._v_cycle(full, s, nu1=nu1, nu2=nu2,
                                                    coarsest=coarsest,
                                                    coarsest_iters=coarsest_iters),
                       all_gather(b, mesh, axis_name, tiled=True), screening)
        return [e[me * m:(me + 1) * m] for me, e in zip(axis_index(mesh, axis_name), ef)]
    kw = dict(axis_name=axis_name, n_dev=n_dev, mesh=mesh)
    x = _jacobi_local([torch.zeros_like(v) for v in b], b, screening, nu1, **kw)
    r = [bb - a for bb, a in zip(b, _apply_a_local(x, screening, **kw))]
    ec = _v_cycle_local([4.0 * _mg._restrict(v) for v in r],
                        _per_copy(lambda s: 4.0 * s, screening),
                        res=res // 2, n_dev=n_dev, axis_name=axis_name, nu1=nu1, nu2=nu2,
                        gather_res=gather_res, coarsest=coarsest,
                        coarsest_iters=coarsest_iters, mesh=mesh)
    x = [v + e for v, e in zip(x, _prolong_local(ec, b[0].shape, **kw))]
    return _jacobi_local(x, b, screening, nu2, **kw)


def mg_solve_local(b, screening, *, res: int, n_dev: int, axis_name: str,
                   cycles: int = 12, nu1: int = 3, nu2: int = 3,
                   gather_res: int = 32, coarsest: int = 8,
                   coarsest_iters: int = 128, mesh):
    """Sharded analog of ``multigrid.mg_solve``: ``b`` is the per-shard
    list of the right-hand side's x-slabs, ``screening`` a number or a
    per-shard list; returns the solution's slabs. Shards on one device
    share one screening tensor, so the replicated levels run once a
    device."""
    if not isinstance(screening, (list, tuple)):
        screening = [screening] * len(b)
    on_device = {}
    for s, v in zip(screening, b):
        if v.device not in on_device:
            on_device[v.device] = (s.to(v.device, torch.float32) if isinstance(s, torch.Tensor)
                                   else torch.full((), float(s), dtype=torch.float32,
                                                   device=v.device))
    screening = [on_device[v.device] for v in b]
    x = [torch.zeros_like(v) for v in b]
    for _ in range(cycles):
        r = [bb - a for bb, a in zip(b, _apply_a_local(x, screening, axis_name, n_dev,
                                                       mesh=mesh))]
        e = _v_cycle_local(r, screening, res=res, n_dev=n_dev, axis_name=axis_name, nu1=nu1,
                           nu2=nu2, gather_res=gather_res, coarsest=coarsest,
                           coarsest_iters=coarsest_iters, mesh=mesh)
        x = [v + ee for v, ee in zip(x, e)]
    return x


# ---------------------------------------------------------------------------
# public factories
# ---------------------------------------------------------------------------

def make_sharded_mg_solver(mesh: Mesh, res: int, *, cycles: int = 12,
                           gather_res: int = 32,
                           axis_name: str = POINTS_AXIS):
    """Distributed solver for (screening·I − S) x = b on a res³ grid split
    into x-slabs: ``fn(b, screening)``, ``b`` sharded (axis, None, None)
    (or a whole grid, split so), the solution returned sharded the same
    way. Equals ``multigrid.mg_solve(b, screening, cycles)``."""
    n_dev = mesh.shape[axis_name]
    if res % n_dev:
        raise ValueError(f"res={res} not divisible by {n_dev} devices")
    spec = P(axis_name)

    def body(b_local, screening):
        return mg_solve_local([b.to(torch.float32) for b in b_local], list(screening), res=res,
                              n_dev=n_dev, axis_name=axis_name, cycles=cycles,
                              gather_res=gather_res, mesh=mesh)

    return shard_map(body, mesh, (spec, P()), spec)


def make_sharded_poisson_fields(mesh: Mesh, res: int, *,
                                screening: float = 1e-4,
                                cycles: int = 8, gather_res: int = 32,
                                axis_name: str = POINTS_AXIS):
    """Distributed Poisson field solve: ``fn(points, normals, mask,
    origin, spacing)`` with the clouds sharded on the points axis →
    (χ (res³), iso level, splat-support field (res³)), replicated. Each
    shard splats its OWN points into a full-size partial field (the
    single-device splat's flat ``index_add_``) and the partials combine
    by ``psum``; the divergence and the support box-sum run replicated;
    the V-cycle solve, where the work is at depth ≥ 7, runs
    slab-sharded; the iso level is a ``psum`` of the shards' sums of χ
    sampled at their points."""
    from ..reconstruction.poisson import _box3, _corners, _divergence, _voxel

    n_dev = mesh.shape[axis_name]
    if res % n_dev:
        raise ValueError(f"res={res} not divisible by {n_dev} devices")
    slab = res // n_dev
    spec = P(axis_name)

    def body(pts, nrm, msk, origin, spacing):
        vparts, wparts, cells = [], [], []
        for p, n, m, o, s in zip(pts, nrm, msk, origin, spacing):
            p, n, m = p.to(torch.float32), n.to(torch.float32), m.to(torch.bool)
            g = (p - o) / s
            g0 = torch.floor(g).to(torch.int32)
            frac = g - g0
            mf = m.to(torch.float32)
            nz = torch.where(m[:, None], torch.nan_to_num(n), 0.0)
            vfield = torch.zeros((res ** 3, 3), dtype=torch.float32, device=p.device)
            wfield = torch.zeros((res ** 3,), dtype=torch.float32, device=p.device)
            for d, w in _corners(frac):
                w = w * mf
                flat = _voxel(g0, d, res)
                vfield.index_add_(0, flat, nz * w[:, None])
                wfield.index_add_(0, flat, w)
            vparts.append(vfield)
            wparts.append(wfield)
            cells.append((g0, frac, m))
        wsum = psum(wparts, mesh, axis_name)
        rhs = _per_copy(lambda v, w: -_divergence(
            (v / torch.clamp_min(w, 1e-6)[:, None]).reshape(res, res, res, 3)),
            psum(vparts, mesh, axis_name), wsum)
        b_loc = [r[d * slab:(d + 1) * slab] for d, r in zip(axis_index(mesh, axis_name), rhs)]
        x_loc = mg_solve_local(b_loc, screening, res=res, n_dev=n_dev, axis_name=axis_name,
                               cycles=cycles, gather_res=gather_res, mesh=mesh)
        chi = all_gather(x_loc, mesh, axis_name, tiled=True)

        # the iso level: the mean of χ sampled trilinearly at the points
        nums, dens = [], []
        for (g0, frac, m), c in zip(cells, chi):
            flat_chi = c.reshape(-1)
            acc = torch.zeros(g0.shape[0], dtype=torch.float32, device=c.device)
            for d, w in _corners(frac):
                acc = acc + w * flat_chi[_voxel(g0, d, res)]
            nums.append(torch.where(m, acc, 0.0).sum())
            dens.append(m.to(torch.float32).sum())
        iso = [n / torch.clamp_min(d, 1.0)
               for n, d in zip(psum(nums, mesh, axis_name), psum(dens, mesh, axis_name))]
        return chi, iso, _per_copy(lambda w: _box3(w.reshape(res, res, res)), wsum)

    return shard_map(body, mesh, (spec, spec, spec, P(), P()), (P(), P(), P()))


def make_sharded_poisson(mesh: Mesh, config=None,
                         axis_name: str = POINTS_AXIS):
    """Distributed ``poisson_reconstruct``: returns ``run(cloud) ->
    TriangleMesh``. The cloud's capacity must divide by the axis size;
    the solver is always multigrid (the distributed path has no CG tier;
    below ``gather_res`` the whole solve replicates)."""
    from ..core.errors import InvalidDataError
    from ..reconstruction.poisson import PoissonConfig, _mesh_from_fields

    if config is None:
        config = PoissonConfig()
    res = config.resolution
    fields = make_sharded_poisson_fields(
        mesh, res, screening=float(config.screening),
        cycles=config.mg_cycles, axis_name=axis_name)

    def run(cloud):
        if cloud.normals is None:
            raise InvalidDataError("Poisson reconstruction requires normals")
        if int(cloud.size()) < 10:
            raise InvalidDataError(f"Poisson needs >= 10 points, got {int(cloud.size())}")
        mn, mx = cloud.bounding_box()
        span = (mx - mn).max() * config.scale
        origin = (mn + mx) * 0.5 - span / 2
        spacing = span / (res - 1)
        chi, iso, support = fields(cloud.points, cloud.normals, cloud.mask, origin, spacing)
        return _mesh_from_fields(chi, iso, support, origin, spacing, config)

    return run
