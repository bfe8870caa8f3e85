"""The port's x-slab Poisson (``parallel.poisson_mg``: the halo-exchanged
multigrid, the sharded field solve and ``make_sharded_poisson``) against
the JAX package's on its 8-device virtual CPU mesh (tests/conftest.py)
and against the port's single-device solver, at tests/test_parallel.py's
sizes. The port runs on ``make_mesh(8, devices=[cpu] * 8)``.

Stated tolerances:
* the sharded multigrid against the port's ``multigrid.mg_solve`` on the
  same right-hand side: bit-equal (the stencils and smoothers are
  elementwise and add in the single-device order); against JAX's sharded
  solver within 1e-3 of max|x| (the single-device solvers' parity,
  tests/test_torch_poisson.py);
* the fields against the port's ``poisson._solve``: χ and the iso level
  within 1e-4 of max|χ| (the splat is a rank-order ``psum`` of per-shard
  partial fields), the support within 1e-4; against JAX's sharded fields
  χ within 1e-3 of max|χ|, the support within 1e-4;
* the sphere: JAX's gates (> 500 faces, median radius within 0.03 of 1)
  and the single-device mesh's face count within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threecrate_tpu.parallel as jp

import threecrate_tpu_torch.parallel as tp
from threecrate_tpu_torch import PointCloud
from threecrate_tpu_torch.core.errors import InvalidDataError
from threecrate_tpu_torch.reconstruction import multigrid as tmg
from threecrate_tpu_torch.reconstruction import poisson as tpo

torch.set_num_threads(2)   # the suite runs several workers per host

CPU = torch.device("cpu")


def tmesh():
    return tp.make_mesh(8, devices=[CPU] * 8)


def smooth_rhs(res, seed=11):
    b = np.random.default_rng(seed).normal(size=(res, res, res)).astype(np.float32)
    bj = jnp.asarray(b)
    for ax in range(3):
        bj = (jnp.roll(bj, 1, ax) + bj + jnp.roll(bj, -1, ax)) / 3.0
    return np.array(bj)


@pytest.mark.parametrize("res, gather_res", [(64, 32), (32, 8)])
def test_mg_solver_matches_single_device_and_jax(res, gather_res):
    """Given the same right-hand side the slab-sharded multigrid equals
    the single-device ``mg_solve``. At (32, 8) three levels run on slabs
    (4, 2 and then 1 plane a shard, where it gathers)."""
    b = smooth_rhs(res)
    fn = tp.make_sharded_mg_solver(tmesh(), res, cycles=4, gather_res=gather_res)
    got = fn(b, np.float32(1e-4))
    assert isinstance(got, tp.Sharded) and got.shards[0].shape == (res // 8, res, res)
    got = got.numpy()
    ref = tmg.mg_solve(torch.from_numpy(b), torch.tensor(1e-4), cycles=4).numpy()
    np.testing.assert_array_equal(got, ref)
    scale = np.abs(ref).max()
    jfn = jp.make_sharded_mg_solver(jp.make_mesh(8), res, cycles=4, gather_res=gather_res)
    jgot = np.asarray(jfn(jnp.asarray(b), jnp.float32(1e-4)))
    assert np.abs(got - jgot).max() <= 1e-3 * scale


def test_replicated_levels_run_once_a_device(monkeypatch):
    """Below gather_res the gathered levels run once for the eight shards
    of one device (three nested V-cycles a cycle at 64³, gather_res 32),
    not once a shard."""
    calls = []
    v_cycle = tmg._v_cycle

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return v_cycle(*args, **kwargs)

    monkeypatch.setattr(tmg, "_v_cycle", counted)
    tp.make_sharded_mg_solver(tmesh(), 64, cycles=2)(smooth_rhs(64), np.float32(1e-4))
    assert calls == [(32, 32, 32), (16, 16, 16), (8, 8, 8)] * 2


def sphere(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_fields_match_single_device_and_jax():
    """χ, iso and support of the distributed pipeline against the port's
    ``_solve`` on the multigrid and against JAX's sharded fields, on
    4,096 points of the unit sphere at 32³ (gather_res 8: the solve runs
    on slabs)."""
    v = sphere(4096, 5)
    msk = np.ones(len(v), bool)
    res = 32
    mn, mx = v.min(0), v.max(0)
    span = np.float32((mx - mn).max() * np.float32(1.1))
    origin = ((mn + mx) * np.float32(0.5) - span / np.float32(2)).astype(np.float32)
    spacing = np.float32(span / np.float32(res - 1))
    fn = tp.make_sharded_poisson_fields(tmesh(), res, cycles=4, gather_res=8)
    chi, iso, sup = fn(v, v, msk, origin, spacing)
    chi, iso, sup = chi.numpy(), float(iso), sup.numpy()
    rc, ri, rs = tpo._solve(torch.from_numpy(v), torch.from_numpy(v), torch.from_numpy(msk),
                            torch.from_numpy(origin), torch.tensor(spacing), res, 0,
                            1e-4, solver="multigrid", mg_cycles=4)
    scale = float(rc.abs().max())
    assert np.abs(chi - rc.numpy()).max() <= 1e-4 * scale
    assert abs(iso - float(ri)) <= 1e-4 * scale
    np.testing.assert_allclose(sup, rs.numpy(), rtol=1e-4, atol=1e-4)
    jfn = jp.make_sharded_poisson_fields(jp.make_mesh(8), res, cycles=4, gather_res=8)
    put = lambda x: jp.put_sharded(jnp.asarray(x), jp.make_mesh(8))   # noqa: E731
    jc, jiso, js = (np.asarray(x) for x in jfn(put(v), put(v), put(msk),
                                               jnp.asarray(origin), jnp.asarray(spacing)))
    assert np.abs(chi - jc).max() <= 1e-3 * scale
    assert abs(iso - float(jiso)) <= 1e-3 * scale
    np.testing.assert_allclose(sup, js, rtol=1e-4, atol=1e-4)


def test_reconstruct_sphere_quality():
    """``make_sharded_poisson`` end to end on 8,192 points of the unit
    sphere at depth 6: the radius comes back and the mesh is the
    single-device one's (its face count within 1%)."""
    v = sphere(8192, 9)
    cloud = PointCloud.from_numpy(v, device="cpu").with_normals(torch.from_numpy(v))
    cfg = tpo.PoissonConfig(depth=6, solver="multigrid", mg_cycles=6)
    tm = tp.make_sharded_poisson(tmesh(), cfg)(cloud)
    verts, faces = tm.to_numpy()
    assert len(faces) > 500
    assert abs(np.median(np.linalg.norm(verts, axis=1)) - 1.0) < 0.03
    ref = tpo.poisson_reconstruct(cloud, cfg)
    assert abs(len(faces) - int(ref.face_count())) <= 0.01 * int(ref.face_count())


def test_refusals_match_jax():
    for pkg, mesh in ((jp, jp.make_mesh(8)), (tp, tmesh())):
        for make in (pkg.make_sharded_mg_solver, pkg.make_sharded_poisson_fields):
            with pytest.raises(ValueError, match="res=36 not divisible by 8 devices"):
                make(mesh, 36)
    run = tp.make_sharded_poisson(tmesh())
    pts = sphere(64, 1)
    with pytest.raises(InvalidDataError, match="requires normals"):
        run(PointCloud.from_numpy(pts, device="cpu"))
    few = PointCloud.from_points(torch.from_numpy(pts), torch.arange(64) < 8)
    with pytest.raises(InvalidDataError, match="Poisson needs >= 10 points, got 8"):
        run(few.with_normals(torch.from_numpy(pts)))
