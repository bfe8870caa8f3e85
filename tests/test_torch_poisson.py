"""Screened Poisson and its multigrid solver: the PyTorch port
(``threecrate_tpu_torch.reconstruction.poisson`` / ``.multigrid``)
against the JAX package on the same inputs, on the CPU.

Inputs: normal(0, 1) grids from a numpy seed at 16³ and 32³ (the
multigrid pieces and ``mg_solve``), and ``tests/test_reconstruction.py``'s
2,000-point unit sphere with its radial normals at depth 5 and 6.
Stated tolerances (sums run in another order in torch, so the fields
are not bit-equal):
- the stencil, Jacobi sweeps, restriction and prolongation within 1e-6
  (measured 0, 9e-8, 1.8e-7 and 4.8e-7); the coarsest-level CG within
  1e-3 of max|x| (6.8e-5);
- ``mg_solve``: relative residual below 1e-4 at 16³, 32³ and 64³ (JAX's
  own bound), the solution within 1e-3 of max|x| of JAX's (1.2e-4);
- ``_solve`` on both solvers: χ within 1e-4 of max|χ| (1.2e-5), the iso
  level within 1e-4 of max|χ| (5.6e-6), the support field bit-equal (the
  splat's flat ``index_add_`` adds in XLA's order on the CPU);
- ``poisson_reconstruct``: vertex and face counts within 1%, every vertex
  within 0.01 voxel of the other mesh (measured equal counts, 2.9e-4
  voxel).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import make_sphere_points  # noqa: E402

import threecrate_tpu as jt  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JaxInvalidDataError  # noqa: E402
from threecrate_tpu.reconstruction import multigrid as jmg  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.reconstruction import multigrid as tmg  # noqa: E402

JP = importlib.import_module("threecrate_tpu.reconstruction.poisson")
TP = importlib.import_module("threecrate_tpu_torch.reconstruction.poisson")

torch.set_num_threads(2)   # the suite runs several workers per host
SCREEN = 1e-4


def _field(res, seed=0):
    return np.random.default_rng(seed).normal(size=(res,) * 3).astype(np.float32)


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("res", [16, 32])
def test_multigrid_pieces_match_jax(res):
    b = _field(res)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    _close(tmg._laplacian_stencil(tb), jmg._laplacian_stencil(jb), 1e-6)
    _close(tmg._apply_a(tb, torch.tensor(SCREEN)), jmg._apply_a(jb, jnp.float32(SCREEN)), 1e-6)
    _close(tmg._jacobi(torch.zeros_like(tb), tb, torch.tensor(SCREEN), 3),
           jmg._jacobi(jnp.zeros_like(jb), jb, jnp.float32(SCREEN), 3), 1e-6)
    _close(tmg._restrict(tb), jmg._restrict(jb), 1e-6)
    h = res // 2
    _close(tmg._prolong(tb[:h, :h, :h], (res,) * 3), jmg._prolong(jb[:h, :h, :h], (res,) * 3),
           1e-6)
    assert tmg._restrict(tb).shape == (h,) * 3


def test_coarsest_cg_matches_jax():
    b = _field(8, seed=3)
    ref = np.asarray(jmg._coarsest_cg(jnp.asarray(b), jnp.float32(SCREEN), 128))
    got = tmg._coarsest_cg(torch.from_numpy(b), torch.tensor(SCREEN), 128).numpy()
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("res", [16, 32, 64])
def test_mg_solve_residual_and_jax(res):
    """JAX's TestMultigrid bound on the port, and at 16³ and 32³ the
    solution against JAX's."""
    b = _field(res)
    x = tmg.mg_solve(torch.from_numpy(b), SCREEN, cycles=8)
    rel = tmg.mg_residual_norm(torch.from_numpy(b), x, SCREEN)
    assert rel.shape == () and rel.item() < 1e-4, (res, rel.item())
    if res <= 32:
        jx = np.asarray(jmg.mg_solve(jnp.asarray(b), SCREEN, cycles=8))
        assert np.abs(x.numpy() - jx).max() <= 1e-3 * np.abs(jx).max()
        assert abs(rel.item() - float(jmg.mg_residual_norm(jnp.asarray(b), jnp.asarray(jx),
                                                           SCREEN))) < 1e-4


@pytest.fixture(scope="module")
def sphere():
    pts = make_sphere_points(2000)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    return (jt.PointCloud.from_numpy(pts, normals=nrm),
            tt.PointCloud.from_numpy(pts, normals=nrm, device="cpu"))


def test_config_defaults_equal_jax():
    assert TP.PoissonConfig() == TP.PoissonConfig(**vars(JP.PoissonConfig()))
    for depth in (3, 6, 7, 9):
        assert TP.PoissonConfig(depth=depth).resolution == JP.PoissonConfig(depth=depth).resolution


@pytest.mark.parametrize("solver", ["cg", "multigrid"])
@pytest.mark.parametrize("depth", [5, 6])
def test_solve_fields_match_jax(sphere, depth, solver):
    jpc, tpc = sphere
    res = 1 << depth
    mn, mx = jpc.bounding_box()
    span = jnp.max(mx - mn) * 1.1
    origin = (mn + mx) * 0.5 - span / 2
    spacing = span / (res - 1)
    jchi, jiso, jsup = JP._solve(jpc.points, jpc.normals, jpc.mask, origin, spacing, res, 200,
                                 jnp.float32(SCREEN), solver=solver, mg_cycles=8)
    tchi, tiso, tsup = TP._solve(tpc.points, tpc.normals, tpc.mask,
                                 torch.from_numpy(np.array(origin)),
                                 torch.tensor(np.array(spacing)), res, 200, SCREEN,
                                 solver=solver, mg_cycles=8)
    jchi = np.asarray(jchi)
    scale = np.abs(jchi).max()
    assert np.abs(tchi.numpy() - jchi).max() <= 1e-4 * scale
    assert abs(tiso.item() - float(jiso)) <= 1e-4 * scale
    np.testing.assert_array_equal(tsup.numpy(), np.asarray(jsup))


def _nearest(a, b, chunk=2048):
    bt = torch.from_numpy(b).double()
    return torch.cat([torch.cdist(torch.from_numpy(a[i:i + chunk]).double(), bt).min(1).values
                      for i in range(0, len(a), chunk)]).numpy()


def _meshes_agree(jm, tm, voxel):
    jv, jf = jm.to_numpy()
    tv, tf = tm.to_numpy()
    assert abs(len(tv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert _nearest(tv, jv).max() <= 0.01 * voxel
    assert _nearest(jv, tv).max() <= 0.01 * voxel
    return tv, tf


@pytest.mark.parametrize("depth,trim", [(5, True), (5, False), (6, True)])
def test_poisson_reconstruct_matches_jax(sphere, depth, trim):
    jpc, tpc = sphere
    jm = JP.poisson_reconstruct(jpc, JP.PoissonConfig(depth=depth, density_trim=trim))
    tm = TP.poisson_reconstruct(tpc, TP.PoissonConfig(depth=depth, density_trim=trim))
    tv, tf = _meshes_agree(jm, tm, 2.2 / ((1 << depth) - 1))
    r = np.linalg.norm(tv, axis=1)
    assert len(tf) > 1000 and abs(np.median(r) - 1.0) < 0.05 and r.std() < 0.05
    assert tm.vertices.device.type == "cpu"


def test_poisson_multigrid_config_matches_jax(sphere):
    jpc, tpc = sphere
    jm = JP.poisson_reconstruct(jpc, JP.PoissonConfig(depth=5, solver="multigrid"))
    tm = TP.poisson_reconstruct(tpc, TP.PoissonConfig(depth=5, solver="multigrid"))
    _meshes_agree(jm, tm, 2.2 / 31)


@pytest.mark.parametrize("case", ["no_normals", "too_few", "bad_solver"])
def test_poisson_validation_errors_match_jax(case):
    pts = make_sphere_points(100 if case != "too_few" else 5)
    kw = {} if case == "no_normals" else {"normals": pts}
    cfg = {"solver": "fft"} if case == "bad_solver" else {}
    with pytest.raises(JaxInvalidDataError) as jerr:
        JP.poisson_reconstruct(jt.PointCloud.from_numpy(pts, **kw), JP.PoissonConfig(**cfg))
    with pytest.raises(tt.InvalidDataError) as terr:
        TP.poisson_reconstruct(tt.PointCloud.from_numpy(pts, device="cpu", **kw),
                               TP.PoissonConfig(**cfg))
    assert str(terr.value) == str(jerr.value)
