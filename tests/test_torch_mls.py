"""Moving least squares: the PyTorch port
(``threecrate_tpu_torch.reconstruction.moving_least_squares``) against
the JAX package on the same clouds, on the CPU.

Input: ``tests/test_reconstruction.py``'s MLS cloud, a 1,000-point
Fibonacci sphere with normal(0, 0.03) noise (numpy seed 0), at radius
scales 1e-3, 1 and 1e3 (the search radius 0.3 scaled alike), as the mm
-scale bug of the dimensionless basis showed only at such scales.
Stated tolerances:
- the projection core fed JAX's own neighbourhoods: projected points
  within 1e-5 of the search radius and fitted normals |cos| >= 0.9999,
  on every point, for each weight kernel, basis order and scale;
- ``mls_smooth`` with the port's own radius search: the same bounds on
  every point for the default Gaussian kernel at every scale, and on
  >= 99.9% of points for the Wendland and constant kernels. The exact
  search's expanded d² differs from XLA's by up to 4.8e-7 (a self pair
  reads ~1.6e-3 radius at mm scale where JAX reads 0), and the cubic
  kernel's fits on about six effective points magnify that: it is held
  on >= 99% of points (measured 99.4%); ``valid`` equal;
- ``_signed_field`` fed the same smoothed cloud: bit-equal;
- ``mls_reconstruct``: face counts within 1%.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import make_sphere_points  # noqa: E402

import threecrate_tpu as jt  # noqa: E402
from threecrate_tpu.ops import neighbors as jn  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402

JM = importlib.import_module("threecrate_tpu.reconstruction.moving_least_squares")
TM = importlib.import_module("threecrate_tpu_torch.reconstruction.moving_least_squares")

torch.set_num_threads(2)   # the suite runs several workers per host

SCALES = (1e-3, 1.0, 1e3)
RADIUS = 0.3
POS_TOL, COS_TOL = 1e-5, 0.9999
# The cubic kernel's weights vanish at the rim, so on this sparse cloud a
# few fits rest on about six effective points and the 6x6 solve magnifies
# the search's d² difference (measured 99.4% of points within the bounds)
CUBIC_SHARE = 0.99


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(0)
    pts = make_sphere_points(1000)
    return (pts + 0.03 * rng.normal(size=pts.shape)).astype(np.float32)


def _errors(p_ref, n_ref, p_got, n_got, radius):
    """(per-point |Δp| / radius, per-point |cos| of the normals)."""
    dp = np.abs(np.asarray(p_got) - np.asarray(p_ref)).max(1) / radius
    cos = np.abs((np.asarray(n_got) * np.asarray(n_ref)).sum(1))
    return dp, cos


@pytest.fixture(scope="module")
def jax_searches(noisy):
    """JAX's radius search of the cloud at each scale, computed once."""
    out = {}
    for scale in SCALES:
        pts = (noisy * scale).astype(np.float32)
        r = float(np.float32(RADIUS * scale))
        mask = np.ones(len(pts), bool)
        res = jn.radius_neighbors(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
                                  jnp.asarray(mask), r, 32)
        out[scale] = (pts, r, mask, res)
    return out


CORE_CASES = ([(scale, kernel, 2) for scale in SCALES
               for kernel in ("GAUSSIAN", "WENDLAND", "CUBIC", "CONSTANT")]
              + [(1.0, kernel, order) for order in (0, 1) for kernel in ("GAUSSIAN", "CUBIC")])


@pytest.mark.parametrize("scale,kernel,order", CORE_CASES)
def test_projection_core_matches_jax(jax_searches, scale, kernel, order):
    """``_mls_project_rows`` on JAX's own radius search: the fit alone."""
    pts, r, mask, res = jax_searches[scale]
    jp, jnrm, jv = JM._mls_project_rows(
        jnp.asarray(pts)[res.indices], res.mask, res.distances, jnp.asarray(pts),
        jnp.asarray(mask), jnp.float32(r), JM.WeightKernel[kernel], order, jnp.float32(1e-6))
    tp, tnrm, tv = TM._mls_project_rows(
        torch.from_numpy(pts)[torch.from_numpy(np.array(res.indices)).long()],
        torch.from_numpy(np.array(res.mask)), torch.from_numpy(np.array(res.distances)),
        torch.from_numpy(pts), torch.from_numpy(mask), r, TM.WeightKernel[kernel], order,
        float(np.float32(1e-6)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    dp, cos = _errors(jp, jnrm, tp, tnrm, r)
    assert dp.max() <= POS_TOL, dp.max()
    assert cos.min() >= COS_TOL, cos.min()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("kernel", ["GAUSSIAN", "WENDLAND", "CUBIC", "CONSTANT"])
def test_mls_smooth_matches_jax(noisy, scale, kernel):
    pts = (noisy * scale).astype(np.float32)
    r = RADIUS * scale
    jcfg = JM.MlsConfig(search_radius=r, kernel=JM.WeightKernel[kernel])
    tcfg = TM.MlsConfig(search_radius=r, kernel=TM.WeightKernel[kernel])
    ja = JM.mls_smooth(jt.PointCloud.from_numpy(pts), jcfg)
    ta = TM.mls_smooth(tt.PointCloud.from_numpy(pts, device="cpu"), tcfg)
    dp, cos = _errors(ja.to_numpy(), ja.attr_to_numpy("normals"), ta.to_numpy(),
                      ta.attr_to_numpy("normals"), r)
    ok = (dp <= POS_TOL) & (cos >= COS_TOL)
    if kernel == "GAUSSIAN":
        assert ok.all(), (dp.max(), cos.min())
    assert ok.mean() >= (CUBIC_SHARE if kernel == "CUBIC" else 0.999), (ok.mean(), dp.max(),
                                                                        cos.min())
    # the radius search's validity (>= 3 neighbours) agrees on every point
    jv = np.linalg.norm(ja.attr_to_numpy("normals"), axis=1) > 0
    tv = np.linalg.norm(ta.attr_to_numpy("normals"), axis=1) > 0
    np.testing.assert_array_equal(tv, jv)


def test_mls_smooth_options_match_jax(noisy):
    """``compute_normals=False`` leaves the cloud without normals; a radius
    too small for 3 neighbours leaves points where they are."""
    j = JM.mls_smooth(jt.PointCloud.from_numpy(noisy), JM.MlsConfig(compute_normals=False))
    t = TM.mls_smooth(tt.PointCloud.from_numpy(noisy, device="cpu"),
                      TM.MlsConfig(compute_normals=False))
    assert t.normals is None and j.normals is None
    dp = np.abs(t.to_numpy() - j.to_numpy()).max(1) / TM.MlsConfig().search_radius
    assert dp.max() <= POS_TOL
    tiny = TM.mls_smooth(tt.PointCloud.from_numpy(noisy, device="cpu"),
                         TM.MlsConfig(search_radius=1e-4))
    np.testing.assert_array_equal(tiny.to_numpy(), noisy)
    assert not tiny.normals.any()
    assert TM.MlsConfig() == TM.MlsConfig(0.1, 32, TM.WeightKernel.GAUSSIAN,
                                          TM.PolynomialBasis.QUADRATIC, 1e-6, True)


def test_signed_field_matches_jax(noisy):
    """``_signed_field`` of one smoothed cloud (JAX's) in both packages."""
    ja = JM.mls_smooth(jt.PointCloud.from_numpy(noisy), JM.MlsConfig(search_radius=RADIUS))
    p, n = ja.to_numpy(), ja.attr_to_numpy("normals")
    gj = JM._signed_field(jt.PointCloud.from_numpy(p, normals=n), 24)
    gt = TM._signed_field(tt.PointCloud.from_numpy(p, normals=n, device="cpu"), 24)
    np.testing.assert_array_equal(gt.values.numpy(), np.asarray(gj.values))
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert float(gt.spacing) == float(gj.spacing)


def test_mls_reconstruct_matches_jax(noisy):
    cfg = dict(search_radius=RADIUS)
    mj = JM.mls_reconstruct(jt.PointCloud.from_numpy(noisy), JM.MlsConfig(**cfg), 24)
    mt = tt.mls_reconstruct(tt.PointCloud.from_numpy(noisy, device="cpu"),
                            tt.MlsConfig(**cfg), 24)
    fj, ft = int(mj.face_count()), int(mt.face_count())
    assert fj > 500 and abs(fj - ft) <= 0.01 * fj, (fj, ft)
    assert mt.device.type == "cpu"
    r = np.linalg.norm(mt.to_numpy()[0], axis=1)
    assert 0.9 < np.median(r) < 1.1
