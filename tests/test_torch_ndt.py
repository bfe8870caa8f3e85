"""NDT: the PyTorch port (``threecrate_tpu_torch.ops.ndt``) against the
JAX package on the same clouds.

The clouds are the JAX package's NDT fixtures
(``tests/test_registration.py``: ``TestNdt``, ``TestNdtSubsample`` at
strides 1 and 4, and ``TestNdtScaleInvariance``'s mm-scale pair).
Stated tolerances:
- ``build_gaussians``: ``valid`` and ``n_cells`` equal; on valid cells
  the means within 1e-5 relative and the inverse covariances within
  1e-4 of each matrix's largest entry;
- ``ndt_registration``: the transform within 1e-4 (at mm scale within
  1e-4 of the scale, i.e. 1e-7), the same iteration count and
  convergence flag, the score within 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from threecrate_tpu import PointCloud  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JaxInvalidDataError  # noqa: E402
from threecrate_tpu.ops import ndt as jn  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core.errors import InvalidDataError  # noqa: E402
from threecrate_tpu_torch.ops import ndt as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

SHIFT = np.array([0.08, -0.05, 0.02], np.float32)


def _surface(n, seed):
    """``surface_cloud`` of the JAX tests: a wavy ±2 m surface."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = 0.4 * np.sin(xy[:, 0] * 2.0) + 0.3 * np.cos(xy[:, 1] * 1.7)
    return np.stack([xy[:, 0], xy[:, 1], z], -1).astype(np.float32)


def _box(n, scale, seed=0):
    """``box_cloud`` of the JAX tests."""
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


def _port(c):
    return interop.cloud_from_numpy(np.asarray(c.points), np.asarray(c.mask), device="cpu")


# name: (source points, shift, scale, config)
CASES = {
    "ndt": (lambda: _surface(2000, 2) * 2.0, 1.0,
            dict(resolution=1.0, max_iterations=40, step_size=0.2)),
    "subsample1": (lambda: _surface(4000, 5) * 2.0, 1.0,
                   dict(resolution=1.0, max_iterations=40, step_size=0.2, subsample=1)),
    "subsample4": (lambda: _surface(4000, 5) * 2.0, 1.0,
                   dict(resolution=1.0, max_iterations=40, step_size=0.2, subsample=4)),
    "mm": (lambda: _surface(2000, 2) * 2.0 * 1e-3, 1e-3,
           dict(resolution=1e-3, max_iterations=40, step_size=0.2e-3)),
}


@pytest.mark.parametrize("case", [("box", 2000, 4.0, 2.0), ("surface", 4000, 2.0, 1.0),
                                  ("surface_mm", 2000, 2e-3, 1e-3)])
def test_build_gaussians_matches_jax(case):
    """``TestNdt.test_gaussians_built``'s box (2 m cells) and the surfaces
    at unit and mm scale."""
    kind, n, scale, cell = case
    pts = _box(n, scale) if kind == "box" else _surface(n, 5) * scale
    jc = PointCloud.from_numpy(pts)
    tc = _port(jc)
    gj = jn.build_gaussians(jc.points, jc.mask, jnp.float32(cell), 5)
    gt = tn.build_gaussians(tc.points, tc.mask, cell, 5)
    valid = np.asarray(gj.valid)
    np.testing.assert_array_equal(gt.valid.numpy(), valid)
    assert int(gt.grid.n_cells) == int(gj.grid.n_cells)
    assert valid.sum() > 4
    np.testing.assert_allclose(gt.means.numpy()[valid], np.asarray(gj.means)[valid],
                               rtol=1e-5, atol=0)
    ij, it = np.asarray(gj.inv_covs)[valid], gt.inv_covs.numpy()[valid]
    big = np.abs(ij).reshape(len(ij), -1).max(1)
    assert (np.abs(it - ij).reshape(len(ij), -1).max(1) <= 1e-4 * big).all()


@pytest.mark.parametrize("name", list(CASES))
def test_ndt_registration_matches_jax(name):
    make, scale, cfg = CASES[name]
    pts = make()
    js, jt = PointCloud.from_numpy(pts), PointCloud.from_numpy(pts + SHIFT * scale)
    jres = jn.ndt_registration(js, jt, jn.NdtConfig(**cfg))
    tres = tn.ndt_registration(_port(js), _port(jt), tn.NdtConfig(**cfg))
    np.testing.assert_allclose(tres.transformation.numpy(),
                               np.asarray(jres.transformation), atol=1e-4 * scale)
    np.testing.assert_allclose(tres.transformation.numpy()[:3, 3], SHIFT * scale,
                               atol=0.04 * scale)
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(float(tres.score), float(jres.score), rtol=1e-4)
    assert tres.as_transform().matrix is tres.transformation


def test_ndt_empty_cloud_raises_as_jax():
    empty_j = PointCloud(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), bool))
    empty_t = interop.cloud_from_numpy(np.zeros((0, 3), np.float32), np.zeros(0, bool),
                                       device="cpu")
    with pytest.raises(JaxInvalidDataError) as je:
        jn.ndt_registration(empty_j, empty_j)
    with pytest.raises(InvalidDataError) as te:
        tn.ndt_registration(empty_t, empty_t)
    assert str(te.value) == str(je.value)


def test_ndt_defaults_match_jax():
    assert set(tn.NdtConfig.__dataclass_fields__) == set(jn.NdtConfig.__dataclass_fields__)
    for f in tn.NdtConfig.__dataclass_fields__:
        assert getattr(tn.NdtConfig(), f) == getattr(jn.NdtConfig(), f)
    assert tn.NdtResult._fields == jn.NdtResult._fields


def test_ndt_config_from_carries_every_field():
    cfg = jn.NdtConfig(resolution=2.0, step_size=0.3, max_iterations=9, epsilon=1e-3,
                       min_points_per_voxel=7, subsample=3, full_iters=4)
    got = interop.ndt_config_from(cfg)
    assert isinstance(got, tn.NdtConfig)
    for f in jn.NdtConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(cfg, f), f
