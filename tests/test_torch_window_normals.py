"""The fused window-normals kernel and ``method="window_fast"`` normals:
the PyTorch port against the JAX package.

On the CPU ``window_normals_tiles`` runs its plain PyTorch version; the
Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
Kernel tests give both sides the same sorted arrays; module tests give
both the same padded cloud.

Stated tolerances (the reference's XLA:CPU run contracts its distance
sums into FMAs, which moves the last bit of some distances, and sums
its moments in fp32 where the port sums in float64 and rounds once):
* kernel: count rows equal on >= 99.9% of queries; the k-th row within
  1e-6 relative on >= 99.9%; where the count is >= 3, normals within
  |cos| >= 0.9999 on >= 99.9% and curvature within 1e-4 on >= 99.9%
  (the band body forms its covariance from tile-centred raw moments,
  whose fp32 cancellation sets the reference's error);
* the Jacobi eigensolve on identical covariances: normals within 1e-6
  and curvature within 1e-6 on every row;
* ``window_fast`` normals: the same validity mask, >= 99% of valid
  normals within 1° (sign included) and curvature within 1e-3 on >= 99%
  of points, as tests/test_torch_normals.py holds the other methods.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.kernels import knn_pallas as jk  # noqa: E402
from threecrate_tpu.ops import morton as jmo  # noqa: E402
from threecrate_tpu.ops import normals as jn  # noqa: E402

from threecrate_tpu_torch import interop, kernels  # noqa: E402
from threecrate_tpu_torch.kernels import knn as tk  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host

K, TILE = 10, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan(n, seed, scale=1.0):
    from bench import _kitti_like
    return (_kitti_like(n, seed) * np.float32(scale)).astype(np.float32)


def _both_kernels(pts, valid, k=K, tile=TILE, band=0):
    """(Pallas interpret output, port output) on one set of arrays."""
    pts_t = np.ascontiguousarray(np.asarray(pts, np.float32).T)
    v = np.asarray(valid, np.float32)[None]
    ref = np.asarray(jk.window_normals_tiles(jnp.asarray(pts_t), jnp.asarray(v), k, tile,
                                             interpret=True, band=band))
    got = tk.window_normals_tiles(_t(pts_t), _t(v), k, tile, band).numpy()
    return ref, got


def _assert_kernel_close(ref, got, valid):
    v = np.asarray(valid, bool)
    assert np.mean(got[4][v] == ref[4][v]) >= 0.999
    fin = v & np.isfinite(ref[5])
    rel = np.abs(got[5][fin] - ref[5][fin]) / np.maximum(np.abs(ref[5][fin]), 1e-30)
    assert np.mean(rel <= 1e-6) >= 0.999
    s = v & (ref[4] >= 3)
    cos = np.abs((got[:3, s] * ref[:3, s]).sum(0))
    assert np.mean(cos >= 0.9999) >= 0.999, np.quantile(cos, [0.001, 0.5])
    assert np.mean(np.abs(got[3, s] - ref[3, s]) <= 1e-4) >= 0.999
    assert np.isfinite(got).sum() >= np.isfinite(ref).sum()


@pytest.mark.parametrize("scale", [1e-2, 1.0])
@pytest.mark.parametrize("band", [0, 16])
def test_kernel_matches_pallas_on_a_scan(scale, band):
    """A 4,096-point scan crop, Morton-sorted once, with an invalid tail."""
    n = 4096
    pts = _scan(n, 21, scale)
    valid = np.ones(n, bool)
    valid[-60:] = False
    keys = np.asarray(jmo.morton_keys(jnp.asarray(pts), jnp.asarray(valid), 0))
    order = np.argsort(keys, kind="stable")
    ref, got = _both_kernels(pts[order], valid[order], band=band)
    assert got.shape == ref.shape == (6, n)
    _assert_kernel_close(ref, got, valid[order])
    if band:
        assert (got[4][valid[order]] >= K).all()        # the bound holds >= k
    else:
        np.testing.assert_array_equal(got[4][valid[order]], K)


@pytest.mark.parametrize("band", [0, 8])
def test_planar_tile(band):
    """tests/test_kernels.py's planar tile: every normal along z."""
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 1, (128, 3)).astype(np.float32)
    pts[:, 2] *= 1e-4
    ref, got = _both_kernels(pts, np.ones(128), k=8, band=band)
    assert np.abs(got[2]).min() > 0.99
    np.testing.assert_array_equal(got[4], ref[4])
    _assert_kernel_close(ref, got, np.ones(128, bool))


def test_duplicate_points_no_nan():
    """All points identical: a zero covariance, finite rows equal to the
    reference's."""
    ref, got = _both_kernels(np.zeros((128, 3)), np.ones(128), k=8)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_invalid_rows_zero_count():
    """Invalid candidates are never selected; invalid queries still
    compute (the caller masks them) and count only valid candidates."""
    pts = np.random.default_rng(0).normal(0, 1, (256, 3)).astype(np.float32)
    valid = np.ones(256)
    valid[200:] = 0
    ref, got = _both_kernels(pts, valid, k=6)
    assert (got[4][:200] == 6).all() and (got[4] <= 6).all()
    assert np.isfinite(got[:4]).all()
    np.testing.assert_array_equal(got[4], ref[4])
    _assert_kernel_close(ref, got, valid > 0.5)


@pytest.mark.parametrize("band", [0, 8])
def test_fewer_valid_than_k(band):
    """Two valid points of 256: both queries see exactly those two (the
    band bound clamps to the largest finite fp32, the exact k-th row is
    -inf)."""
    pts = np.zeros((256, 3), np.float32)
    pts[1] = [0.1, 0, 0]
    pts[2:] = 1e6
    valid = np.zeros(256)
    valid[:2] = 1
    ref, got = _both_kernels(pts, valid, k=5, band=band)
    np.testing.assert_array_equal(got[4, :2], [2.0, 2.0])
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[5, :2], ref[5, :2])
    if band:
        assert (got[5, :2] == -np.float32(3.4e38)).all()
    else:
        assert (got[5, :2] == -np.inf).all()


def test_jacobi_matches_pallas_eigensolve():
    """The eigensolve alone on identical covariances: random SPD, rank-2
    (planar), rank-1 (linear), isotropic, zero and mm-scale matrices."""
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (200, 3, 3))
    cov = a @ a.transpose(0, 2, 1)
    b = rng.normal(0, 1, (50, 3, 2))
    cov[:50] = b @ b.transpose(0, 2, 1)
    c = rng.normal(0, 1, (30, 3, 1))
    cov[50:80] = c @ c.transpose(0, 2, 1)
    cov[80:90] = np.eye(3)
    cov[90:100] = 0.0
    cov[100:150] *= 1e-6
    cov = cov.astype(np.float32)
    ent = [cov[:, 0, 0], cov[:, 1, 1], cov[:, 2, 2], cov[:, 0, 1], cov[:, 0, 2],
           cov[:, 1, 2]]
    ref = np.stack([np.asarray(x) for x in jk._normal_from_cov_lanes(
        *[jnp.asarray(e) for e in ent])])
    got = torch.stack(tk._jacobi_normal(*[_t(e) for e in ent])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=0), 1.0, atol=1e-6)


def test_wrapper_checks_and_cpu_never_counts():
    kernels.reset_launch_counts()
    x, v = torch.zeros(3, 256), torch.ones(1, 256)
    tk.window_normals_tiles(x, v, K, TILE, 16)
    assert kernels.launch_counts()["window_normals"] == 0
    for bad in (dict(k=65), dict(k=0), dict(tile=96), dict(band=300)):
        kw = {**dict(k=K, tile=TILE, band=0), **bad}
        with pytest.raises(ValueError):
            tk.window_normals_tiles(x, v, **kw)
    with pytest.raises(ValueError):
        tk.window_normals_tiles(torch.zeros(3, 300), torch.ones(1, 300), K, TILE)


def _assert_close(jr, tr):
    jv, tv = np.asarray(jr.valid), tr.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    jnrm, tnrm = np.asarray(jr.normals)[jv], tr.normals.numpy()[jv]
    ang = np.degrees(np.arccos(np.clip((jnrm * tnrm).sum(1), -1, 1)))
    assert np.mean(ang < 1.0) >= 0.99, np.quantile(ang, [0.5, 0.99])
    curv = np.abs(np.asarray(jr.curvature) - tr.curvature.numpy())
    assert np.mean(curv < 1e-3) >= 0.99
    np.testing.assert_allclose(np.linalg.norm(tr.normals.numpy()[jv], axis=1), 1.0,
                               atol=1e-5)
    assert (tr.normals.numpy()[~jv] == 0).all()


@pytest.mark.parametrize("cfg,scale", [(dict(), 1e-2), (dict(), 1.0),
                                       (dict(window_passes=1), 1.0),
                                       (dict(window_passes=1, window_merge="union"), 1.0)])
def test_window_fast_matches_jax(cfg, scale):
    """method="window_fast": pick-tighter over two passes (at two
    scales), one pass, and the union merge with one pass (which the JAX
    package routes to the same one-pass kernel path), on 4,000 points of
    a scan."""
    pts = _scan(4000, 22, scale)
    jc = tc.PointCloud.from_numpy(pts)
    pc = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")
    kw = dict(method="window_fast", k_neighbors=K, **cfg)
    jr = jn.estimate_normals_detailed(jc, jn.NormalEstimationConfig(**kw))
    tr = tn.estimate_normals_detailed(pc, tn.NormalEstimationConfig(**kw))
    _assert_close(jr, tr)
    assert tr.valid.numpy()[:4000].mean() > 0.99
