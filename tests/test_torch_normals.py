"""Normal estimation: the PyTorch port against the JAX package.

Both packages get the same padded cloud (``interop.cloud_from_numpy``
of the JAX cloud's arrays). Stated tolerance: >= 99% of valid normals
within 1° of the JAX normal (sign included), curvature within 1e-3
absolute on >= 99% of points, and the same validity mask.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.ops import normals as jn  # noqa: E402

from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.ops import normals as tn  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _scan(n, seed, scale=1.0):
    from bench import _kitti_like
    return (_kitti_like(n, seed) * np.float32(scale)).astype(np.float32)


def _both(pts, config_kw):
    jc = tc.PointCloud.from_numpy(pts)
    tcl = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")
    jr = jn.estimate_normals_detailed(jc, jn.NormalEstimationConfig(**config_kw))
    tr = tn.estimate_normals_detailed(tcl, tn.NormalEstimationConfig(**config_kw))
    return jr, tr


def _assert_close(jr, tr):
    jv, tv = np.asarray(jr.valid), tr.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    jnrm, tnrm = np.asarray(jr.normals)[jv], tr.normals.numpy()[jv]
    cos = np.clip((jnrm * tnrm).sum(1), -1, 1)
    ang = np.degrees(np.arccos(cos))
    assert np.mean(ang < 1.0) >= 0.99, np.quantile(ang, [0.5, 0.99])
    curv = np.abs(np.asarray(jr.curvature) - tr.curvature.numpy())
    assert np.mean(curv < 1e-3) >= 0.99
    np.testing.assert_allclose(np.linalg.norm(tr.normals.numpy()[jv], axis=1), 1.0,
                               atol=1e-5)
    assert (tr.normals.numpy()[~jv] == 0).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_exact_normals_match_jax(scale):
    """2,048 points: below the threshold, the exact kNN path."""
    jr, tr = _both(_scan(2000, 3, scale), dict(k_neighbors=10))
    _assert_close(jr, tr)


def test_radius_normals_match_jax():
    jr, tr = _both(_scan(2000, 4), dict(k_neighbors=12, radius=1.5))
    _assert_close(jr, tr)


def test_union_normals_match_jax(monkeypatch):
    """8,000 points with the auto threshold lowered in BOTH packages, so
    the two-window union (and its kernels) carries the estimate."""
    monkeypatch.setattr(jn, "AUTO_WINDOW_THRESHOLD", 4096)
    monkeypatch.setattr(tn, "AUTO_WINDOW_THRESHOLD", 4096)
    pts = _scan(8000, 5)
    jr, tr = _both(pts, dict(k_neighbors=10))
    _assert_close(jr, tr)
    with_n = tn.estimate_normals(interop.cloud_from_numpy(
        np.asarray(tc.PointCloud.from_numpy(pts).points),
        np.asarray(tc.PointCloud.from_numpy(pts).mask), device="cpu"), k=10)
    torch.testing.assert_close(with_n.normals, tr.normals)


@pytest.mark.parametrize("bad", [dict(method="fast"), dict(window_passes=0),
                                 dict(window_merge="best"),
                                 dict(method="window", radius=0.5),
                                 dict(method="window_fast", radius=0.5)])
def test_validation_errors_match(bad):
    pts = _scan(256, 6)
    with pytest.raises(ValueError) as je:
        _both(pts, bad)
    jc = tc.PointCloud.from_numpy(pts)
    tcl = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")
    with pytest.raises(ValueError) as te:
        tn.estimate_normals_detailed(tcl, tn.NormalEstimationConfig(**bad))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("cfg", [dict(method="window_fast"),
                                 dict(method="window_fast", window_passes=1,
                                      window_merge="union")])
def test_window_fast_configs_match_jax(cfg):
    """method="window_fast" with pick-tighter over two passes, and with
    the union merge at one pass (the same one-pass kernel path in the JAX
    package), on 2,000 points of a scan."""
    jr, tr = _both(_scan(2000, 11), cfg)
    _assert_close(jr, tr)


def _assert_window_close(jr, tr):
    """method="window": equal valid masks and |cos| >= 0.9999 on >= 99.9%
    of valid normals (the reference's XLA:CPU FMA contraction can swap
    near-tied neighbours), curvature within 1e-3 on >= 99%."""
    jv, tv = np.asarray(jr.valid), tr.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    cos = np.abs((np.asarray(jr.normals)[jv] * tr.normals.numpy()[jv]).sum(1))
    assert np.mean(cos >= 0.9999) >= 0.999, np.quantile(cos, [0.001, 0.5])
    curv = np.abs(np.asarray(jr.curvature) - tr.curvature.numpy())
    assert np.mean(curv < 1e-3) >= 0.99
    np.testing.assert_allclose(np.linalg.norm(tr.normals.numpy()[jv], axis=1), 1.0,
                               atol=1e-5)
    assert (tr.normals.numpy()[~jv] == 0).all()


@pytest.mark.parametrize("scale", [1e-2, 1.0])
def test_window_normals_match_jax(scale):
    """method="window" (two-pass window kNN left in pass-A order, then the
    PCA): 4,000 points of a scan with its padded tail."""
    pts = _scan(4000, 9, scale)
    jr, tr = _both(pts, dict(method="window", k_neighbors=10))
    _assert_window_close(jr, tr)
    assert tr.valid.numpy()[:4000].mean() > 0.99


def test_window_radius_route_matches_jax():
    """The window kNN under a radius (reachable through ``_estimate``
    only: the config refuses radius= with method="window")."""
    import jax.numpy as jnp
    pts = _scan(2000, 10)
    jc = tc.PointCloud.from_numpy(pts)
    tcl = interop.cloud_from_numpy(np.asarray(jc.points), np.asarray(jc.mask), device="cpu")
    vp = np.array([0.0, 0.0, 50.0], np.float32)
    jn_, jcv, jv = jn._estimate(jc.points, jc.mask, 10, True, jnp.float32(1.0),
                                jnp.asarray(vp), True, window=True)
    tn_, tcv, tv = tn._estimate(tcl.points, tcl.mask, 10, True, 1.0, torch.from_numpy(vp),
                                True, window=True)
    _assert_window_close(jn.NormalResult(jn_, jcv, jv), tn.NormalResult(tn_, tcv, tv))


def test_window_fast_union_is_the_union_path():
    """method="window_fast" with window_merge="union" is the union in the
    JAX package too, so it runs here."""
    pts = _scan(2000, 7)
    jr, tr = _both(pts, dict(method="window_fast", window_merge="union"))
    _assert_close(jr, tr)


def test_viewpoint_orientation():
    pts = _scan(1000, 8)
    vp = (0.0, 0.0, 100.0)
    jr, tr = _both(pts, dict(viewpoint=vp))
    _assert_close(jr, tr)
    v = tr.valid.numpy()[:1000]
    n, p = tr.normals.numpy()[:1000][v], pts[v]
    assert ((np.asarray(vp) - p) * n).sum(1).min() >= 0
